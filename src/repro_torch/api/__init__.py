"""repro_torch.api — the declarative front door over every execution path.

One composable, JSON-round-trippable ``SystemSpec`` describes a complete
experiment; ``build()`` assembles the right executor (solo ``Simulator``,
``FleetSimulator``, or the live ``LiveFleet`` of ``MultiTenantEngine``s)
and every executor returns the same ``RunReport``. ``python -m
repro_torch`` exposes the same surface as a CLI (simulate / serve / trace
/ report / sweep / calibrate / check / specs). The port's counterpart of
``repro.api``; its hardware names are the H100's (``repro_torch.api.spec``).
"""

from repro_torch.api.build import (  # noqa: F401
    FleetRun,
    LiveRun,
    SimRun,
    build_cost_model,
    build_mix,
    build_partition,
    build_schedule,
    build_trace,
    resolve_rate_hz,
    single_shape_mix,
)
from repro_torch.api.report import RunReport  # noqa: F401
from repro_torch.api.spec import (  # noqa: F401
    AUTOSCALERS,
    COST_KINDS,
    MIXES,
    MODES,
    PARTITION_POLICIES,
    PROCESSES,
    AutoscaleSpec,
    CostModelSpec,
    FleetSpec,
    ObservabilitySpec,
    PartitionSpec,
    RouterSpec,
    SchedulerSpec,
    SystemSpec,
    WorkloadSpec,
)
from repro_torch.sim.metrics import SCHEMA_VERSION  # noqa: F401

"""repro_torch.sim — trace-driven workload simulation with calibrated cost models.

The evaluation layer the paper's policy claims are checked on: seeded
arrival-process generators (``traces``) drive the REAL scheduling core on
a virtual clock (``simulator``), with dispatches priced by an analytical
roofline prior or an online-calibrated measured-cost table (``costmodel``)
and outcomes reduced to SLO/latency/goodput/isolation metrics with
deterministic JSON export (``metrics``). ``fleet`` + ``router`` scale the
same machinery to N replicas behind a routing policy, with per-replica
compile-cache cold-start accounting; replicas can be heterogeneous (one
``HardwareSpec`` each), elastic (``autoscale`` spins them up cold and
down deterministically), and individually calibrated
(``FleetCalibrator`` tables keyed by replica id). Policy sweeps over
millions of events run in seconds on CPU.
"""

from repro_torch.sim.autoscale import (  # noqa: F401
    Autoscaler,
    BacklogAutoscaler,
    ScaleEvent,
    make_autoscaler,
)
from repro_torch.sim.costmodel import (  # noqa: F401
    HARDWARE_SPECS,
    STRATEGIES,
    CalibratedCostModel,
    ColdStartCostModel,
    FleetCalibrator,
    RooflineCostModel,
    batch_key,
    estimate_capacity_hz,
    resolve_spec,
)
from repro_torch.sim.fleet import (  # noqa: F401
    FleetSimulator,
    fleet_capacity_hz,
    simulate_fleet,
)
from repro_torch.sim.metrics import (  # noqa: F401
    SCHEMA_VERSION,
    FleetMetrics,
    MetricsAccumulator,
    SimMetrics,
    interference_matrix,
    to_bench_json,
)
from repro_torch.sim.router import (  # noqa: F401
    ROUTERS,
    JoinShortestQueueRouter,
    LeastEstimatedCostRouter,
    RoundRobinRouter,
    Router,
    TenantAffinityRouter,
    make_router,
)
from repro_torch.sim.simulator import (  # noqa: F401
    ReplicaPump,
    SimWorkload,
    Simulator,
    simulate,
)
from repro_torch.sim.traces import (  # noqa: F401
    Arrival,
    CsvReplayTrace,
    DiurnalTrace,
    FlashCrowdTrace,
    MarkovModulatedTrace,
    MergedTrace,
    PoissonTrace,
    TenantSpec,
    Trace,
    fleet_sgemm_mix,
    make_trace,
    paper_sgemm_mix,
    prefill_decode_mix,
)

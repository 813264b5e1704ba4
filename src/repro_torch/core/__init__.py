"""The paper's primary contribution, ported: dynamic space-time scheduling
behind one execution core.

Components (the JAX package's ``repro.core``, minus the GEMM super-kernel
path, which comes with its kernels in a later slice):
    workload   -- the generic schedulable item (the common currency)
    clock      -- injectable time sources (wall / deterministic virtual)
    policy     -- pluggable batching windows (fixed / SLO-adaptive / EDF)
    queue      -- bucketed workload arrival queue
    scheduler  -- DynamicSpaceTimeScheduler: admission control, batching
                  window policy, EDF + preemption, SLO tracking, eviction
    tenancy    -- stacked tenant weights and per-tenant views of them
    slo        -- per-tenant latency EWMA + predictability metrics
"""

from repro_torch.core.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    BatchingPolicy,
    DeadlineEDFPolicy,
    FixedWindowPolicy,
    SLOAdaptiveWindowPolicy,
    make_policy,
)
from repro_torch.core.queue import ShapeBucket, WorkQueue  # noqa: F401
from repro_torch.core.scheduler import DynamicSpaceTimeScheduler, SchedulerStats  # noqa: F401
from repro_torch.core.tenancy import stack_params, tenant_bytes, tenant_view  # noqa: F401
from repro_torch.core.workload import Workload, round_pow2  # noqa: F401

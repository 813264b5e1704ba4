"""The paper's primary contribution, ported: dynamic space-time scheduling
behind one execution core.

Components (the JAX package's ``repro.core``, minus the control plane's
``pump``):
    workload    -- the generic schedulable item (the common currency)
    clock       -- injectable time sources (wall / deterministic virtual)
    policy      -- pluggable batching windows (fixed / SLO-adaptive / EDF)
    queue       -- bucketed workload arrival queue, ``GemmProblem``
    superkernel -- inter-model batched super-kernel (K1/K2 launches) + cache
    strategies  -- the four multiplexing strategies under comparison
                   (exclusive / time-only / space-only / space-time)
    scheduler   -- DynamicSpaceTimeScheduler: admission control, batching
                   window policy, EDF + preemption, SLO tracking, eviction
    tenancy     -- stacked tenant weights, per-tenant views, TenantManager
    slo         -- per-tenant latency EWMA + predictability metrics
"""

from repro_torch.core.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.core.policy import (  # noqa: F401
    BatchingPolicy,
    DeadlineEDFPolicy,
    FixedWindowPolicy,
    SLOAdaptiveWindowPolicy,
    make_policy,
)
from repro_torch.core.queue import (  # noqa: F401
    GemmProblem,
    KernelQueue,
    ShapeBucket,
    WorkQueue,
)
from repro_torch.core.scheduler import DynamicSpaceTimeScheduler, SchedulerStats  # noqa: F401
from repro_torch.core.superkernel import CacheStats, SuperKernelCache  # noqa: F401
from repro_torch.core.tenancy import (  # noqa: F401
    TenantManager,
    TenantSlot,
    stack_params,
    tenant_bytes,
    tenant_view,
    unstack_params,
)
from repro_torch.core.workload import Workload, round_pow2  # noqa: F401

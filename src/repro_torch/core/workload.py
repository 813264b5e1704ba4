"""Generic schedulable work item — the unified space-time currency.

The paper's claim is that ONE dynamic scheduler can merge concurrent work
from disjoint tenants while preserving latency predictability. For that
to hold across layers, kernel-level work (a single GEMM) and
request-level work (a prefill, a tenant's decode step) must flow through
the SAME policy core. ``Workload`` is that common currency: anything
with a mergeability bucket, a cost estimate, a tenant, an SLO, and a way
to execute a batch of its peers.

Scheduler-facing protocol (duck-typed; ``GemmProblem`` satisfies it via
properties, ``Workload`` via plain fields):

    tenant_id        : int — isolation / SLO-accounting domain
    bucket           : Hashable — items sharing a bucket may be merged
                       into one super-dispatch
    cost             : float — abstract work estimate (FLOPs for GEMMs,
                       tokens for engine cohorts); feeds throughput stats
                       and virtual-clock cost models
    slo_s            : float — latency objective, drives the adaptive
                       batching window and violation accounting
    merge_family     : Optional[Hashable] — non-None marks buckets that
                       may additionally be ragged-merged across bucket
                       boundaries (e.g. GEMMs sharing (op, K, N, dtype))
    execute          : Optional[Callable[[List[Workload]], List[Any]]] —
                       batch executor; ``None`` routes the batch through
                       the scheduler's built-in SuperKernelCache (the
                       GEMM path)
    arrival_time     : float — stamped by the scheduler at submit
    result / completion_time — filled by the scheduler on completion
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Hashable, List, Optional

_seq = itertools.count()


def round_pow2(n: int) -> int:
    """Round ``n`` up to the next power of two (``round_pow2(0) == 1``).

    The canonical bucketing helper shared by the super-kernel compile
    cache (R and row-count buckets), the engine's ragged-group bucketing,
    and the simulator's calibrated cost-model keys — one definition so a
    live-measured (bucket, pow2-R) cost always lands in the same bucket a
    simulation will look up.
    """
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class Workload:
    """Concrete generic work item (see module docstring for the protocol).

    Layers above the kernel queue (the serving engine's prefill/decode
    cohorts, future async dispatch) build these directly; the ``execute``
    callback receives the whole merged batch so one callback invocation
    can run one super-dispatch for many tenants.
    """

    tenant_id: int
    bucket: Hashable
    cost: float = 0.0
    slo_s: float = 0.100
    execute: Optional[Callable[[List["Workload"]], List[Any]]] = None
    merge_family: Optional[Hashable] = None
    payload: Any = None
    # workload class for per-kind latency percentiles in the monitor
    # (e.g. "prefill" vs "decode" — compile-heavy prefills would otherwise
    # pollute decode-step p95s in engine reports)
    kind: str = "default"
    arrival_time: float = 0.0
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    # filled by the scheduler on completion:
    result: Any = None
    completion_time: Optional[float] = None

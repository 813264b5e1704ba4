"""Shape-bucketed workload arrival queue.

Interactive inference queries arrive stochastically; each query decomposes
into schedulable workloads — kernel launches (mostly GEMMs) at the bottom
layer, prefill/decode cohorts at the serving layer. The queue groups
pending workloads by their *bucket* (any hashable mergeability key —
``ShapeBucket`` for GEMMs, tuples for engine cohorts); items in the same
bucket are mergeable into one super-dispatch. This is the front-end of the
unified space-time scheduler.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Deque, Dict, Hashable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """Super-kernel mergeability key for GEMM-shaped workloads."""

    op: str                       # "gemm" (others pluggable)
    M: int
    K: int
    N: int
    dtype: str

    def __post_init__(self) -> None:
        # Buckets are dict keys on every queue/scheduler hot path and each
        # simulated event hashes its bucket several times; cache the tuple
        # hash once (same value the generated __hash__ would compute, so
        # dict layouts are unchanged). Not a field: repr/eq/asdict see
        # only the shape.
        object.__setattr__(
            self, "_hash",
            hash((self.op, self.M, self.K, self.N, self.dtype)))

    def __hash__(self) -> int:
        return self._hash

    @staticmethod
    def for_gemm(x: torch.Tensor, w: torch.Tensor) -> "ShapeBucket":
        M, K = x.shape
        _, N = w.shape
        return ShapeBucket("gemm", M, K, N, dtype_name(x.dtype))


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as the JAX package's buckets spell it ("float32")."""
    return str(dtype).removeprefix("torch.")


_seq = itertools.count()


@dataclasses.dataclass
class GemmProblem:
    """One pending GEMM from one tenant's model.

    Satisfies the ``Workload`` protocol (see ``core.workload``): ``bucket``
    / ``cost`` / ``merge_family`` are derived from the operand shapes, and
    its executor is the scheduler's built-in ``SuperKernelCache`` (it
    carries no ``execute`` callback).
    """

    kind = "kernel"               # monitor latency class (not a field)

    tenant_id: int
    x: torch.Tensor               # (M, K) activation
    w: torch.Tensor               # (K, N) this tenant's weights
    arrival_time: float = 0.0
    slo_s: float = 0.100
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    # filled by the scheduler on completion:
    result: Optional[torch.Tensor] = None
    completion_time: Optional[float] = None

    @property
    def bucket(self) -> ShapeBucket:
        return ShapeBucket.for_gemm(self.x, self.w)

    @property
    def merge_family(self) -> Tuple:
        """GEMMs sharing (op, K, N, dtype) may ragged-merge across M."""
        b = self.bucket
        return (b.op, b.K, b.N, b.dtype)

    @property
    def flops(self) -> int:
        M, K = self.x.shape
        N = self.w.shape[1]
        return 2 * M * K * N

    @property
    def cost(self) -> float:
        return float(self.flops)


class WorkQueue:
    """FIFO-per-bucket pending-workload store with per-tenant accounting.

    ``track_tenants=False`` skips the per-tenant counters (and makes
    ``pending_for_tenant`` constant 0): the scheduler only consults them
    when an admission cap is configured, and the simulator pushes millions
    of items through here — one defaultdict increment per push is real
    money on that path.
    """

    def __init__(self, track_tenants: bool = True) -> None:
        self._buckets: Dict[Hashable, Deque] = collections.defaultdict(
            collections.deque
        )
        self._per_tenant: Dict[int, int] = collections.defaultdict(int)
        self._track_tenants = track_tenants
        self._count = 0

    def push(self, item) -> int:
        """Append; returns the item's bucket depth after the push."""
        q = self._buckets[item.bucket]
        q.append(item)
        self._count += 1
        if self._track_tenants:
            self._per_tenant[item.tenant_id] += 1
        return len(q)

    def __len__(self) -> int:
        return self._count

    def pending_for_tenant(self, tenant_id: int) -> int:
        return self._per_tenant.get(tenant_id, 0)

    def buckets(self) -> List[Tuple[Hashable, int]]:
        return [(b, len(q)) for b, q in self._buckets.items() if q]

    def peek(self, bucket: Hashable) -> List:
        """Pending items of one bucket, FIFO order, without popping."""
        return list(self._buckets.get(bucket, ()))

    def head(self, bucket: Hashable):
        """Oldest pending item of a bucket (None if empty), O(1)."""
        q = self._buckets.get(bucket)
        return q[0] if q else None

    def oldest_arrival(self, bucket: Hashable) -> Optional[float]:
        q = self._buckets.get(bucket)
        return q[0].arrival_time if q else None

    def pop_batch(self, bucket: Hashable, max_n: int) -> List:
        """Pop up to max_n items from a bucket, FIFO order."""
        q = self._buckets[bucket]
        if len(q) <= max_n:
            out = list(q)
            q.clear()
        else:
            out = [q.popleft() for _ in range(max_n)]
        self._count -= len(out)
        if self._track_tenants:
            per_tenant = self._per_tenant
            for item in out:
                per_tenant[item.tenant_id] -= 1
        return out

    def drain(self) -> List:
        out = []
        for q in self._buckets.values():
            out.extend(q)
            q.clear()
        self._per_tenant.clear()
        self._count = 0
        return out


# Backwards-compatible alias: the queue predates the generic Workload
# refactor and most call sites still say "kernel queue".
KernelQueue = WorkQueue

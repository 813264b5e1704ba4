"""Super-kernel launch + cache (port).

"Space-time scheduling merges many concurrent small kernels from disjoint
DNN graphs into a small set of larger super-kernels that together fill the
GPU" -- here, one launch of the hand-written ``batched_gemm`` kernel (K1)
whose grid carries the problem index R, or, for problems of different row
counts, one launch of ``grouped_gemm`` (K2).

Because arrivals are stochastic, R varies call-to-call. The JAX package
compiles one program per (bucket, R bucket) and pads R up to a power of
two so the number of variants stays log2(max_R). Eager PyTorch compiles
nothing, but the port keeps the same keys, the same padding (zero problems,
discarded on unstack) and the same hit/miss accounting: a cache entry is
the launch function of its key, and ``CacheStats`` agree with the JAX
package's on the same problems. The paper observes "overheads gradually
decrease if we cache super-kernels as workloads stabilize"; the hit rate
makes that measurable.

Every ``execute*`` waits for its launch to finish before it returns (on a
card, by synchronising the current stream), as the JAX cache blocks on its
result: the scheduler reads its clock right after, so a latency measures
the GEMM, not its launch. Stacked inputs follow the ``TenantManager``
layout (``core.tenancy``): tenant weights stacked along a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ScheduleConfig
from repro_torch.core.queue import GemmProblem, ShapeBucket, dtype_name
from repro_torch.core.workload import round_pow2
from repro_torch.kernels import ops
from repro_torch.kernels.grouped_gemm import make_group_layout

RAGGED_BM = 128  # row block of the ragged merge (K2's bm)


def sync(t: torch.Tensor) -> torch.Tensor:
    """Wait until the work producing ``t`` is done (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


def stack_padded(ts: Sequence[torch.Tensor], r_bucket: int) -> torch.Tensor:
    """Stack ``ts`` along a new leading axis, zero-padded to ``r_bucket``."""
    out = torch.empty((r_bucket, *ts[0].shape), dtype=ts[0].dtype, device=ts[0].device)
    torch.stack(list(ts), out=out[: len(ts)])
    out[len(ts):].zero_()
    return out


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    executions: int = 0
    problems_executed: int = 0
    padded_problems: int = 0

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0


class SuperKernelCache:
    """Super-kernel store keyed on (bucket, R_bucket)."""

    def __init__(self, schedule: ScheduleConfig):
        self.schedule = schedule
        self._cache: Dict[Tuple[ShapeBucket, int], Callable] = {}
        self.stats = CacheStats()

    def _r_bucket(self, r: int) -> int:
        if self.schedule.r_bucketing == "exact":
            return r
        return round_pow2(r)

    def _lookup(self, key: Tuple[ShapeBucket, int], build: Callable[[], Callable]) -> Callable:
        fn = self._cache.get(key)
        if fn is None:
            self.stats.misses += 1
            fn = build()
            self._cache[key] = fn
        else:
            self.stats.hits += 1
        return fn

    def get(self, bucket: ShapeBucket, r: int) -> Tuple[Callable, int]:
        r_bucket = self._r_bucket(r)
        fn = self._lookup((bucket, r_bucket), lambda: ops.batched_gemm)
        return fn, r_bucket

    def execute_stacked(
        self, bucket: ShapeBucket, xs: torch.Tensor, ws: torch.Tensor, r: int
    ) -> torch.Tensor:
        """Run a super-kernel over ALREADY-STACKED device-resident slabs.

        This is the paper's measurement setting ("data is preallocated on
        the device as in a real-world DNN inference setting"): tenant
        weights live stacked in the TenantManager, so dispatch cost is pure
        kernel time. Returns the stacked (R, M, N) output.
        """
        fn, r_bucket = self.get(bucket, r)
        if r_bucket != xs.shape[0]:
            pad = r_bucket - xs.shape[0]
            xs = torch.cat([xs, xs.new_zeros((pad, *xs.shape[1:]))])
            ws = torch.cat([ws, ws.new_zeros((pad, *ws.shape[1:]))])
            self.stats.padded_problems += pad
        out = sync(fn(xs, ws))
        self.stats.executions += 1
        self.stats.problems_executed += r
        return out if out.shape[0] == r else out[:r]

    def ragged_layout(self, sizes: Sequence[int]) -> Tuple[np.ndarray, int, np.ndarray, int]:
        """The layout ``execute_ragged`` launches K2 on for problems of
        ``sizes`` rows: (row offsets, padded rows T_bucket, block_groups of
        the T_bucket / RAGGED_BM row blocks, group count G_bucket). Tail
        blocks belong to group 0 and hold zero rows."""
        offsets, block_groups, T = make_group_layout(np.asarray(sizes), bm=RAGGED_BM)
        t_bucket = self._r_bucket(T // RAGGED_BM) * RAGGED_BM  # pow2-bucket padded rows
        bg = np.zeros((t_bucket // RAGGED_BM,), np.int32)
        bg[: len(block_groups)] = block_groups
        return offsets, t_bucket, bg, self._r_bucket(len(sizes))

    def execute_ragged(self, problems: List[GemmProblem]) -> List[torch.Tensor]:
        """Variable-M merge (MAGMA-vbatched analogue, beyond-paper).

        Problems must share (K, N, dtype) but may have DIFFERENT row counts
        M -- e.g. tenants with different live batch sizes. Rows are packed
        group-aligned and run through ONE grouped_gemm launch; the cache
        key buckets BOTH the padded total row count and the group count
        (pow2 each -- extra groups carry zero weights and own no row
        blocks), so the variant count stays bounded at
        log2(max_rows) * log2(max_groups) under stochastic M mixes.
        """
        if not problems:
            return []
        K = problems[0].x.shape[1]
        N = problems[0].w.shape[1]
        dt = problems[0].x.dtype
        if not all(p.x.shape[1] == K and p.w.shape[1] == N and p.x.dtype == dt
                   for p in problems):
            raise ValueError("ragged merge requires matching (K, N, dtype)")

        sizes = [p.x.shape[0] for p in problems]
        offsets, t_bucket, bg, g_bucket = self.ragged_layout(sizes)

        xs = torch.zeros((t_bucket, K), dtype=dt, device=problems[0].x.device)
        for p, off in zip(problems, offsets):
            xs[int(off): int(off) + p.x.shape[0]] = p.x
        ws = stack_padded([p.w for p in problems], g_bucket)
        self.stats.padded_problems += g_bucket - len(problems)

        key = (ShapeBucket("grouped", t_bucket, K, N, dtype_name(dt)), g_bucket)
        fn = self._lookup(key, lambda: lambda x, w, g: ops.grouped_gemm(x, w, g, bm=RAGGED_BM))
        out = sync(fn(xs, ws, bg))
        self.stats.executions += 1
        self.stats.problems_executed += len(problems)
        return [out[int(off): int(off) + int(sz)] for off, sz in zip(offsets, sizes)]

    def execute(self, problems: List[GemmProblem]) -> List[torch.Tensor]:
        """Merge problems (same bucket) into one super-kernel call."""
        if not problems:
            return []
        bucket = problems[0].bucket
        if any(p.bucket != bucket for p in problems):
            raise ValueError("bucket mismatch")
        r = len(problems)
        fn, r_bucket = self.get(bucket, r)
        xs = stack_padded([p.x for p in problems], r_bucket)
        ws = stack_padded([p.w for p in problems], r_bucket)
        self.stats.padded_problems += r_bucket - r
        out = sync(fn(xs, ws))
        self.stats.executions += 1
        self.stats.problems_executed += r
        return [out[i] for i in range(r)]

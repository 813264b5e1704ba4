"""The four multiplexing strategies under comparison (paper sections 3-4).

Each strategy executes the same list of per-tenant GEMM workloads
(``GemmProblem``, the kernel-level instance of the generic ``Workload``
protocol -- same ``ShapeBucket``/cost types the unified scheduler and
``SuperKernelCache`` consume) and returns (outputs, wall_time_s). On an
H100 they are the CUDA mechanisms the paper measured:

    exclusive : one tenant owns the device; its problems run as ONE
                data-batched product (the paper's "batched exclusive
                access" upper bound -- only valid when all problems share
                weights).
    time_only : one launch per problem with a device sync after each
                (CUDA-context time-slicing: only one context's kernel is
                resident per quantum).
    space_only: R separate products spread over CUDA streams, joined
                before the sync (Hyper-Q): the card may run them
                concurrently but no single product gets wider.
    space_time: the proposed approach -- all R problems merged into one
                batched super-kernel (K1) via SuperKernelCache.

The products of time_only, space_only and exclusive go to ``torch.matmul``
(cuBLAS), as the JAX package leaves them to XLA: they are the strategies
under comparison, not plain versions of K1. Tenant weights follow the
``TenantManager`` layout (``core.tenancy``). The benchmark claims to
validate (Table 1 / Fig 7): throughput ordering space_time > space_only >
time_only, with the gap growing in R.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from repro_torch.core.queue import GemmProblem
from repro_torch.core.superkernel import SuperKernelCache, sync

Outputs = List[torch.Tensor]


class Strategy:
    """Measurement protocol (matches the paper): ``prepare`` moves the
    problems into the strategy's natural device-resident layout and warms
    the launch path -- "data is preallocated on the device as in a
    real-world DNN inference setting" -- so ``run`` times pure dispatch +
    compute: host wall seconds around a region that ends in a sync."""

    name: str = "base"

    def prepare(self, problems: List[GemmProblem]) -> None:
        raise NotImplementedError

    def run(self) -> Tuple[Outputs, float]:
        raise NotImplementedError


class TimeOnly(Strategy):
    """Sequential per-tenant dispatch with a sync per dispatch (context switch)."""

    name = "time_only"

    def __init__(self, switch_overhead_s: float = 0.0):
        # Optional modeled context-switch cost, slept after each synced
        # dispatch; 0 keeps it purely measured (the dispatch and sync cost
        # is real on its own).
        self.switch_overhead_s = switch_overhead_s
        self._data: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def prepare(self, problems: List[GemmProblem]) -> None:
        self._data = [(p.x.contiguous(), p.w.contiguous()) for p in problems]
        sync(torch.matmul(*self._data[0]))

    def run(self) -> Tuple[Outputs, float]:
        t0 = time.perf_counter()
        outs = []
        for x, w in self._data:
            outs.append(sync(torch.matmul(x, w)))  # sync = context-switch boundary
            if self.switch_overhead_s:
                time.sleep(self.switch_overhead_s)
        return outs, time.perf_counter() - t0


# Streams space_only spreads its products over: Hyper-Q's hardware queues
# (CUDA_DEVICE_MAX_CONNECTIONS sets how many CUDA uses, 8 by
# default), and the size of PyTorch's stream pool, which hands out its
# streams round-robin.
MAX_STREAMS = 32


class SpaceOnly(Strategy):
    """R independent products on up to 32 CUDA streams (Hyper-Q), problem
    i on stream i mod 32; in order on the CPU.

    The streams map onto 32 hardware queues only when the process sets
    ``CUDA_DEVICE_MAX_CONNECTIONS=32`` before it makes its CUDA context;
    with CUDA's default of 8, streams share queues and products on
    different streams can wait on each other."""

    name = "space_only"

    def __init__(self):
        self._xs: List[torch.Tensor] = []
        self._ws: List[torch.Tensor] = []
        self._streams: List[torch.cuda.Stream] = []

    def prepare(self, problems: List[GemmProblem]) -> None:
        self._xs = [p.x.contiguous() for p in problems]
        self._ws = [p.w.contiguous() for p in problems]
        dev = self._xs[0].device
        self._streams = ([torch.cuda.Stream(dev) for _ in range(min(len(problems), MAX_STREAMS))]
                         if dev.type == "cuda" else [])
        self._launch()
        self._join()

    def _launch(self) -> Tuple[Outputs, Optional[torch.cuda.Stream]]:
        if not self._streams:
            return [torch.matmul(x, w) for x, w in zip(self._xs, self._ws)], None
        main = torch.cuda.current_stream(self._xs[0].device)
        ready = torch.cuda.Event()
        ready.record(main)
        for s in self._streams:
            s.wait_event(ready)
        outs = []
        # R *separate* products, deliberately NOT stacked: the card may
        # run them concurrently but cannot merge them. The operands, held
        # by this object, stay alive until the sync after the join.
        n = len(self._streams)
        for i, (x, w) in enumerate(zip(self._xs, self._ws)):
            with torch.cuda.stream(self._streams[i % n]):
                outs.append(torch.matmul(x, w))
        for s in self._streams:
            main.wait_stream(s)
        return outs, main

    def _join(self) -> None:
        if self._streams:
            torch.cuda.current_stream(self._xs[0].device).synchronize()

    def run(self) -> Tuple[Outputs, float]:
        t0 = time.perf_counter()
        outs, main = self._launch()
        self._join()
        dt = time.perf_counter() - t0
        if main is not None:
            # outputs were allocated on side streams; later readers use main
            for o in outs:
                o.record_stream(main)
        return outs, dt


class SpaceTime(Strategy):
    """The proposed super-kernel path (batched GEMM via SuperKernelCache).

    Tenant weights live stacked (TenantManager layout); inputs are staged
    into a stacked slab -- both device-resident before the timed region.
    """

    name = "space_time"

    def __init__(self, cache: SuperKernelCache):
        self.cache = cache
        self._xs = None
        self._ws = None
        self._bucket = None
        self._r = 0

    def prepare(self, problems: List[GemmProblem]) -> None:
        self._bucket = problems[0].bucket
        self._r = len(problems)
        self._xs = sync(torch.stack([p.x for p in problems]))
        self._ws = sync(torch.stack([p.w for p in problems]))
        self.cache.execute_stacked(self._bucket, self._xs, self._ws, self._r)

    def run(self) -> Tuple[Outputs, float]:
        t0 = time.perf_counter()
        out = self.cache.execute_stacked(self._bucket, self._xs, self._ws, self._r)
        dt = time.perf_counter() - t0
        # unstacking happens outside the timed region (consumers read slices
        # of the stacked slab in-place in the real serving path)
        return [out[i] for i in range(self._r)], dt


class Exclusive(Strategy):
    """Single-tenant data-batched upper bound (shared weights, batched inputs)."""

    name = "exclusive"

    def __init__(self):
        self._xs = None
        self._w = None
        self._r = 0

    def prepare(self, problems: List[GemmProblem]) -> None:
        self._r = len(problems)
        self._xs = sync(torch.stack([p.x for p in problems]))
        self._w = problems[0].w.contiguous()  # single tenant: one weight
        sync(torch.matmul(self._xs, self._w))

    def run(self) -> Tuple[Outputs, float]:
        t0 = time.perf_counter()
        out = sync(torch.matmul(self._xs, self._w))
        return [out[i] for i in range(self._r)], time.perf_counter() - t0

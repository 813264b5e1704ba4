"""Captured decode steps and prefills: the port's counterpart of the
reference's compiled programs in ``src/repro/serving/engine.py``: the decode
programs ``jax.jit(_decode_all)`` (the merged step of every tenant) and
``jax.jit(_decode_one)`` (one tenant's step), and the prefill programs
``jax.jit(_prefill)`` and ``jax.jit(_prefill_cont)`` (a continuation from a
traced ``start``).

A decode step of an engine has one shape for the engine's life: it always
decodes all R x B slots (merged) or one tenant's B slots (time_only), over
caches and weights that never move. So each step is a ``StepProgram``: its
tokens and lengths live in device buffers that a copy from a pinned host
buffer refills before every run, and on the card the step is captured once
as a CUDA graph and replayed from then on, one launch in place of the
step's hundreds to thousands (``PERF.md`` §5: the eager step is host-bound).

Graph or eager is a fixed rule, decided when the engine is built and never
as a fallback (``use_graphs``): graphs for a CUDA device, eager for the CPU
and the meta device; ``graphs=False`` asks for eager on the card, and
``graphs=True`` anywhere but the card raises. On the graph route:

- the first call runs the step eagerly (the warm-up: kernel builds,
  ``cudaFuncSetAttribute``, cuBLAS handles and workspaces), on the stream
  that later captures;
- the second call captures the step, which runs nothing, and replays it;
  every later call replays. So each call advances the caches exactly once:
  RWKV's state and token shifts and Mamba2's state and conv tails are
  written once per step, as in the eager engine;
- a capture or a replay that fails raises; nothing runs eagerly instead.

Captures run under ``torch.no_grad()`` with ``capture_error_mode=
"thread_local"`` (another thread's CUDA calls do not void a capture), and
count their kernel launches by ``ops.capturing``: a capture adds nothing to
``ops.COUNTERS`` and each replay adds the graph's launches by variant. The
counters are process-wide, so no other thread may launch kernels while an
engine captures; the serving loops step their engines from one thread
(``launch/serve.py`` under the fleet lock).

The step closes over the caches and weights: they are captured by pointer,
and must be written in place (prefill does) and never rebound. A program's
output is valid until the next run of any program of the same engine: the
engine's programs share one memory pool and run one after another.

Prefills (``PrefillProgram``, ``PrefillPrograms``). A prompt has a length of
its own, and a graph one shape, so the engine splits every prompt into
pieces whose lengths come from a fixed set (``engine.prefill_pieces``) and
runs each piece as a continuation (``Model.forward_prefill`` with ``start``
a 0-dim device tensor) into one scratch single-sequence cache made at
engine build. There is one program per (tenant, piece size): its step reads
the program's static token buffer, the engine's static ``start`` buffer and
the tenant's weight views, and writes the scratch cache. On the graph route
all of them are captured when the engine is built (one eager warm-up per
size, then one capture per program), so serving only replays; a capture or
a replay that fails raises. Without a ``GraphShare`` each piece runs
eagerly, the same ops on the same buffers.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import OpCounter

Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# a prefill piece: (tokens (1, n), start (0-dim int64)) -> last-position logits
Prefill = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def use_graphs(device: torch.device, graphs: Optional[bool] = None) -> bool:
    """Whether an engine on ``device`` runs its decode steps as CUDA graphs:
    ``graphs`` where given, else exactly for a CUDA device (the CPU and the
    meta device run eagerly, as ``ops.PLAIN_DEVICES`` run the plain
    versions). Raises for ``graphs=True`` on any other device."""
    device = torch.device(device)
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
    return bool(graphs)


class StepProgram:
    """One decode step of a fixed shape, run through static input buffers.

    ``step(tokens, lengths)`` is the model's decode over the engine's caches
    and weights and returns the logits; ``tokens`` and ``lengths`` (int64,
    of ``shape``) are always this program's device buffers. ``run`` stages
    the host's tokens and lengths into them and runs the step: eagerly,
    or on the graph route eagerly once, then captured and replayed.
    """

    grad = False  # whether the step records autograd (a train step's does)

    def __init__(self, step: Step, shape: Tuple[int, ...], device: torch.device,
                 graphs: Optional["GraphShare"] = None):
        self._setup(step, device, graphs)
        self._inputs = torch.zeros((2, *shape), dtype=torch.int64, device=self.device)
        self.tokens, self.lengths = self._inputs[0], self._inputs[1]
        pinned = self.device.type == "cuda"
        self._host = torch.zeros((2, *shape), dtype=torch.int64, pin_memory=pinned)
        self._host_np = self._host.numpy()
        # the last copy out of the host buffer, waited on before it is refilled
        self._staged = torch.cuda.Event() if pinned else None

    def _setup(self, step: Step, device: torch.device, graphs: Optional["GraphShare"]) -> None:
        self.step = step
        self.device = torch.device(device)
        self.graphs = graphs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None  # the graph's static output
        self.launches: Dict[str, OpCounter] = {}    # per op, one replay's launches
        self.eager_passes = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0  # device memory the capture reserved

    def stage(self, tokens: np.ndarray, lengths: np.ndarray) -> None:
        """Copy the host's tokens and lengths into the static buffers, on
        the current stream, ahead of the step that reads them."""
        if self._staged is not None:
            self._staged.synchronize()
        self._host_np[0] = tokens
        self._host_np[1] = lengths
        self._inputs.copy_(self._host, non_blocking=True)
        if self._staged is not None:
            self._staged.record()

    def run(self, tokens: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Stage the inputs, then run the step once: eager, or the first
        eager call, the capture and its replay, or a replay."""
        self.stage(tokens, lengths)
        if self.graphs is None or (self.graph is None and not self.eager_passes):
            return self._eager()
        if self.graph is None:
            self._capture()
        return self.replay()

    def replay(self) -> torch.Tensor:
        """Launch the captured step once on the current stream, over
        whatever the static buffers hold, and count its launches."""
        self.graph.replay()
        ops.replayed(self.launches)
        self.replays += 1
        return self.logits

    def inputs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two static buffers the step reads."""
        return self.tokens, self.lengths

    def _eager(self) -> torch.Tensor:
        self.eager_passes += 1
        with torch.set_grad_enabled(self.grad):
            if self.graphs is None:
                return self.step(*self.inputs())
            return self.graphs.warm_up(self.step, *self.inputs())

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with ops.capturing() as launches, torch.set_grad_enabled(self.grad):
            graph, logits, pool_bytes = self.graphs.capture(self.step, *self.inputs())
        self.graph, self.logits, self.launches = graph, logits, launches
        self.captures += 1
        self.pool_bytes += pool_bytes
        self.capture_s += time.perf_counter() - t0


class PrefillProgram(StepProgram):
    """One piece size ``n`` of one tenant's prefill, run through a static
    token buffer (1, n) and the engine's static ``start`` buffer (0-dim
    int64, shared by every program of the engine).

    ``step(tokens, start)`` prefills the piece into the engine's scratch
    cache and returns its last position's logits. ``run`` runs it eagerly
    (no ``GraphShare``) or replays the capture made at engine build
    (``PrefillPrograms.capture``); it never captures on its own, so a
    program that was not captured raises.
    """

    def __init__(self, step: Prefill, n: int, start: torch.Tensor, device: torch.device,
                 graphs: Optional["GraphShare"] = None):
        self._setup(step, device, graphs)
        self.n = n
        self.tokens = torch.zeros((1, n), dtype=torch.int64, device=self.device)
        self.start = start

    def inputs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.tokens, self.start

    def run(self) -> torch.Tensor:
        """The piece over whatever the buffers hold: eager, or a replay."""
        if self.graphs is None:
            return self._eager()
        if self.graph is None:
            raise RuntimeError(f"prefill program of {self.n} tokens was not captured at build")
        return self.replay()


class GraphShare:
    """What an engine's graphs share, and the two CUDA calls of the graph
    route: one memory pool (the graphs replay one after another, never at
    once) and one stream that warms up and captures."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def warm_up(self, step: Step, tokens: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Run ``step`` eagerly on the capture stream, so that the state
        made lazily at a first call (cuBLAS workspaces) exists for it before
        capture; ordered after and before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = step(tokens, lengths)
        current.wait_stream(self.stream)
        out.record_stream(current)
        return out

    def capture(self, step: Step, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor, int]:
        """Capture ``step`` into a new graph (nothing runs): returns the
        graph, its static output and the device bytes the capture reserved."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # so the reserved bytes below are the capture's
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = step(tokens, lengths)
        return graph, out, torch.cuda.memory_reserved(self.device) - reserved


class StepPrograms:
    """An engine's decode programs by key (one merged step, or one per
    tenant), all on the route ``use_graphs`` picked for the engine."""

    def __init__(self, device: torch.device, graphs: bool):
        self.device = torch.device(device)
        self.graphed = graphs
        self.share = GraphShare(self.device) if graphs else None
        self.programs: Dict[Hashable, StepProgram] = {}
        self.prefill: Optional[PrefillPrograms] = None  # the piece route's, set by the engine

    def get(self, key: Hashable, make_step: Callable[[], Step],
            shape: Tuple[int, ...]) -> StepProgram:
        """The program under ``key``, made on first use from ``make_step()``."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = StepProgram(make_step(), shape, self.device,
                                                    self.share)
        return prog

    def stats(self) -> Dict[str, float]:
        """Over every decode program: decode passes that ran (eager +
        replays), eager passes, captures, replays, capture seconds and the
        bytes the captures reserved; and the prefill programs' apart, under
        ``prefill_*`` keys (``PrefillPrograms.stats``), on the piece route."""
        progs = list(self.programs.values())
        eager = sum(p.eager_passes for p in progs)
        replays = sum(p.replays for p in progs)
        out = {"programs": len(progs), "graphed": self.graphed,
               "decode_passes": eager + replays, "eager_passes": eager,
               "captures": sum(p.captures for p in progs), "replays": replays,
               "capture_s": sum(p.capture_s for p in progs),
               "pool_bytes": sum(p.pool_bytes for p in progs)}
        if self.prefill is not None:
            out.update({f"prefill_{k}": v for k, v in self.prefill.stats().items()})
        return out


class PrefillPrograms:
    """An engine's prefill programs, one per (tenant, piece size), over one
    scratch cache and one ``start`` buffer, on the engine's route: captured
    by ``capture`` at engine build with ``share`` (the decode programs'
    ``GraphShare``: one pool, one stream), eager without one.

    ``make_step(t)`` gives tenant t's piece step (``Prefill``).
    """

    def __init__(self, make_step: Callable[[int], Prefill], tenants: int, sizes: Tuple[int, ...],
                 start: torch.Tensor, device: torch.device, share: Optional[GraphShare]):
        self.sizes = tuple(sizes)
        self.start = start
        steps = [make_step(t) for t in range(tenants)]
        self.programs: Dict[Tuple[int, int], PrefillProgram] = {
            (t, n): PrefillProgram(steps[t], n, start, device, share)
            for t in range(tenants) for n in self.sizes}
        self.warm_ups = 0

    def capture(self) -> None:
        """The graph route's build: one eager warm-up for each piece size
        (tenant 0's program), then one capture for each program. Raises if
        a capture fails; nothing is left to capture while serving."""
        for n in self.sizes:  # on the capture stream (GraphShare.warm_up)
            self.programs[(0, n)]._eager()
            self.warm_ups += 1
        for prog in self.programs.values():
            prog._capture()

    def run(self, tenant: int, tokens: torch.Tensor, start: int) -> torch.Tensor:
        """Prefill ``tokens`` (1, n) of ``tenant``'s prompt at position
        ``start`` through the (tenant, n) program: the tokens and the start
        are copied into the static buffers on the current stream, then the
        piece runs; returns its logits (valid until the next program runs)."""
        prog = self.programs[(tenant, tokens.shape[1])]
        prog.tokens.copy_(tokens)
        self.start.fill_(start)
        return prog.run()

    def stats(self) -> Dict[str, float]:
        """Programs, eager warm-ups at build, eager pieces (the eager
        route's), captures, replays, capture seconds and pool bytes."""
        progs = list(self.programs.values())
        return {"programs": len(progs), "warm_ups": self.warm_ups,
                "eager_passes": sum(p.eager_passes for p in progs) - self.warm_ups,
                "captures": sum(p.captures for p in progs),
                "replays": sum(p.replays for p in progs),
                "capture_s": sum(p.capture_s for p in progs),
                "pool_bytes": sum(p.pool_bytes for p in progs)}

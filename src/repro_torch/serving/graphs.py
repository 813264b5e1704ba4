"""Captured decode steps: the port's counterpart of the reference's compiled
decode programs, ``jax.jit(_decode_all)`` (the merged step of every tenant)
and ``jax.jit(_decode_one)`` (one tenant's step) in
``src/repro/serving/engine.py``.

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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import OpCounter

Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
        self.step = step
        self.device = torch.device(device)
        self.graphs = graphs
        self._inputs = torch.zeros((2, *shape), dtype=torch.int64, device=self.device)
        self.tokens, self.lengths = self._inputs[0], self._inputs[1]
        pinned = self.device.type == "cuda"
        self._host = torch.zeros((2, *shape), dtype=torch.int64, pin_memory=pinned)
        self._host_np = self._host.numpy()
        # the last copy out of the host buffer, waited on before it is refilled
        self._staged = torch.cuda.Event() if pinned else None
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

    def _eager(self) -> torch.Tensor:
        self.eager_passes += 1
        with torch.set_grad_enabled(self.grad):
            if self.graphs is None:
                return self.step(self.tokens, self.lengths)
            return self.graphs.warm_up(self.step, self.tokens, self.lengths)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        with ops.capturing() as launches, torch.set_grad_enabled(self.grad):
            graph, logits, pool_bytes = self.graphs.capture(self.step, self.tokens, self.lengths)
        self.graph, self.logits, self.launches = graph, logits, launches
        self.captures += 1
        self.pool_bytes += pool_bytes
        self.capture_s += time.perf_counter() - t0


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

    def get(self, key: Hashable, make_step: Callable[[], Step],
            shape: Tuple[int, ...]) -> StepProgram:
        """The program under ``key``, made on first use from ``make_step()``."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = StepProgram(make_step(), shape, self.device,
                                                    self.share)
        return prog

    def stats(self) -> Dict[str, float]:
        """Over every program: decode passes that ran (eager + replays),
        eager passes, captures, replays, capture seconds and the bytes the
        captures reserved."""
        progs = list(self.programs.values())
        eager = sum(p.eager_passes for p in progs)
        replays = sum(p.replays for p in progs)
        return {"programs": len(progs), "graphed": self.graphed,
                "decode_passes": eager + replays, "eager_passes": eager,
                "captures": sum(p.captures for p in progs), "replays": replays,
                "capture_s": sum(p.capture_s for p in progs),
                "pool_bytes": sum(p.pool_bytes for p in progs)}

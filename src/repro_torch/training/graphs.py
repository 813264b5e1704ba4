"""The captured train step: the port's counterpart of the reference's
compiled train step, ``jax.jit(make_train_step(...))`` in
``src/repro/training/train_loop.py`` and ``@jax.jit def step`` in
``src/repro/launch/train.py``.

A train step has one shape for a run's life (a fixed batch of tokens and
labels) over params and AdamW moments that never move: forward, backward
and the in-place update write the same tensors every step. So the step is a
``TrainProgram``, the train-step form of ``serving.graphs.StepProgram``:
its tokens and labels live in int64 device buffers that a copy from a
pinned host buffer refills before every call, an event guarding the refill;
on the card the step is captured once as a CUDA graph and replayed from
then on, one launch in place of the step's ~10,000-17,600 (``PERF.md`` §5:
the eager rwkv6-1.6b step is host-bound).

Graph or eager is decided once, by ``serving.graphs.use_graphs`` (graphs for
a CUDA device, eager for the CPU and the meta device; ``graphs=False`` is
the eager yardstick on the card, ``graphs=True`` anywhere else raises), and
never as a fallback. On the graph route:

- the first call runs the step eagerly on the capture stream (the warm-up:
  kernel builds, ``cudaFuncSetAttribute``, cuBLAS handles and workspaces);
- the second call captures the step, which runs nothing, and replays it
  once; every later call replays. So each call advances the params, the
  moments and the step counter exactly once;
- a capture or a replay that fails raises; nothing runs eagerly instead.

What the graph route needs of the step:

- **The step counter is written in place.** ``adamw_update`` returns the
  new step as a new tensor; under a graph that is a static output, and
  every replay would read the same ``opt.step``: the lr schedule and the
  bias corrections would stay at the captured step. The step copies the
  new step into the persistent ``opt.step`` (``TrainStep.advance``), on
  both routes, so ``opt`` is always the state after the last call.
- **No host read inside the step.** Nothing reads a device value on the
  host; the metrics (``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``) are
  the graph's static outputs, valid until the next call, read by the
  caller after it (``train()`` on its log steps).
- **Buffers made inside the step** (the autograd route's saved ``lse`` and
  ``ckpt``, the activations, the gradients, the zero gradients of params
  the loss does not reach) come from the graph's private pool, which keeps
  them between replays: ``pool_bytes`` is that footprint.
- **Leaves and the checkpoint.** The params get ``requires_grad_(True)``
  when the program is made, never inside a capture. A checkpoint read
  between calls reads the persistent params and moments; anything restored
  into a graphed program is ``copy_``-ed into those tensors, never rebound.
- **Backward runs on autograd's device thread**, on the stream of the
  forward (the capture stream), so its K4-bwd and K5-bwd launches join the
  capture from that thread: a stream under capture records whatever thread
  launches on it. The capture mode only decides whose unsafe CUDA calls
  (a synchronize, a legacy-stream query) void the capture. On the H100 all
  three modes captured the whole step, backward kernels included, with
  every step bitwise equal to eager (``experiments/train_graph_probes.py``,
  stablelm-1.6b and rwkv6-1.6b at d_model 512, bf16). The program
  keeps ``"thread_local"``, as the decode graphs do: a call of another
  thread of the process does not void it, while the capturing thread's own
  unsafe calls still raise. The launch counters are process-wide snapshots
  (``ops.capturing``), so the launches counted on autograd's thread land in
  the capture's counts; no other thread may launch kernels while a program
  captures.
- **Activation checkpoints** (``remat="block"``) capture as they are: the
  recompute runs inside the backward, on the capture stream, and stashing
  CUDA's generator state, which ``torch.utils.checkpoint`` does by default,
  is allowed under capture (the same script's second probe).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.graphs import GraphShare, StepProgram, use_graphs
from repro_torch.training.optimizer import AdamWState
from repro_torch.tree import tree_leaves

Metrics = Dict[str, torch.Tensor]
TrainStepFn = Callable[[Any, AdamWState, torch.Tensor, torch.Tensor],
                       Tuple[Any, AdamWState, Metrics]]


class TrainShare(GraphShare):
    """A train program's memory pool and capture stream, and its two CUDA
    calls (``GraphShare``'s capture, in ``thread_local`` mode). The step's
    output is a dict of metrics, not one tensor."""

    def warm_up(self, step, tokens, labels) -> Metrics:
        """Run ``step`` eagerly on the capture stream, ordered after and
        before the current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = step(tokens, labels)
        current.wait_stream(self.stream)
        for t in out.values():
            t.record_stream(current)
        return out


class TrainStep:
    """The step a ``TrainProgram`` runs: ``step_fn`` (``make_train_step``'s
    (params, opt, tokens, labels) -> (params, opt, metrics), which updates
    the params and moments in place) over the persistent ``params`` and
    ``opt``, then the new step counter written into the persistent one
    (``advance``). It holds no reference to its program, so a program that
    is dropped frees its graph and pool at once, not at the next garbage
    collection."""

    def __init__(self, step_fn: TrainStepFn, params: Any, opt: AdamWState):
        self.step_fn = step_fn
        self.params, self.opt = params, opt

    def __call__(self, tokens: torch.Tensor, labels: torch.Tensor) -> Metrics:
        _, opt, metrics = self.step_fn(self.params, self.opt, tokens, labels)
        self.advance(opt)
        return metrics

    def advance(self, opt: AdamWState) -> None:
        """Write the new step counter into the persistent one."""
        self.opt.step.copy_(opt.step)


class TrainProgram(StepProgram):
    """One train step of a fixed (batch, seq) shape over persistent params
    and AdamW state, run through static token and label buffers.

    ``run(tokens, labels)`` stages a host batch and runs ``step`` once:
    eagerly (``share`` None), or on the graph route eagerly once, then
    captured and replayed. ``params`` and ``opt`` are always the state after
    the last call; ``run`` returns the metrics, valid until the next call.
    """

    grad = True

    def __init__(self, step: TrainStep, shape: Tuple[int, int], device: torch.device,
                 share: Optional[TrainShare] = None):
        for p in tree_leaves(step.params):
            p.requires_grad_(True)
        super().__init__(step, tuple(shape), device, share)
        self.labels = self.lengths  # the second static buffer

    @property
    def params(self) -> Any:
        return self.step.params

    @property
    def opt(self) -> AdamWState:
        return self.step.opt

    def stage(self, tokens, labels) -> None:
        """Copy a host batch (numpy arrays or CPU tensors of the program's
        shape) into the static buffers, on the current stream."""
        for name, a in (("tokens", tokens), ("labels", labels)):
            if tuple(np.shape(a)) != tuple(self.tokens.shape):
                raise ValueError(f"{name} of shape {tuple(np.shape(a))}: this program's "
                                 f"batch is {tuple(self.tokens.shape)}")
        super().stage(tokens, labels)

    def stats(self) -> Dict[str, float]:
        """Steps that ran (eager + replays), eager passes, captures, replays,
        capture seconds and the bytes the capture reserved."""
        return {"graphed": self.graphs is not None,
                "steps": self.eager_passes + self.replays, "eager_passes": self.eager_passes,
                "captures": self.captures, "replays": self.replays,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes}

    def release(self) -> None:
        """Drop the graph and its static outputs (the pool's blocks go back
        to the allocator), and take the params off autograd."""
        self.graph = self.logits = None
        for p in tree_leaves(self.params):
            p.requires_grad_(False)


def train_program(step_fn: TrainStepFn, params: Any, opt: AdamWState, shape: Tuple[int, int],
                  device: torch.device, graphs: Optional[bool] = None) -> TrainProgram:
    """A ``TrainProgram`` on the route ``use_graphs(device, graphs)`` picks."""
    share = TrainShare(device) if use_graphs(device, graphs) else None
    return TrainProgram(TrainStep(step_fn, params, opt), shape, device, share)

"""Train loop: a step (autograd + in-place AdamW), metrics, checkpoints.

The JAX package's ``repro.training.train_loop`` with PyTorch inside: the
step is ``torch.autograd.grad`` over ``Model.forward_train`` where the
reference takes ``jax.value_and_grad``, and the params are initialised
from a ``torch.Generator`` seeded with ``seed`` on the model's device.
Where the reference compiles the step (``jax.jit``), ``train`` runs it as a
``training.graphs.TrainProgram``: on the card captured once as a CUDA graph
and replayed, on the CPU and the meta device eagerly (``graphs=False`` asks
for eager on the card). On the card, every attention layer's forward and
backward run the hand-written K4 kernels and every RWKV-6 layer's the K5
kernels (``kernels.ops``' autograd route), and the update the AdamW
kernels (``kernels/adamw.py``). Log lines and the checkpoint cadence are
the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import Model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import graphs as _graphs
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, lr_schedule
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    step: int = 0


def make_train_step(
    model: Model,
    *,
    base_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 1000,
    weight_decay: float = 0.1,
) -> Callable:
    """Builds the (params, opt, tokens, labels) -> (params, opt, metrics)
    step. Params and moments are updated in place and returned; a param
    the loss does not reach gets a zero gradient, as under JAX. The AdamW
    kernel takes contiguous gradients, so one that autograd hands over
    strided (zamba2's depthwise conv weights) is copied into a contiguous
    tensor of the same values first, on every device; the step's
    ``made_contiguous`` lists those leaves (``tree_leaves`` indices) of its
    last call."""

    def train_step(params, opt: AdamWState, tokens, labels):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = model.forward_train(params, tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        train_step.made_contiguous = [i for i, g in enumerate(grads) if not g.is_contiguous()]
        grads = [g.contiguous() for g in grads]
        lr = lr_schedule(opt.step, base_lr, warmup_steps, total_steps)
        params, opt, opt_metrics = adamw_update(
            grads, opt, params, lr, weight_decay=weight_decay
        )
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt, metrics

    train_step.made_contiguous = []
    return train_step


def train(
    model: Model,
    data: Iterable[Tuple[Any, Any]],
    *,
    steps: int,
    seed: int = 0,
    base_lr: float = 3e-4,
    warmup_steps: int = 100,
    weight_decay: float = 0.1,
    log_every: int = 10,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 100,
    log_fn: Callable[[str], None] = print,
    graphs: Optional[bool] = None,
) -> TrainState:
    """Train ``model`` from seeded params for ``steps`` batches of ``data``
    (each the first batch's shape). ``graphs`` picks how the step runs
    (``serving.graphs.use_graphs``): None by the device, False eager, True
    CUDA graphs (the card only; raises elsewhere)."""
    graphed = _graphs.use_graphs(model.device, graphs)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init(gen)
    opt = adamw_init(params)
    step_fn = make_train_step(
        model,
        base_lr=base_lr,
        warmup_steps=warmup_steps,
        total_steps=steps,
        weight_decay=weight_decay,
    )

    t0 = time.perf_counter()
    it = iter(data)
    prog = None
    for step in range(steps):
        tokens, labels = next(it)
        if prog is None:
            prog = _graphs.train_program(step_fn, params, opt, np.shape(tokens), model.device,
                                         graphed)
        metrics = prog.run(tokens, labels)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            log_fn(
                f"step {step:5d}  loss {loss:8.4f}  ce {float(metrics['ce']):8.4f}  "
                f"grad_norm {float(metrics['grad_norm']):7.3f}  "
                f"lr {float(metrics['lr']):.2e}  {dt:7.1f}s"
            )
        if checkpoint_path and (step + 1) % checkpoint_every == 0:
            ckpt.save_checkpoint(checkpoint_path, {"params": params, "opt": opt}, step)
    for p in tree_leaves(params):
        p.requires_grad_(False)
    if checkpoint_path:
        ckpt.save_checkpoint(checkpoint_path, {"params": params, "opt": opt}, steps - 1)
    return TrainState(params=params, opt=opt, step=steps)

"""AdamW with decoupled weight decay + warmup-cosine schedule.

The JAX package's ``repro.training.optimizer`` as pure functions over the
port's param tree (nested dicts and lists of tensors). Moments are float32
whatever the param dtype, the gradient is clipped by its global norm, and
the update is computed in float32 and cast back to each param's dtype, as
the reference does; ``torch.optim.AdamW`` on bf16 params would do the
arithmetic in bf16. Unlike the reference, ``adamw_update`` updates the
params and the moments IN PLACE (under ``torch.no_grad()``), so a
full-width step never holds a second float32 copy of the gradient tree; it
returns the same tensors.

Where the reference leaves the update to XLA's fusion, the port routes it
through ``kernels.ops`` by the device of the tensors: on the card two
hand-written launches (``kernels/adamw.py``: the global norm, then every
leaf's update in one pass), on the CPU and the meta device the plain
PyTorch version (``kernels/ref.py``), op for op what this module ran
before. Between them sit the few scalar ops of ``update_scalars``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar: updates applied so far
    mu: Params
    nu: Params


def adamw_init(params: Params) -> AdamWState:
    def zeros(p):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), p)

    some = tree_leaves(params)
    device = some[0].device if some else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(params), nu=zeros(params))


def lr_schedule(
    step: torch.Tensor,
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio * base_lr (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos


@torch.no_grad()
def adamw_update(
    grads: Params,
    state: AdamWState,
    params: Params,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping. Returns (params, state,
    metrics), the params and moments updated in place."""
    gflat = tree_leaves(grads)
    gnorm = ops.adamw_norm(gflat)
    scale, step, bc1, bc2, lr = update_scalars(gnorm, state.step, lr, b1=b1, b2=b2,
                                               grad_clip=grad_clip)
    ops.adamw_update(tree_leaves(params), gflat, tree_leaves(state.mu), tree_leaves(state.nu),
                     scale, bc1, bc2, lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}


def update_scalars(
    gnorm: torch.Tensor,
    step: torch.Tensor,
    lr: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> Tuple[torch.Tensor, ...]:
    """The scalars an update reads, from the global norm and the steps
    applied so far, as float32 tensors on the norm's device (the step
    int32): (gradient scale, new step, bc1, bc2, lr)."""
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = step + 1
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    return scale, step, bc1, bc2, lr

"""Mixture-of-experts FFN: top-k router + capacity-based dense dispatch.

Numerically the JAX package's ``repro.models.moe``: a float32 router,
softmax, top-k with renormalised gates, and the one-hot (Switch-style)
dispatch with capacity computed PER SEQUENCE, ``int(max(1, cf * S * k /
E))``: a token's slot in an expert is the number of earlier (token, choice)
pairs of its sequence, in the flattened (S * k) order, that chose that
expert, and a pair whose slot reaches the capacity is dropped. Every
expert then runs on its (capacity, d) slab of each sequence, dropped or
empty slots being zero rows, and the combine weights its outputs by the
kept gates. A shared expert (``num_shared_experts`` > 0) runs on every
token through ``layers.mlp``.

Like the reference, it calls no kernel of its own: the dispatch and combine
are products with one-hot matrices, and the expert products are batched
products over (tenant, expert).

Tensors carry a leading tenant axis, as the attention and RWKV-6 decode
code does: expert weights (R, E, d, f), tokens (R, B, S, d). A prefill
passes one tenant (R = 1); the merged decode step passes every tenant's
slots with S = 1, so capacity is computed per sequence as in the
reference's ``vmap`` over tenants.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


def param_specs(cfg: ModelConfig) -> Dict:
    """Leaves (shape, init) or (shape, init, dtype), as ``Model._fill``
    reads them; the router stays float32 in any model dtype, as in the JAX
    init."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.num_experts
    spec = {
        "router": ((d, e), "dense", torch.float32),
        "w_gate": ((e, d, f), "dense"),
        "w_up": ((e, d, f), "dense"),
        "w_down": ((e, f, d), "dense"),
    }
    if m.num_shared_experts:
        spec["shared"] = layers.mlp_specs(d, m.num_shared_experts * f, cfg.mlp_gated)
    return spec


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Slots per expert in a sequence of ``seq_len`` tokens."""
    m = cfg.moe
    return int(max(1, m.capacity_factor * seq_len * m.experts_per_token / m.num_experts))


def route(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """Router of x (R, B, S, d): (probs (R, B, S, E), top-k gates renormalised
    (R, B, S, K), the chosen experts one-hot (R, B, S, K, E), each pair's
    slot in its expert (R, B, S, K), keep mask (R, B, S, K))."""
    m = cfg.moe
    K, E = m.experts_per_token, m.num_experts
    R, B, S, _ = x.shape
    logits = torch.matmul(x.float(), p["router"][:, None])
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(ids, E).float()                      # (R, B, S, K, E)
    flat = onehot.reshape(R, B, S * K, E)
    pos = (flat.cumsum(dim=2) - flat).reshape(R, B, S, K, E)
    pos = (pos * onehot).sum(dim=-1)                        # exclusive count
    return probs, gates, onehot, pos, pos < capacity(cfg, S)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, B, S, d), weights with a leading R -> (y (R, B, S, d), aux (R,)):
    the routed experts' output (plus the shared expert's) and the Switch
    load-balance loss of each tenant, averaged over its batch and sequence."""
    m = cfg.moe
    E = m.num_experts
    R, B, S, d = x.shape
    C = capacity(cfg, S)
    probs, gates, onehot, pos, keep = route(p, x, cfg)
    tokens_per_expert = onehot.sum(dim=3).mean(dim=(1, 2))  # (R, E)
    aux = E * (tokens_per_expert * probs.mean(dim=(1, 2))).sum(dim=-1) * m.router_aux_loss_weight

    gates = gates * keep
    # slot C is past the capacity: its one-hot row is dropped below, so a
    # dropped pair dispatches nowhere (jax.nn.one_hot of C gives zeros)
    slot = torch.where(keep, pos, torch.full_like(pos, C)).long()
    pos_oh = F.one_hot(slot, C + 1)[..., :C].float()        # (R, B, S, K, C)
    expert_t = onehot.transpose(-1, -2)                     # (R, B, S, E, K)
    # each expert appears at most once among a token's k choices, so these
    # sums over k have one term: exact in any dtype
    disp = torch.matmul(expert_t, pos_oh).to(x.dtype).reshape(R, B, S, E * C)
    comb = torch.matmul(expert_t * gates[..., None, :], pos_oh).to(x.dtype)
    comb = comb.reshape(R, B, S, E * C)

    xe = torch.matmul(disp.transpose(-1, -2), x)            # (R, B, E*C, d)
    xe = xe.view(R, B, E, C, d).transpose(1, 2).reshape(R, E, B * C, d)
    if cfg.mlp_gated:
        h = F.silu(torch.matmul(xe, p["w_gate"])) * torch.matmul(xe, p["w_up"])
    else:
        h = F.gelu(torch.matmul(xe, p["w_up"]), approximate="tanh")
    ye = torch.matmul(h, p["w_down"])                       # (R, E, B*C, d)
    ye = ye.view(R, E, B, C, d).transpose(1, 2).reshape(R, B, E * C, d)
    y = torch.matmul(comb, ye)                              # (R, B, S, d)

    if m.num_shared_experts:
        y = y + layers.mlp(p["shared"], x.reshape(R, B * S, d), cfg.mlp_gated).view(R, B, S, d)
    return y, aux

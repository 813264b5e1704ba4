"""Shared primitive layers: init, RMSNorm, per-head norm, RoPE, gated MLP.

Plain functions of (params, inputs) over dicts of tensors, numerically the
JAX package's ``repro.models.layers``: weights are stored ``(d_in, d_out)``
and applied as ``x @ W``; RMSNorm takes only the variance in float32 and
normalises in the residual dtype; RoPE is the half-split form.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- init
# A stack of matrices larger than this many elements (llama4-maverick's
# experts: 128 x 5120 x 8192) is filled one matrix at a time, so the float32
# draw never needs a second copy of the whole stack.
FILL_CHUNK_ELEMENTS = 1 << 28


def truncated_normal_(out: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` in place with N(0,1) truncated to [-2, 2], times ``scale``.

    Sampled in float32 on ``out``'s device, then cast into ``out`` (the JAX
    package's ``truncated_normal(-2, 2) * scale``, drawn from a torch
    generator instead of a jax key: same distribution, other numbers).
    """
    if out.dim() > 2 and out.numel() > FILL_CHUNK_ELEMENTS:
        for part in out:
            truncated_normal_(part, scale, generator)
        return out
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
    out.copy_(tmp.mul_(scale))
    return out


def dense_init_(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``(d_in, d_out)`` projection at the JAX scale 1/sqrt(d_in)."""
    return truncated_normal_(out, 1.0 / math.sqrt(out.shape[-2]), generator)


def embed_init_(out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return truncated_normal_(out, 0.02, generator)


def uniform_(out: torch.Tensor, low: float, high: float,
             generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with U[low, high), drawn in float32 on its device."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    out.copy_(tmp.uniform_(low, high, generator=generator))
    return out


def normal_(out: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` with N(0, 1) times ``scale``, drawn in float32."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    out.copy_(tmp.normal_(0.0, 1.0, generator=generator).mul_(scale))
    return out


# --------------------------------------------------------------------------- norm
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 kept only for the variance reduction."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def groupnorm_heads(x: torch.Tensor, num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS normalisation of x (..., H*P) in float32, cast back
    (RWKV-6's ln_x over heads)."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], num_heads, shape[-1] // num_heads).float()
    out = xh * torch.rsqrt(xh.square().mean(dim=-1, keepdim=True) + eps)
    return out.reshape(shape).to(x.dtype)


# --------------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """float32 (cos, sin) of shape (..., S, D/2) for ``positions`` (..., S).

    Every layer rotates by the same positions, so a forward pass computes
    the tables once and hands them to each layer's ``apply_rope``.
    """
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding, half-split form.

    x: (..., S, D) with D even; cos/sin from ``rope_tables``, broadcastable
    to (..., S, D/2).
    """
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- mlp
def mlp_specs(d_model: int, d_ff: int, gated: bool) -> Dict:
    """``mlp``'s params as (shape, init) leaves (``Model._fill`` reads them)."""
    spec = {"up": ((d_model, d_ff), "dense"), "down": ((d_ff, d_model), "dense")}
    if gated:
        spec["gate"] = ((d_model, d_ff), "dense")
    return spec


def mlp(p: Params, x: torch.Tensor, gated: bool) -> torch.Tensor:
    """x (..., d) @ up/gate, activation, @ down.

    Weights may carry a leading tenant axis matching x's (R, B, d): the
    products are then one batched product per projection.
    """
    up = torch.matmul(x, p["up"])
    if gated:
        h = F.silu(torch.matmul(x, p["gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default form
    return torch.matmul(h, p["down"])

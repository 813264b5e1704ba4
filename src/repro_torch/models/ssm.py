"""Mamba2 (SSD) block: chunked scan for prefill, O(1) decode step.

Numerically the JAX package's ``repro.models.ssm``. The state-space
recurrence per head (state S in R^{P x N}):

    S_t = exp(A * dt_t) * S_{t-1} + dt_t * x_t (x) B_t
    y_t = S_t . C_t + D * x_t

Prefill runs the chunked (SSD) form: quadratic within a chunk, then a
sequential pass over chunks (``ops.ssd_scan``); a decode step's mixer,
from the projections to ``out_proj``'s input, is ``ops.ssd_step``. On the
card each is a hand-written kernel (``kernels/ssd.py``), elsewhere its
plain version in ``kernels/ref.py``; the reference's are jnp (no Pallas
kernel). ``plain=True`` runs the plain versions on any device.

Cache contract per layer: ``conv_x`` (B, W-1, d_inner), ``conv_B`` and
``conv_C`` (B, W-1, N), the last W-1 raw inputs of each depthwise causal
conv, in the model dtype; ``ssm`` (B, H, P, N) float32, the recurrent
state; with a leading tenant axis (R, B, ...) in a stacked cohort. As for
attention, caches are updated IN PLACE by the model.

``mamba2_forward`` takes one model's params and x (B, S, d), and continues
from ``init_cache_state`` (a previous chunk's caches) when given;
``mamba2_decode`` is one token for R tenants x B slots over tenant-stacked
params, each projection one batched product across tenants.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]

CACHE_NAMES = ("conv_x", "conv_B", "conv_C", "ssm")


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads H, channels per head P, state size N)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = s.num_ssm_heads or d_inner // s.head_dim
    return d_inner, H, s.head_dim, s.state_dim


def param_specs(cfg: ModelConfig) -> Dict:
    """Leaves (shape, init) or (shape, init, dtype), as ``Model._fill``
    reads them. z, x, B, C and dt have separate projections, and B and C
    one group of N shared by every head, as in the JAX init; ``A_log``,
    ``D`` and ``dt_bias`` stay float32."""
    d = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    W = cfg.ssm.conv_width
    return {
        "wz": ((d, d_inner), "dense"),
        "wx": ((d, d_inner), "dense"),
        "wB": ((d, N), "dense"),
        "wC": ((d, N), "dense"),
        "wdt": ((d, H), "dense"),
        "conv_x_w": ((W, d_inner), "conv"),
        "conv_x_b": ((d_inner,), "zeros"),
        "conv_B_w": ((W, N), "conv"),
        "conv_B_b": ((N,), "zeros"),
        "conv_C_w": ((W, N), "conv"),
        "conv_C_b": ((N,), "zeros"),
        "A_log": ((H,), "a_log", torch.float32),
        "D": ((H,), "ones", torch.float32),
        "dt_bias": ((H,), "zeros", torch.float32),
        "norm": ((d_inner,), "ones"),
        "out_proj": ((d_inner, d), "dense"),
    }


def cache_specs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, object]]:
    """Per-sequence cache shapes and dtypes (None: the model dtype)."""
    d_inner, H, P, N = dims(cfg)
    w = cfg.ssm.conv_width - 1
    return {"conv_x": ((w, d_inner), None), "conv_B": ((w, N), None),
            "conv_C": ((w, N), None), "ssm": ((H, P, N), torch.float32)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in float32. x (B, S, C), w (W, C) -> (B, S, C),
    contiguous.

    W shifted multiply-adds, in the order of the sum over the window: no
    cuDNN call, so nothing on the card runs it in TF32
    (``cudnn.allow_tf32``). The kernel is read as the reference lays it out,
    (C, W)."""
    W, C = w.shape
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, W - 1, 0))                  # (B, W-1+S, C)
    wt = w.float().t()                                       # (C, W)
    out = xp[:, :S] * wt[:, 0]
    for k in range(1, W):
        out = out + xp[:, k:k + S] * wt[:, k]
    return (out + b.float()).to(x.dtype)


def ssd_scan(
    xh: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)  post-softplus
    A: torch.Tensor,     # (H,)       negative
    Bm: torch.Tensor,    # (B, S, N)
    Cm: torch.Tensor,    # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B, S, H, P) in xh's dtype, final state
    (B, H, P, N) float32), by ``ops.ssd_scan``: the kernel on the card (its
    own chunk length), ``ref.ssd_scan`` at ``chunk`` elsewhere."""
    return ops.ssd_scan(xh, dt, A, Bm, Cm, chunk, init_state=init_state)


def _project(p: Params, x: torch.Tensor):
    """z, x, B, C, dt projections of x (..., d)."""
    return tuple(torch.matmul(x, p[k]) for k in ("wz", "wx", "wB", "wC", "wdt"))


def mamba2_forward(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    init_cache_state: Optional[Cache] = None,
    return_cache: bool = True,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Prefill forward of x (B, S, d) -> (out (B, S, d), the caches after
    the last token). ``init_cache_state``: a continuation, from a previous
    chunk's conv tails and SSM state (read, not written).
    ``return_cache=False`` is the train mode: from zero state, no caches
    (None in their place). ``plain``: the scan's plain version."""
    d_inner, H, P, N = dims(cfg)
    B, S, _ = x.shape
    W = cfg.ssm.conv_width
    hist = init_cache_state
    z, xs_raw, Bm_raw, Cm_raw, dt_raw = _project(p, x)

    def conv(raw, name):
        w, b = p[f"{name}_w"], p[f"{name}_b"]
        if hist is None:
            return F.silu(_causal_conv(raw, w, b))
        # prepend the previous chunk's tail, drop the warm-up outputs
        h = hist[name]
        full = _causal_conv(torch.cat([h.to(raw.dtype), raw], dim=1), w, b)
        return F.silu(full[:, h.shape[1]:, :])

    def tail(raw, name):
        a = raw if hist is None else torch.cat([hist[name].to(raw.dtype), raw], dim=1)
        t = a[:, -(W - 1):, :]
        return F.pad(t, (0, 0, W - 1 - t.shape[1], 0))

    xs = conv(xs_raw, "conv_x")
    Bm = conv(Bm_raw, "conv_B")
    Cm = conv(Cm_raw, "conv_C")
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, P)
    scan = ops.ssd_scan_plain if plain else ops.ssd_scan
    y, final_state = scan(xh, dt, A, Bm, Cm, cfg.ssm.chunk_size,
                          init_state=None if hist is None else hist["ssm"])
    y = y + p["D"][:, None] * xh.float()
    # back to the residual dtype before the gated norm, as the reference
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = layers.groupnorm_heads(y * F.silu(z), H) * p["norm"]
    out = torch.matmul(y.to(x.dtype), p["out_proj"])
    if not return_cache:
        return out, None
    cache = {"conv_x": tail(xs_raw, "conv_x"), "conv_B": tail(Bm_raw, "conv_B"),
             "conv_C": tail(Cm_raw, "conv_C"), "ssm": final_state}
    return out, cache


def mamba2_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache,
                  plain: bool = False) -> torch.Tensor:
    """One token for R tenants x B slots: x (R, B, d), params with a
    leading R, cache leaves (R, B, ...) updated in place -> out (R, B, d).
    The mixer between the projections and ``out_proj`` is one
    ``ops.ssd_step`` (``plain``: its plain version)."""
    z, xs_raw, Bm_raw, Cm_raw, dt_raw = _project(p, x)
    step = ops.ssd_step_plain if plain else ops.ssd_step
    y = step(p, cache, z, xs_raw, Bm_raw, Cm_raw, dt_raw)
    return torch.matmul(y, p["out_proj"])

"""Mamba2 (SSD) block: chunked scan for prefill, O(1) decode step.

Numerically the JAX package's ``repro.models.ssm``. The state-space
recurrence per head (state S in R^{P x N}):

    S_t = exp(A * dt_t) * S_{t-1} + dt_t * x_t (x) B_t
    y_t = S_t . C_t + D * x_t

Prefill runs the chunked (SSD) form: quadratic within a chunk, then a
sequential pass over chunks. It is plain PyTorch, as the reference's is
jnp (no Pallas kernel).

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
    """Depthwise causal conv in float32. x (B, S, C), w (W, C) -> (B, S, C)."""
    W, C = w.shape
    lhs = F.pad(x.float().transpose(1, 2), (W - 1, 0))      # (B, C, W-1+S)
    out = F.conv1d(lhs, w.float().t().unsqueeze(1), groups=C)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


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
    (B, H, P, N) float32). S is padded to a multiple of the chunk with
    dt = 0 (no decay, no input)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    Sp = -(-S // L) * L
    if Sp != S:
        pad = Sp - S
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = Sp // L

    la = (dt * A).reshape(B, nc, L, H).float()
    xbar = (xh * dt[..., None]).reshape(B, nc, L, H, P).float()
    Bc = Bm.reshape(B, nc, L, N).float()
    Cc = Cm.reshape(B, nc, L, N).float()
    cum = la.cumsum(dim=2)                                  # (B, nc, L, H)

    # intra-chunk: quadratic in L
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))         # (B, nc, L, M)
    mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()[..., None]
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B, nc, L, M, H)
    # clamp before exp: masked (l < m) entries have rel >> 0 and would overflow
    rel = torch.where(mask, rel, 0.0)
    decay = torch.where(mask, torch.exp(rel), 0.0)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores[..., None] * decay, xbar)

    # per-chunk state contribution and decay
    last = cum[:, :, -1:, :]                                # (B, nc, 1, H)
    tail = torch.exp(last - cum)[..., None] * xbar          # (B, nc, L, H, P)
    chunk_state = torch.einsum("bclhp,bcln->bchpn", tail, Bc)
    chunk_decay = torch.exp(last[:, :, 0, :])               # (B, nc, H)

    # inter-chunk sequential pass, keeping the state before each chunk
    state = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
             if init_state is None else init_state.float())
    before = []
    for c in range(nc):
        before.append(state)
        state = chunk_decay[:, c, :, None, None] * state + chunk_state[:, c]
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bcln,bchpn->bclhp", Cc, torch.stack(before, dim=1))
    y = (y_intra + y_inter).reshape(B, Sp, H, P)[:, :S]
    return y.to(xh.dtype), state


def _project(p: Params, x: torch.Tensor):
    """z, x, B, C, dt projections of x (..., d)."""
    return tuple(torch.matmul(x, p[k]) for k in ("wz", "wx", "wB", "wC", "wdt"))


def mamba2_forward(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    init_cache_state: Optional[Cache] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Prefill forward of x (B, S, d) -> (out (B, S, d), the caches after
    the last token). ``init_cache_state``: a continuation, from a previous
    chunk's conv tails and SSM state (read, not written)."""
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
    y, final_state = ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm.chunk_size,
                              init_state=None if hist is None else hist["ssm"])
    y = y + p["D"][:, None] * xh.float()
    # back to the residual dtype before the gated norm, as the reference
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = layers.groupnorm_heads(y * F.silu(z), H) * p["norm"]
    out = torch.matmul(y.to(x.dtype), p["out_proj"])
    cache = {"conv_x": tail(xs_raw, "conv_x"), "conv_B": tail(Bm_raw, "conv_B"),
             "conv_C": tail(Cm_raw, "conv_C"), "ssm": final_state}
    return out, cache


def mamba2_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache) -> torch.Tensor:
    """One token for R tenants x B slots: x (R, B, d), params with a
    leading R, cache leaves (R, B, ...) updated in place -> out (R, B, d)."""
    d_inner, H, P, N = dims(cfg)
    R, B, _ = x.shape
    z, xs_raw, Bm_raw, Cm_raw, dt_raw = _project(p, x)

    def conv_step(new, name):
        prev = cache[name]
        window = torch.cat([prev, new[:, :, None, :].to(prev.dtype)], dim=2)  # (R, B, W, C)
        w, b = p[f"{name}_w"], p[f"{name}_b"]
        out = (window.float() * w.float()[:, None]).sum(dim=2)
        out = F.silu(out + b.float()[:, None]).to(x.dtype)
        prev.copy_(window[:, :, 1:])
        return out

    xs = conv_step(xs_raw, "conv_x")
    Bm = conv_step(Bm_raw, "conv_B").float()
    Cm = conv_step(Cm_raw, "conv_C").float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"][:, None])   # (R, B, H)
    A = -torch.exp(p["A_log"])[:, None]                        # (R, 1, H)
    decay = torch.exp(dt * A)
    xh = xs.reshape(R, B, H, P).float()

    state = cache["ssm"]
    new = (decay[..., None, None] * state
           + (dt[..., None] * xh)[..., None] * Bm[:, :, None, None, :])
    state.copy_(new)
    y = torch.matmul(new, Cm[:, :, None, :, None])[..., 0]    # (R, B, H, P)
    y = y + p["D"][:, None, :, None] * xh
    y = y.reshape(R, B, d_inner)
    y = layers.groupnorm_heads(y * F.silu(z), H) * p["norm"][:, None]
    return torch.matmul(y.to(x.dtype), p["out_proj"])

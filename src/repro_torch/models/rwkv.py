"""RWKV-6 "Finch" block: time-mix (the WKV6 recurrence, K5) and channel-mix.

Numerically the JAX package's ``repro.models.rwkv``: per-token decay logits
w_t come from a small LoRA on the token-shift-mixed input, and the
recurrence runs per head of N = V = ``ssm.head_dim`` channels.

Cache contract per layer: ``wkv`` (B, H, N, N) float32, the recurrent
state; ``shift_tm`` and ``shift_cm`` (B, d), the last normalised input of
the time-mix and channel-mix (the token shift's previous token); with a
leading tenant axis (R, B, ...) in a stacked cohort. As for attention,
caches are updated IN PLACE.

``rwkv_prefill`` honours the incoming state (zero for a fresh sequence,
the previous chunk's for a continuation) and keeps the JAX prefill's two
results: the outputs of a scan with ``w`` rounded to the model dtype, and
the cache's new state rolled with float32 ``w`` (the reference's
``_wkv_final_state``; its decode step keeps ``w`` float32 too). In float32
the two coincide and one ``wkv6_scan`` launch writes the state after the
last token straight into the cache; in a narrower model dtype, by that
fixed rule (``prefill_launches``), one ``wkv6_scan`` launch gives the
outputs and leaves the cache alone, and one ``wkv6_state`` launch (the
state pass: no outputs), with float32 ``w``, writes the state in place.
``rwkv_train`` is the train mode: from a zero previous token and a zero
state, keeping no state; under autograd on the card, ``ops.wkv6_scan`` runs
K5 forward and its backward kernel. ``rwkv_decode`` is one token for R
tenants x B slots: each projection is
one batched product across tenants and ``wkv6_step`` runs once over all
R*B*H heads.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]

LORA_DIM = 64
CACHE_NAMES = ("wkv", "shift_tm", "shift_cm")


def dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(heads H, channels per head N)."""
    N = cfg.ssm.head_dim if cfg.ssm is not None else 64
    return cfg.d_model // N, N


def param_specs(cfg: ModelConfig) -> Dict:
    """Leaves (shape, init) or (shape, init, dtype); init kinds as
    ``Model._fill`` reads them. ``w_base`` and ``u`` stay float32 in any
    model dtype, as in the JAX init."""
    d = cfg.d_model
    H, N = dims(cfg)
    return {
        "mu": ((5, d), "mix"),  # token-shift mix of r, k, v, g, w
        "wr": ((d, d), "dense"),
        "wk": ((d, d), "dense"),
        "wv": ((d, d), "dense"),
        "wg": ((d, d), "dense"),
        "wo": ((d, d), "dense"),
        "w_base": ((d,), "decay_base", torch.float32),
        "w_lora_a": ((d, LORA_DIM), "dense"),
        "w_lora_b": ((LORA_DIM, d), "zeros"),
        "u": ((H, N), "bonus", torch.float32),
        "mu_ck": ((d,), "mix"),
        "mu_cr": ((d,), "mix"),
        "ck": ((d, cfg.d_ff), "dense"),
        "cv": ((cfg.d_ff, d), "dense"),
        "cr": ((d, d), "dense"),
        "norm_tm": {"scale": ((d,), "ones")},
        "norm_cm": {"scale": ((d,), "ones")},
    }


def cache_specs(cfg: ModelConfig) -> Dict[str, Tuple[tuple, object]]:
    """Per-sequence cache shapes and dtypes (None: the model dtype)."""
    H, N = dims(cfg)
    return {"wkv": ((H, N, N), torch.float32), "shift_tm": ((cfg.d_model,), None),
            "shift_cm": ((cfg.d_model,), None)}


def prefill_launches(dtype: torch.dtype) -> Dict[str, int]:
    """Calls a prefill makes per layer in model dtype ``dtype``, by op: in
    float32 one ``wkv6_scan`` (the outputs and the kept state); in a
    narrower dtype one ``wkv6_scan`` (the outputs, from w rounded to the
    dtype) and one ``wkv6_state`` (the kept state, from float32 w)."""
    if dtype == torch.float32:
        return {"wkv6_scan": 1}
    return {"wkv6_scan": 1, "wkv6_state": 1}


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, S, d); prev (B, d), the token before x[:, 0]."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _mix(x: torch.Tensor, shifted: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (shifted - x) * mu


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _per_tenant(t: torch.Tensor) -> torch.Tensor:
    """A tenant-stacked channel vector (R, d) -> (R, 1, d), over the slots."""
    return t[:, None]


def _time_mix(p: Params, x: torch.Tensor, shifted: torch.Tensor, chan: Callable):
    """r, k, v, g in x's dtype and the float32 decay logits w."""
    mu = p["mu"]
    xr, xk, xv, xg, xw = (_mix(x, shifted, chan(mu[..., i, :])) for i in range(5))
    r = torch.matmul(xr, p["wr"])
    k = torch.matmul(xk, p["wk"])
    v = torch.matmul(xv, p["wv"])
    g = F.silu(torch.matmul(xg, p["wg"]))
    lora = torch.matmul(torch.tanh(torch.matmul(xw, p["w_lora_a"])), p["w_lora_b"])
    return r, k, v, g, chan(p["w_base"]) + lora.float()


def _channel_mix(p: Params, x: torch.Tensor, shifted: torch.Tensor, chan: Callable):
    xk = _mix(x, shifted, chan(p["mu_ck"]))
    xr = _mix(x, shifted, chan(p["mu_cr"]))
    k = torch.square(F.relu(torch.matmul(xk, p["ck"])))
    return torch.matmul(k, p["cv"]) * torch.sigmoid(torch.matmul(xr, p["cr"]))


def rwkv_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache,
                 plain: bool = False) -> torch.Tensor:
    """x (B, S, d) -> the block's output (B, S, d), from the state in
    ``cache``, which ends as the state after the last token. In a narrower
    dtype than float32 the outputs' scan writes its own state into a
    scratch tensor, never into the cache, and the state pass then writes
    the kept state into ``cache["wkv"]``; both run on one stream, so the
    scan reads the incoming state first."""
    H, N = dims(cfg)
    B, S, d = x.shape
    h = layers.rmsnorm(p["norm_tm"]["scale"], x, cfg.norm_eps)
    r, k, v, g, w = _time_mix(p, h, _token_shift(h, cache["shift_tm"]), _same)

    def heads(t):  # (B, S, d) -> a (B, H, S, N) view, read by the kernel through strides
        return t.view(B, S, H, N).transpose(1, 2)

    scan = ops.wkv6_scan_plain if plain else ops.wkv6_scan
    wkv = cache["wkv"]
    if "wkv6_state" not in prefill_launches(r.dtype):  # float32: one scan, outputs and state
        o, _ = scan(heads(r), heads(k), heads(v), heads(w), p["u"],
                    init_state=wkv, final_state=wkv)
    else:  # the outputs from w rounded to r's dtype, the kept state from float32 w
        o, _ = scan(heads(r), heads(k), heads(v), heads(w.to(r.dtype)), p["u"], init_state=wkv)
        state = ops.wkv6_state_plain if plain else ops.wkv6_state
        state(heads(k), heads(v), heads(w), init_state=wkv, final_state=wkv)
    o = o.transpose(1, 2).reshape(B, S, d)
    x = x + torch.matmul(layers.groupnorm_heads(o, H) * g, p["wo"])
    cache["shift_tm"].copy_(h[:, -1])

    h = layers.rmsnorm(p["norm_cm"]["scale"], x, cfg.norm_eps)
    x = x + _channel_mix(p, h, _token_shift(h, cache["shift_cm"]), _same)
    cache["shift_cm"].copy_(h[:, -1])
    return x


def rwkv_train(p: Params, x: torch.Tensor, cfg: ModelConfig, plain: bool = False) -> torch.Tensor:
    """Train mode: x (B, S, d) -> the block's output, from a zero previous
    token and a zero WKV state, with ``w`` rounded to r's dtype as the
    reference's train path passes it; no state is kept."""
    H, N = dims(cfg)
    B, S, d = x.shape
    h = layers.rmsnorm(p["norm_tm"]["scale"], x, cfg.norm_eps)
    zero = h.new_zeros((B, d))
    r, k, v, g, w = _time_mix(p, h, _token_shift(h, zero), _same)

    def heads(t):  # (B, S, d) -> a (B, H, S, N) view
        return t.view(B, S, H, N).transpose(1, 2)

    scan = ops.wkv6_scan_plain if plain else ops.wkv6_scan
    o, _ = scan(heads(r), heads(k), heads(v), heads(w.to(r.dtype)), p["u"])
    o = o.transpose(1, 2).reshape(B, S, d)
    x = x + torch.matmul(layers.groupnorm_heads(o, H) * g, p["wo"])

    h = layers.rmsnorm(p["norm_cm"]["scale"], x, cfg.norm_eps)
    return x + _channel_mix(p, h, _token_shift(h, h.new_zeros((B, d))), _same)


def rwkv_decode(p: Params, x: torch.Tensor, cfg: ModelConfig, cache: Cache) -> torch.Tensor:
    """One token for R tenants x B slots: x (R, B, d), params with a
    leading tenant axis, cache wkv (R, B, H, N, N) and shifts (R, B, d)."""
    H, N = dims(cfg)
    R, B, d = x.shape
    h = layers.rmsnorm(p["norm_tm"]["scale"][:, None], x, cfg.norm_eps)
    r, k, v, g, w = _time_mix(p, h, cache["shift_tm"], _per_tenant)

    def heads(t):  # (R, B, d) -> (R*B*H, N)
        return t.reshape(R * B * H, N)

    u = p["u"][:, None].expand(R, B, H, N).reshape(R * B * H, N)
    state = cache["wkv"].view(R * B * H, N, N)
    new_state, o = ops.wkv6_step(state, heads(r), heads(k), heads(v), heads(w), u)
    state.copy_(new_state)
    x = x + torch.matmul(layers.groupnorm_heads(o.view(R, B, d), H) * g, p["wo"])
    cache["shift_tm"].copy_(h)

    h = layers.rmsnorm(p["norm_cm"]["scale"][:, None], x, cfg.norm_eps)
    x = x + _channel_mix(p, h, cache["shift_cm"], _per_tenant)
    cache["shift_cm"].copy_(h)
    return x

"""GQA attention block: prefill (flash kernel) and one-token decode (decode kernel).

Cache contract (the JAX package's, per layer): ``k``/``v`` of shape
``(B, Hkv, S_alloc, D)``, where ``S_alloc`` is the full sequence length
for global layers and ``min(window, S)`` for sliding-window layers (ring
buffer: position p lives in slot p % S_alloc). Keys are stored with RoPE
applied, so ring slots stay position-correct.

Unlike the JAX package, caches are updated IN PLACE: at full width a
functional update would copy every layer's cache once per token.

``plain=True`` routes attention to the plain PyTorch versions on any
device (the opt-in that holds the kernels against them on the card).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import AttentionKind, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


def cache_alloc_len(cfg: ModelConfig, kind: AttentionKind, seq_len: int) -> int:
    if kind == AttentionKind.SLIDING and cfg.sliding_window > 0:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _window(cfg: ModelConfig, kind: AttentionKind) -> int:
    return cfg.sliding_window if kind == AttentionKind.SLIDING else 0


def _flash(plain: bool):
    return ops.flash_attention_plain if plain else ops.flash_attention


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> q (B, Hq, S, D), k/v (B, Hkv, S, D), contiguous."""
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]

    def heads(t, h):
        return t.view(B, S, h, cfg.head_dim).transpose(1, 2)

    return heads(q, cfg.num_heads), heads(k, cfg.num_kv_heads), heads(v, cfg.num_kv_heads)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    B, H, S, D = o.shape
    return o.transpose(1, 2).reshape(B, S, H * D)


def attn_prefill(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: AttentionKind,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor],
    plain: bool = False,
) -> torch.Tensor:
    """Prefill of fresh sequences (positions 0..S-1) that fills the cache.

    x (B, S, d); cache_k/v (B, Hkv, S_alloc, D), written in place; rope:
    ``layers.rope_tables`` of positions 0..S-1.
    """
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    q = layers.apply_rope(q, *rope).contiguous()
    k = layers.apply_rope(k, *rope).contiguous()
    v = v.contiguous()
    o = _flash(plain)(q, k, v, causal=True, window=_window(cfg, kind))

    s_alloc = cache_k.shape[2]
    if s_alloc >= S:
        cache_k[:, :, :S] = k.to(cache_k.dtype)
        cache_v[:, :, :S] = v.to(cache_v.dtype)
    else:
        # ring buffer: keep the last s_alloc keys, position p in slot p % s_alloc
        shift = (S - s_alloc) % s_alloc
        cache_k.copy_(torch.roll(k[:, :, S - s_alloc:], shift, dims=2))
        cache_v.copy_(torch.roll(v[:, :, S - s_alloc:], shift, dims=2))
    return torch.matmul(_merge_heads(o), p["wo"])


def attn_prefill_continue(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    kind: AttentionKind,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    start: int,
    rope: Tuple[torch.Tensor, torch.Tensor],
    plain: bool = False,
) -> torch.Tensor:
    """Chunked-prefill continuation: S new tokens at absolute positions
    start..start+S-1, with ``start`` tokens already in the cache.

    Linear (non-ring) caches only: slot == position, so causal masking
    against the whole cache is exact and stale slots past start+S are never
    visible. The flash kernel takes ``q_offset = start`` at run time.
    rope: ``layers.rope_tables`` of positions start..start+S-1.
    """
    if kind == AttentionKind.SLIDING and cfg.sliding_window > 0:
        raise NotImplementedError(
            "chunked prefill is not supported for sliding-window (ring-cache) layers"
        )
    S = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    q = layers.apply_rope(q, *rope).contiguous()
    k = layers.apply_rope(k, *rope)
    cache_k[:, :, start:start + S] = k.to(cache_k.dtype)
    cache_v[:, :, start:start + S] = v.to(cache_v.dtype)
    o = _flash(plain)(q, cache_k, cache_v, causal=True, q_offset=start)
    return torch.matmul(_merge_heads(o), p["wo"])


def attn_decode(
    p: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    lengths: torch.Tensor,
    rope: Tuple[torch.Tensor, torch.Tensor],
    plain: bool = False,
) -> torch.Tensor:
    """One-token decode for R tenants x B sequences in one pass.

    x (R, B, d); weights carry a leading tenant axis (R, d_in, d_out), so
    each projection is one batched product. cache_k/v (R, B, Hkv, S_alloc,
    D), written in place; lengths (R, B) tokens already cached, which is
    each new token's position; rope: ``layers.rope_tables`` of those
    positions flattened to (R*B, 1). The (R, B) axes fold into the decode
    kernel's batch axis: one launch serves every tenant.
    """
    R, B, _ = x.shape
    N = R * B
    D = cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][:, None, :]
        k = k + p["bk"][:, None, :]
        v = v + p["bv"][:, None, :]
    pos = lengths.reshape(N)
    q = layers.apply_rope(q.view(N, cfg.num_heads, D), *rope)
    k = layers.apply_rope(k.view(N, cfg.num_kv_heads, D), *rope)
    v = v.view(N, cfg.num_kv_heads, D)

    s_alloc = cache_k.shape[3]
    kc = cache_k.view(N, cfg.num_kv_heads, s_alloc, D)
    vc = cache_v.view(N, cfg.num_kv_heads, s_alloc, D)
    rows = torch.arange(N, device=x.device)
    slot = pos % s_alloc  # ring slot (== position for global layers)
    kc[rows, :, slot] = k.to(kc.dtype)
    vc[rows, :, slot] = v.to(vc.dtype)

    live = torch.clamp(pos + 1, max=s_alloc).to(torch.int32)
    attend = ops.decode_attention_plain if plain else ops.decode_attention
    o = attend(q.contiguous(), kc, vc, live)
    return torch.matmul(o.view(R, B, cfg.num_heads * D), p["wo"])


def attn_param_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.head_dim
    shapes = {
        "wq": (d, cfg.num_heads * hd),
        "wk": (d, cfg.num_kv_heads * hd),
        "wv": (d, cfg.num_kv_heads * hd),
        "wo": (cfg.num_heads * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.num_heads * hd,), bk=(cfg.num_kv_heads * hd,),
                      bv=(cfg.num_kv_heads * hd,))
    return shapes

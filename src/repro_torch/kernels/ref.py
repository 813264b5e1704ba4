"""Plain PyTorch versions of the GEMM, attention and WKV6 kernels.

These are the semantic ground truth the CUDA kernels are held against on
the card, and what ``ops`` runs for tensors that lie on the CPU. They
follow the TPU kernels' semantics, including one point where the JAX
package's own jnp oracle differs: a query row whose every key is masked
(a length-0 decode row, a window that excludes every key) yields 0, not
the uniform average a finite ``NEG_INF`` softmax would give.

All arithmetic is float32 with TF32 off, whatever the input dtype; the
output is cast back to the input dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


@contextlib.contextmanager
def _full_f32():
    """Matrix products in true float32 (TF32 off) for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[r] = x[r] @ w[r]; x (R,M,K), w (R,K,N)."""
    with _full_f32():
        return torch.matmul(x.float(), w.float()).to(x.dtype)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_groups, bm: int) -> torch.Tensor:
    """out[i-th row block] = x_block @ w[block_groups[i]]; x (T,K), w (G,K,N)."""
    T, K = x.shape
    idx = torch.as_tensor(block_groups).to(device=w.device, dtype=torch.long)
    with _full_f32():
        xb = x.reshape(T // bm, bm, K).float()
        out = torch.matmul(xb, w.float()[idx])
    return out.reshape(T, -1).to(x.dtype)


def _mask(sq: int, skv: int, q_offset: int, causal: bool, window: int,
          kv_start: int, device) -> torch.Tensor:
    """(Sq, C) bool: key positions kv_start..kv_start+C visible to each query."""
    q_pos = torch.arange(sq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_start, kv_start + skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    return mask


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over masked keys, 0 for a row with no visible key."""
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v)
    return o / torch.where(l == 0.0, 1.0, l)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Dense attention. q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    q_offset: absolute position of the first query (default Skv - Sq:
    queries are the suffix).
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    if q_offset is None:
        q_offset = Skv - Sq
    with _full_f32():
        qg = q.reshape(B, Hkv, g, Sq, D).float()
        s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        mask = _mask(Sq, Skv, int(q_offset), causal, window, 0, q.device)
        o = _masked_softmax_av(s, mask, v.float()[:, :, None])
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    kv_chunk: int = 1024,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """O(S)-memory attention: a loop over KV chunks with an online softmax.

    Semantics identical to ``attention``; used for long key ranges where
    the dense (B,H,Sq,Skv) score tensor would not fit.
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    if q_offset is None:
        q_offset = Skv - Sq
    C = min(kv_chunk, Skv)
    with _full_f32():
        qg = q.reshape(B, Hkv, g, Sq, D).float() * scale
        m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, g, Sq, 1), device=q.device)
        acc = torch.zeros((B, Hkv, g, Sq, D), device=q.device)
        for c0 in range(0, Skv, C):
            kb = k[:, :, c0:c0 + C].float()[:, :, None]
            vb = v[:, :, c0:c0 + C].float()[:, :, None]
            s = torch.matmul(qg, kb.transpose(-1, -2))
            if logit_softcap > 0.0:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            mask = _mask(Sq, kb.shape[-2], int(q_offset), causal, window, c0, q.device)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_new
        out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode. q (B,Hq,D), caches (B,Hkv,S,D), lengths (B,)."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    with _full_f32():
        qg = q.reshape(B, Hkv, g, 1, D).float()
        s = torch.matmul(qg, k_cache.float()[:, :, None].transpose(-1, -2)) * scale
        live = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
        mask = live[:, None, None, None, :]  # (B,1,1,1,S)
        o = _masked_softmax_av(s, mask, v_cache.float()[:, :, None])
    return o.reshape(B, Hq, D).to(q.dtype)


def _bonus_rows(u: torch.Tensor, bh: int) -> torch.Tensor:
    """u (H, N) or (BH, N) -> float32 (BH, N): row bh is u[bh % rows]."""
    return u.float().repeat(bh // u.shape[0], 1)


def wkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6 scan in float32.

    r, k, w (..., T, N) and v (..., T, V), with leading dims (BH,) or
    (B, H); u (H, N) or (BH, N); init_state (BH, N, V) or None (zero).
    Per head: o_t = r_t (S + diag(u) k_t^T v_t), then S = diag(exp(-exp(w_t)))
    S + k_t^T v_t. Returns (out (..., T, V) in r's dtype, the float32 (BH,
    N, V) state after step T). k_t^T v_t is taken in float32 from the
    inputs, as the JAX package's decode step and final-state scan take it.
    """
    lead = r.shape[:-2]
    T, N = r.shape[-2:]
    V = v.shape[-1]
    bh = math.prod(lead)
    rf = r.reshape(bh, T, N).float()
    kf = k.reshape(bh, T, N).float()
    vf = v.reshape(bh, T, V).float()
    decay = torch.exp(-torch.exp(w.reshape(bh, T, N).float()))
    uf = _bonus_rows(u, bh)[:, :, None]
    if init_state is None:
        state = torch.zeros((bh, N, V), dtype=torch.float32, device=r.device)
    else:
        state = init_state.reshape(bh, N, V).float().clone()
    out = torch.empty((bh, T, V), dtype=torch.float32, device=r.device)
    with _full_f32():
        for t in range(T):
            kv = kf[:, t, :, None] * vf[:, t, None, :]
            out[:, t] = torch.matmul(rf[:, t, None, :], state + uf * kv)[:, 0]
            state = decay[:, t, :, None] * state + kv
    return out.reshape(*lead, T, V).to(r.dtype), state


def wkv6_step(
    state: torch.Tensor,
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of WKV6: state (BH, N, V) float32; r, k, w (BH, N);
    v (BH, V); u (H, N) or (BH, N). Returns (new state, out (BH, V) in r's
    dtype)."""
    decay = torch.exp(-torch.exp(w.float()))
    kv = k.float()[:, :, None] * v.float()[:, None, :]
    uf = _bonus_rows(u, r.shape[0])[:, :, None]
    with _full_f32():
        out = torch.matmul(r.float()[:, None, :], state + uf * kv)[:, 0]
    return decay[:, :, None] * state + kv, out.to(r.dtype)

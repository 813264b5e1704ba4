"""Plain PyTorch versions of the GEMM, attention, WKV6, AdamW and SSD kernels.

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
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

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


Offset = Union[int, torch.Tensor]


def _offset(q_offset: Offset) -> Offset:
    """A host offset as an int; a 0-dim integer tensor (K4's offset read on
    the device) as it is, so that no value leaves the device."""
    return q_offset if isinstance(q_offset, torch.Tensor) else int(q_offset)


def _mask(sq: int, skv: int, q_offset: Offset, causal: bool, window: int,
          kv_start: int, device) -> torch.Tensor:
    """(Sq, C) bool: key positions kv_start..kv_start+C visible to each
    query; ``q_offset`` a host int or a 0-dim tensor on ``device``."""
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
    q_offset: Optional[Offset] = None,
) -> torch.Tensor:
    """Dense attention. q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    q_offset: absolute position of the first query (default Skv - Sq:
    queries are the suffix), a host int or a 0-dim integer tensor on q's
    device (what a captured prefill passes).
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
        mask = _mask(Sq, Skv, _offset(q_offset), causal, window, 0, q.device)
        o = _masked_softmax_av(s, mask, v.float()[:, :, None])
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled visible scores, float32
    (B,Hq,Sq); +inf for a row with no visible key (so exp(s - lse) is 0
    there). What K4's wgmma forward writes into its ``lse`` buffer."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    if q_offset is None:
        q_offset = Skv - Sq
    with _full_f32():
        qg = q.reshape(B, Hkv, g, Sq, D).float()
        s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
        mask = _mask(Sq, Skv, _offset(q_offset), causal, window, 0, q.device)
        lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, math.inf)
    return lse.reshape(B, Hq, Sq)


def attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``attention`` (Sq == Skv, queries at positions 0..S-1)
    by the explicit formulas, in float32: recompute P; delta = rowsum(dO o O);
    dV = P^T dO; dS = P o (dO V^T - delta); dQ = dS K scale; dK = dS^T Q
    scale. ``o`` is the forward's output as the caller holds it (rounded to
    its dtype). Under GQA, dK and dV sum over each kv head's group of query
    heads. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    with _full_f32():
        qg = q.reshape(B, Hkv, g, Sq, D).float()
        kf = k.float()[:, :, None]
        vf = v.float()[:, :, None]
        dog = do.reshape(B, Hkv, g, Sq, D).float()
        s = torch.matmul(qg, kf.transpose(-1, -2)) * scale
        mask = _mask(Sq, Skv, 0, causal, window, 0, q.device)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        p = p / torch.where(l == 0.0, 1.0, l)
        delta = (dog * o.reshape(B, Hkv, g, Sq, D).float()).sum(dim=-1, keepdim=True)
        dv = torch.matmul(p.transpose(-1, -2), dog).sum(dim=2)
        ds = p * (torch.matmul(dog, vf.transpose(-1, -2)) - delta)
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


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
    q_offset: Optional[Offset] = None,
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
            mask = _mask(Sq, kb.shape[-2], _offset(q_offset), causal, window, c0, q.device)
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
    if r.device.type == "meta":
        # Meta tensors carry no values, so nothing orders the T steps: each
        # op of the step runs once over all T steps' rows, the same
        # arithmetic as the loop below (T times one step's elements) in
        # one dispatch, which is what a count on the meta device reads.
        kv = kf[..., None] * vf[..., None, :]                           # (bh, T, N, V)
        out = torch.matmul(rf[:, :, None, :], state[:, None] + uf[:, None] * kv)[:, :, 0]
        state = (decay[..., None] * state[:, None] + kv)[:, -1]
        return out.reshape(*lead, T, V).to(r.dtype), state
    out = torch.empty((bh, T, V), dtype=torch.float32, device=r.device)
    with _full_f32():
        for t in range(T):
            kv = kf[:, t, :, None] * vf[:, t, None, :]
            out[:, t] = torch.matmul(rf[:, t, None, :], state + uf * kv)[:, 0]
            state = decay[:, t, :, None] * state + kv
    return out.reshape(*lead, T, V).to(r.dtype), state


def wkv6_state(
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The WKV6 state after step T, with no outputs: the JAX package's
    ``_wkv_final_state`` (``repro.models.rwkv``), which a bf16 prefill keeps.

    k, w (..., T, N) and v (..., T, V), leading dims (BH,) or (B, H); w
    float32 in the model's use; init_state (BH, N, V) or None (zero). In
    the reference's order, in float32: decay = exp(-exp(w_t)), kv = k_t^T
    v_t, S = decay[..., None] * S + kv. Returns the float32 (BH, N, V) state.
    """
    T, N = k.shape[-2:]
    V = v.shape[-1]
    bh = math.prod(k.shape[:-2])
    kf = k.reshape(bh, T, N).float()
    vf = v.reshape(bh, T, V).float()
    decay = torch.exp(-torch.exp(w.reshape(bh, T, N).float()))
    if init_state is None:
        state = torch.zeros((bh, N, V), dtype=torch.float32, device=k.device)
    else:
        state = init_state.reshape(bh, N, V).float().clone()
    if k.device.type == "meta":
        # as in ``wkv6_scan``: the T steps' arithmetic in one dispatch
        kv = kf[..., None] * vf[..., None, :]                           # (bh, T, N, V)
        return (decay[..., None] * state[:, None] + kv)[:, -1]
    with _full_f32():
        for t in range(T):
            kv = kf[:, t, :, None] * vf[:, t, None, :]
            state = decay[:, t, :, None] * state + kv
    return state


def wkv6_chunk_states(
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    chunk: int = 16,
) -> torch.Tensor:
    """The float32 state entering each ``chunk``-step chunk of a scan from a
    zero state: (BH, ceil(T / chunk), N, V), entry c the state after steps
    0 .. chunk * c - 1. k, w (..., T, N) and v (..., T, V) as ``wkv6_scan``
    takes them. What K5's chunked forward writes into its ``ckpt`` buffer."""
    T, N = k.shape[-2:]
    V = v.shape[-1]
    bh = math.prod(k.shape[:-2])
    kf = k.reshape(bh, T, N).float()
    vf = v.reshape(bh, T, V).float()
    decay = torch.exp(-torch.exp(w.reshape(bh, T, N).float()))
    out = torch.empty((bh, -(-T // chunk), N, V), dtype=torch.float32, device=k.device)
    state = torch.zeros((bh, N, V), dtype=torch.float32, device=k.device)
    for t in range(T):
        if t % chunk == 0:
            out[:, t // chunk] = state
        state = decay[:, t, :, None] * state + kf[:, t, :, None] * vf[:, t, None, :]
    return out


def wkv6_scan_bwd(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``wkv6_scan`` from a zero initial state, with no
    gradient into the final state (training keeps none), in float32.

    With d_t = exp(-exp(w_t)), S_t the state after step t and G_t = dL/dS_t
    (G_T = 0, G_{t-1} = diag(d_t) G_t + r_t^T do_t):
      dr_t[i] = sum_j (S_{t-1}[i,j] + u_i k_t[i] v_t[j]) do_t[j]
      dk_t[i] = sum_j G_t[i,j] v_t[j] + u_i r_t[i] (v_t . do_t)
      dv_t[j] = sum_i G_t[i,j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]
      dw_t[i] = -exp(w_t[i]) d_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
      du[i]   = sum_t r_t[i] k_t[i] (v_t . do_t), summed over the rows that
                share u's row (u (H, N) broadcast over the batch).
    The states S_{t-1} come from a forward pass that keeps them all. Returns
    (dr, dk, dv, dw, du) in the dtypes and shapes of (r, k, v, w, u)."""
    lead = r.shape[:-2]
    T, N = r.shape[-2:]
    V = v.shape[-1]
    bh = math.prod(lead)
    rf = r.reshape(bh, T, N).float()
    kf = k.reshape(bh, T, N).float()
    vf = v.reshape(bh, T, V).float()
    dof = do.reshape(bh, T, V).float()
    ew = torch.exp(w.reshape(bh, T, N).float())
    decay = torch.exp(-ew)
    uf = _bonus_rows(u, bh)
    states = torch.empty((T, bh, N, V), dtype=torch.float32, device=r.device)
    state = torch.zeros((bh, N, V), dtype=torch.float32, device=r.device)
    for t in range(T):
        states[t] = state
        state = decay[:, t, :, None] * state + kf[:, t, :, None] * vf[:, t, None, :]
    dr, dk, dw = (torch.empty((bh, T, N), device=r.device) for _ in range(3))
    dv = torch.empty((bh, T, V), device=r.device)
    du = torch.zeros((bh, N), device=r.device)
    grad = torch.zeros((bh, N, V), dtype=torch.float32, device=r.device)
    with _full_f32():
        for t in range(T - 1, -1, -1):
            r_t, k_t, v_t, do_t = rf[:, t], kf[:, t], vf[:, t], dof[:, t]
            vdo = (v_t * do_t).sum(dim=-1, keepdim=True)                  # (bh, 1)
            dr[:, t] = torch.matmul(states[t], do_t[:, :, None])[..., 0] + uf * k_t * vdo
            dk[:, t] = torch.matmul(grad, v_t[:, :, None])[..., 0] + uf * r_t * vdo
            ruk = (r_t * uf * k_t).sum(dim=-1, keepdim=True)
            dv[:, t] = torch.matmul(k_t[:, None, :], grad)[:, 0] + ruk * do_t
            dw[:, t] = -ew[:, t] * decay[:, t] * (grad * states[t]).sum(dim=-1)
            du += r_t * k_t * vdo
            grad = decay[:, t, :, None] * grad + r_t[:, :, None] * do_t[:, None, :]
    du = du.reshape(bh // u.shape[0], u.shape[0], N).sum(dim=0)
    return (dr.reshape(r.shape).to(r.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype), dw.reshape(w.shape).to(w.dtype), du.to(u.dtype))


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


def adamw_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of ``grads`` in float32: each leaf's sum of
    squares, the leaves' sums added in order, then the square root."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


@torch.no_grad()
def adamw_update(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    mus: Sequence[torch.Tensor],
    nus: Sequence[torch.Tensor],
    scale: torch.Tensor,
    bc1: torch.Tensor,
    bc2: torch.Tensor,
    lr: torch.Tensor,
    *,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
) -> None:
    """AdamW's update of each leaf IN PLACE, in float32 whatever the param
    dtype (the JAX package's ``adamw_update`` past its norm): the gradient
    scaled by ``scale``, the moments ``mus``/``nus`` (float32) advanced, the
    param moved by ``lr`` times the bias-corrected step plus decoupled
    weight decay and rounded back to its dtype. ``scale``, ``bc1``, ``bc2``
    and ``lr`` are float32 scalar tensors."""
    for p, g, m, v in zip(params, grads, mus, nus):
        g32 = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        p.copy_(p32 - lr * delta)


def ssd_scan(
    xh: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)  post-softplus
    A: torch.Tensor,     # (H,)       negative
    Bm: torch.Tensor,    # (B, S, N)
    Cm: torch.Tensor,    # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's chunked SSD scan (the JAX package's jnp ``ssd_scan``) ->
    (y (B, S, H, P) in xh's dtype, final state (B, H, P, N) float32). S is
    padded to a multiple of the chunk with dt = 0 (no decay, no input)."""
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

    with _full_f32():
        # intra-chunk: quadratic in L
        scores = torch.matmul(Cc, Bc.transpose(-1, -2))     # (B, nc, L, M)
        mask = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()[..., None]
        rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, L, M, H)
        # clamp before exp: masked (l < m) entries have rel >> 0 and would overflow
        rel = torch.where(mask, rel, 0.0)
        decay = torch.where(mask, torch.exp(rel), 0.0)
        y_intra = torch.einsum("bclmh,bcmhp->bclhp", scores[..., None] * decay, xbar)

        # per-chunk state contribution and decay
        last = cum[:, :, -1:, :]                            # (B, nc, 1, H)
        tail = torch.exp(last - cum)[..., None] * xbar      # (B, nc, L, H, P)
        chunk_state = torch.einsum("bclhp,bcln->bchpn", tail, Bc)
        chunk_decay = torch.exp(last[:, :, 0, :])           # (B, nc, H)

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


SSD_NORM_EPS = 1e-6  # the per-head RMS norm's (the reference's groupnorm_heads default)


def ssd_step(
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    z: torch.Tensor,
    xs: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """Mamba2's decode mixer for R tenants x B slots, from the projections
    to ``out_proj``'s input (the JAX package's jnp ``mamba2_decode``
    between them): z, xs (R, B, d_inner), Bm, Cm (R, B, N), dt (R, B, H)
    raw, all in the model dtype; ``p`` the tenant-stacked params (leading R:
    the conv weights and biases, A_log, D, dt_bias, norm); ``cache``'s ``conv_x`` (R, B, W-1, d_inner), ``conv_B``,
    ``conv_C`` (R, B, W-1, N) and ``ssm`` (R, B, H, P, N) float32, updated
    IN PLACE (each conv window shifted by the new input, the state
    advanced). Returns y (R, B, d_inner) in the model dtype: the conv
    outputs rounded to it, silu(z) in it, the gated and normed output
    rounded once."""
    R, B, d_inner = z.shape
    H = p["A_log"].shape[-1]
    P = d_inner // H
    dtype = z.dtype

    def conv_step(new, name):
        prev = cache[name]
        window = torch.cat([prev, new[:, :, None, :].to(prev.dtype)], dim=2)  # (R, B, W, C)
        w, b = p[f"{name}_w"], p[f"{name}_b"]
        out = (window.float() * w.float()[:, None]).sum(dim=2)
        out = F.silu(out + b.float()[:, None]).to(dtype)
        prev.copy_(window[:, :, 1:])
        return out

    xc = conv_step(xs, "conv_x")
    Bc = conv_step(Bm, "conv_B").float()
    Cc = conv_step(Cm, "conv_C").float()
    dts = F.softplus(dt.float() + p["dt_bias"][:, None])      # (R, B, H)
    A = -torch.exp(p["A_log"])[:, None]                        # (R, 1, H)
    decay = torch.exp(dts * A)
    xh = xc.reshape(R, B, H, P).float()

    state = cache["ssm"]
    new = (decay[..., None, None] * state
           + (dts[..., None] * xh)[..., None] * Bc[:, :, None, None, :])
    state.copy_(new)
    with _full_f32():
        y = torch.matmul(new, Cc[:, :, None, :, None])[..., 0]  # (R, B, H, P)
    y = y + p["D"][:, None, :, None] * xh
    g = (y.reshape(R, B, d_inner) * F.silu(z)).reshape(R, B, H, P)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + SSD_NORM_EPS)
    return (g.reshape(R, B, d_inner) * p["norm"][:, None]).to(dtype)

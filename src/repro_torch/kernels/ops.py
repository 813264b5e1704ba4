"""Dispatch layer over the GEMM, attention, WKV6, AdamW and SSD kernels.

Routing is by the device of the tensors, never by a fallback: a CUDA
tensor goes to the hand-written kernel (which raises on anything it does
not take), a CPU or meta tensor to the plain PyTorch version in ``ref``
(the meta device is the dry run's: shapes and counts, no values). The
``*_plain`` entry points run the plain version on any device; they are the
explicit opt-in the model's plain path (tests, ``chip_smoke.py``) uses to
hold the kernels against it on the card.

Each op keeps an ``OpCounter`` (``COUNTERS``): ``launches`` counts kernel
launches (incremented by the kernel wrapper, where it launches) and
``plain_calls`` counts calls of the plain version. Under CUDA graphs
(``serving.graphs``) a capture counts nothing and each replay counts the
graph's launches again (``capturing``, ``replayed``), so the counts stay
those of the kernels that ran.

Training. ``flash_attention`` and ``wkv6_scan`` on CUDA tensors, when
autograd is recording (``torch.is_grad_enabled()``) and an input
``requires_grad``, go through a ``torch.autograd.Function`` whose forward
launches the same K4 or K5 kernel and whose backward launches the op's
backward kernel (``flash_attention_bwd``, ``wkv6_scan_bwd``; counted under
``COUNTERS["flash_attention_bwd"]`` and ``["wkv6_scan_bwd"]``). The route
is decided before any launch: a call the backward kernel does not take
raises there, never drops to the plain version. On that route the forward
also hands its backward what it already computes: K4's wgmma kernel each
row's log-sum-exp (``lse``, when ``flash_attention.bwd_variant`` picks the
wgmma backward), K5's chunked kernel the state entering each 16-step chunk
(``ckpt``); both are saved for the backward. Otherwise the forward kernel
is launched directly, as for serving, and writes neither. On the CPU
autograd differentiates the plain versions.

The optimizer. ``adamw_norm`` (a tree's global gradient norm) and
``adamw_update`` (every leaf's AdamW update in place, given the scale,
bias corrections and lr as device scalars) replace no Pallas kernel: the
JAX package's ``adamw_update`` is jnp that XLA fuses. On CUDA tensors they
launch ``kernels/adamw.py``'s two kernels (``COUNTERS["adamw_norm"]``,
``["adamw_update"]``, one launch a pack of leaves); on the CPU and the meta
device the plain versions, ``ref.adamw_norm`` and ``ref.adamw_update``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import batched_gemm as _bg
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import wkv6_scan as _wkv
from repro_torch.kernels import wkv6_state as _wks

COUNTERS: Dict[str, _build.OpCounter] = {
    "decode_attention": _da.counter,
    "flash_attention": _fa.counter,
    "batched_gemm": _bg.counter,
    "grouped_gemm": _gg.counter,
    "wkv6_scan": _wkv.counter,
    "wkv6_state": _wks.counter,
    "flash_attention_bwd": _fa.bwd_counter,
    "wkv6_scan_bwd": _wkv.bwd_counter,
    "adamw_norm": _aw.norm_counter,
    "adamw_update": _aw.counter,
    "ssd_scan": _ssd.scan_counter,
    "ssd_step": _ssd.step_counter,
}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, _build.OpCounter]]:
    """Count the ops called inside as a CUDA graph's: a wrapper called
    while a graph is captured counts a launch that is recorded, not run.
    On exit those counts are taken back out of ``COUNTERS`` and left in the
    yielded dict (per op that counted, what the graph launches at each
    replay); ``replayed`` adds them back once per replay. Counters are
    process-wide: no other thread may launch while a graph is captured."""
    before = {name: c.copy() for name, c in COUNTERS.items()}
    captured: Dict[str, _build.OpCounter] = {}
    try:
        yield captured
    finally:
        for name, c in COUNTERS.items():
            d = c.since(before[name])
            if d.launches or d.plain_calls:
                captured[name] = d
                c.add(d, -1)


def replayed(captured: Dict[str, _build.OpCounter], times: int = 1) -> None:
    """Count ``times`` replays of a graph whose ``capturing`` dict is
    ``captured``."""
    for name, d in captured.items():
        COUNTERS[name].add(d, times)


def _grad_needed(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _FlashAttention(torch.autograd.Function):
    """K4 forward, K4's backward kernel for the gradient (Sq == Skv, q_offset
    0); the forward's row log-sum-exp saved where the backward reads it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        lse = None
        if _fa.bwd_variant(q.dtype, q.shape[-1]) == "wgmma":
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale, q_offset=0,
                                lse=lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **ctx.opts)
        return dq, dk, dv, None, None, None


class _WKV6Scan(torch.autograd.Function):
    """K5 forward from a zero state, its backward kernel for the gradient;
    the final state is returned but carries no gradient. The forward's
    chunk-entry states are saved for the backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        T, N = r.shape[-2:]
        shape = _wkv.chunk_states_shape(r.shape[:-2].numel(), T, N, v.shape[-1])
        ckpt = torch.empty(shape, dtype=torch.float32, device=r.device)
        out, state = _wkv.wkv6_scan(r, k, v, w, u, ckpt=ckpt)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.mark_non_differentiable(state)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        del dstate  # training keeps no state: nothing flows back through it
        r, k, v, w, u, ckpt = ctx.saved_tensors
        return _wkv.wkv6_scan_bwd(r, k, v, w, u, dout, ckpt=ckpt)


PLAIN_DEVICES = ("cpu", "meta")  # device types whose tensors go to the plain versions


def _check_plain_device(t: torch.Tensor, op: str) -> None:
    if t.device.type not in PLAIN_DEVICES:
        raise ValueError(f"{op}: no kernel for device {t.device}")


def batched_gemm_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of ``batched_gemm``, on any device."""
    _bg.counter.plain_calls += 1
    return ref.batched_gemm(x, w)


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Space-time super-kernel: out[r] = x[r] @ w[r].

    The JAX op's ``bm/bn/bk`` keywords size TPU VMEM tiles and nothing in
    the scheduler passes them; the CUDA kernel fixes its own tile, so the
    port drops them.
    """
    if x.is_cuda:
        return _bg.batched_gemm(x, w)
    _check_plain_device(x, "batched_gemm")
    return batched_gemm_plain(x, w)


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor, block_groups, *,
                       bm: int = _gg.DEFAULT_BM) -> torch.Tensor:
    """The plain version of ``grouped_gemm``, on any device."""
    _gg.counter.plain_calls += 1
    return ref.grouped_gemm(x, w, block_groups, bm)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_groups, *,
                 bm: int = _gg.DEFAULT_BM) -> torch.Tensor:
    """Ragged super-kernel: row block i of x times w[block_groups[i]].

    ``bm`` is the row block, which fixes which rows share a weight; the
    JAX op's ``bn/bk`` tiling keywords are dropped, as for ``batched_gemm``.
    """
    if x.is_cuda:
        return _gg.grouped_gemm(x, w, block_groups, bm)
    _check_plain_device(x, "grouped_gemm")
    return grouped_gemm_plain(x, w, block_groups, bm=bm)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """The plain version of ``flash_attention``, on any device."""
    _fa.counter.plain_calls += 1
    # dense for short key ranges; beyond, the chunked online softmax keeps
    # memory O(S) (a (B,H,S,S) score tensor at long context does not fit)
    fn = ref.attention_chunked if k.shape[2] > 2048 else ref.attention
    return fn(q, k, v, causal=causal, window=window, scale=scale,
              logit_softcap=logit_softcap, q_offset=q_offset)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """Prefill attention (GQA, causal, optional sliding window, q_offset: a
    host int, or a 0-dim int64 tensor on the tensors' device that K4 and the
    plain version read there)."""
    if not q.is_cuda:
        _check_plain_device(q, "flash_attention")
    if flash_attention_route(q.is_cuda, logit_softcap) == "kernel":
        if _grad_needed(q, k, v):
            _fa.check_bwd(q, k, q_offset=q_offset)
            return _FlashAttention.apply(q, k, v, causal, window, scale)
        return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                   q_offset=q_offset)
    return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                 logit_softcap=logit_softcap, q_offset=q_offset)


def flash_attention_route(is_cuda: bool, logit_softcap: float) -> str:
    """Where ``flash_attention`` sends a call, decided before any launch:
    "kernel" (K4) for CUDA tensors without an attention softcap, else
    "plain". The reference's op sends ``logit_softcap != 0`` to its jnp
    path, as the Pallas kernel (and K4) computes no softcap; this is that
    op-level rule, not a fallback (K4's wrapper raises on a softcap)."""
    return "kernel" if is_cuda and logit_softcap == 0.0 else "plain"


def decode_attention_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain version of ``decode_attention``, on any device."""
    _da.counter.plain_calls += 1
    return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode against a KV cache."""
    if q.is_cuda:
        return _da.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
    _check_plain_device(q, "decode_attention")
    return decode_attention_plain(q, k_cache, v_cache, lengths, scale=scale)


def wkv6_scan_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``wkv6_scan``, on any device."""
    _wkv.counter.plain_calls += 1
    out, state = ref.wkv6_scan(r, k, v, w, u, init_state)
    if final_state is None:
        return out, state
    return out, final_state.copy_(state.view(final_state.shape))


def wkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence over a whole sequence, from ``init_state`` (zero if
    None); returns (outputs, the state after the last step), the state
    written into ``final_state`` when given (it may be ``init_state``).

    The JAX op's ``chunk`` keyword sizes the TPU kernel's VMEM blocks (and
    pads T to it); the CUDA kernel stages its own chunks and stops at T.
    """
    if r.is_cuda:
        if _grad_needed(r, k, v, w, u):
            _wkv.check_bwd(r, v, init_state, final_state)
            return _WKV6Scan.apply(r, k, v, w, u)
        return _wkv.wkv6_scan(r, k, v, w, u, init_state, final_state)
    _check_plain_device(r, "wkv6_scan")
    return wkv6_scan_plain(r, k, v, w, u, init_state, final_state)


def wkv6_state_plain(
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of ``wkv6_state``, on any device."""
    _wks.counter.plain_calls += 1
    state = ref.wkv6_state(k, v, w, init_state)
    if final_state is None:
        return state
    return final_state.copy_(state.view(final_state.shape))


def wkv6_state(
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The RWKV-6 state after the last step, with no outputs (the JAX
    package's ``_wkv_final_state``): from ``init_state`` (zero if None),
    written into ``final_state`` when given (it may be ``init_state``)."""
    if k.is_cuda:
        return _wks.wkv6_state(k, v, w, init_state, final_state)
    _check_plain_device(k, "wkv6_state")
    return wkv6_state_plain(k, v, w, init_state, final_state)


def adamw_norm_plain(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The plain version of ``adamw_norm``, on any device."""
    _aw.norm_counter.plain_calls += 1
    return ref.adamw_norm(grads)


def adamw_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 global L2 norm of a tree's gradients (its leaves, in
    order), as a 0-dim tensor on their device."""
    if grads and grads[0].is_cuda:
        return _aw.norm(grads)
    if grads:
        _check_plain_device(grads[0], "adamw_norm")
    return adamw_norm_plain(grads)


def adamw_update_plain(params, grads, mus, nus, scale, bc1, bc2, lr, *, b1: float, b2: float,
                       eps: float, weight_decay: float) -> None:
    """The plain version of ``adamw_update``, on any device."""
    _aw.counter.plain_calls += 1
    ref.adamw_update(params, grads, mus, nus, scale, bc1, bc2, lr, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay)


def adamw_update(params, grads, mus, nus, scale, bc1, bc2, lr, *, b1: float, b2: float,
                 eps: float, weight_decay: float) -> None:
    """AdamW's update of a tree's leaves (lists of params, gradients and
    float32 moments) IN PLACE, given the gradient scale, the bias
    corrections and the lr as float32 scalar tensors on their device."""
    if params and params[0].is_cuda:
        return _aw.update(params, grads, mus, nus, scale, bc1, bc2, lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)
    if params:
        _check_plain_device(params[0], "adamw_update")
    return adamw_update_plain(params, grads, mus, nus, scale, bc1, bc2, lr, b1=b1, b2=b2,
                              eps=eps, weight_decay=weight_decay)


def ssd_scan_plain(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``ssd_scan``, on any device."""
    _ssd.scan_counter.plain_calls += 1
    return ref.ssd_scan(xh, dt, A, Bm, Cm, chunk, init_state)


def ssd_scan(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2's chunked SSD scan: xh (B, S, H, P), dt (B, S, H) post-softplus,
    A (H,), Bm and Cm (B, S, N), from ``init_state`` (B, H, P, N) float32
    (zero if None) -> (y (B, S, H, P) in xh's dtype, the final state float32).
    ``chunk`` is the model's (the plain version's); the kernel takes its
    own (``ssd.CHUNK``)."""
    if not xh.is_cuda:
        _check_plain_device(xh, "ssd_scan")
    if _ssd.scan_route(xh.is_cuda, _grad_needed(xh, dt, A, Bm, Cm)) == "kernel":
        return _ssd.ssd_scan(xh, dt, A, Bm, Cm, init_state)
    return ssd_scan_plain(xh, dt, A, Bm, Cm, chunk, init_state)


def ssd_step_plain(p, cache, z, xs, Bm, Cm, dt) -> torch.Tensor:
    """The plain version of ``ssd_step``, on any device."""
    _ssd.step_counter.plain_calls += 1
    return ref.ssd_step(p, cache, z, xs, Bm, Cm, dt)


def ssd_step(p, cache, z, xs, Bm, Cm, dt) -> torch.Tensor:
    """Mamba2's decode mixer for R tenants x B slots, from the projections
    (z, xs (R, B, d_inner), Bm, Cm (R, B, N), dt (R, B, H)) to ``out_proj``'s
    input (R, B, d_inner), over ``p``'s tenant-stacked params; ``cache``'s
    conv windows and float32 state are updated IN PLACE."""
    if z.is_cuda:
        return _ssd.ssd_step(p, cache, z, xs, Bm, Cm, dt)
    _check_plain_device(z, "ssd_step")
    return ssd_step_plain(p, cache, z, xs, Bm, Cm, dt)


# The decode step is a handful of elementwise ops and one small product per
# head; the JAX package keeps it jnp too (not a Pallas kernel).
wkv6_step = ref.wkv6_step

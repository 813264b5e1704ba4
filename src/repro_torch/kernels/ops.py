"""Dispatch layer over the GEMM, attention and WKV6 kernels.

Routing is by the device of the tensors, never by a fallback: a CUDA
tensor goes to the hand-written kernel (which raises on anything it does
not take), a CPU tensor to the plain PyTorch version in ``ref``. The
``*_plain`` entry points run the plain version on any device; they are the
explicit opt-in the model's plain path (tests, ``chip_smoke.py``) uses to
hold the kernels against it on the card.

Each op keeps an ``OpCounter`` (``COUNTERS``): ``launches`` counts kernel
launches (incremented by the kernel wrapper, where it launches) and
``plain_calls`` counts calls of the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import batched_gemm as _bg
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_gemm as _gg
from repro_torch.kernels import wkv6_scan as _wkv

COUNTERS: Dict[str, _build.OpCounter] = {
    "decode_attention": _da.counter,
    "flash_attention": _fa.counter,
    "batched_gemm": _bg.counter,
    "grouped_gemm": _gg.counter,
    "wkv6_scan": _wkv.counter,
}


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.reset()


def _check_cpu(t: torch.Tensor, op: str) -> None:
    if t.device.type != "cpu":
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
    _check_cpu(x, "batched_gemm")
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
    _check_cpu(x, "grouped_gemm")
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
    q_offset: Optional[int] = None,
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
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Prefill attention (GQA, causal, optional sliding window, q_offset)."""
    if not q.is_cuda:
        _check_cpu(q, "flash_attention")
    if flash_attention_route(q.is_cuda, logit_softcap) == "kernel":
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
    _check_cpu(q, "decode_attention")
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
        return _wkv.wkv6_scan(r, k, v, w, u, init_state, final_state)
    _check_cpu(r, "wkv6_scan")
    return wkv6_scan_plain(r, k, v, w, u, init_state, final_state)


# The decode step is a handful of elementwise ops and one small product per
# head; the JAX package keeps it jnp too (not a Pallas kernel).
wkv6_step = ref.wkv6_step

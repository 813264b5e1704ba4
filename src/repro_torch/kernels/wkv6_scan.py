"""The RWKV-6 WKV recurrence over a whole sequence (K5, CUDA).

Wrapper of ``csrc/wkv6_scan.cu``, the port of the JAX package's Pallas
``wkv6_scan``. Unlike the TPU kernel it starts from a given state and
returns the state after the last step, so the serving prefill (fresh or a
chunked continuation) needs no second scan for the state. Its plain
PyTorch version is ``ref.wkv6_scan``; ``ops.wkv6_scan`` picks between them
by the device of the tensors. On the card every call takes the chunked
kernel: chunks of ``CHUNK`` steps, each from the state entering it through
running products of decays (``csrc/wkv6_scan.cu`` gives the formulas), 16
value columns a block.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_N = SUPPORTED_V = 64
# C codes of the source's kernels; "sequential" is the first version of K5
# (one dependent step at a time), launched only when asked for
# (chip_smoke.py times it as ``prior_ms``).
VARIANT_CODES = {"sequential": 0, "chunked": 1}
CHUNK = 16  # timesteps per chunk of the chunked kernel; boundaries at multiples of it


def variant(dtype: torch.dtype, T: int) -> str:
    """The kernel that scans ``T`` steps of ``dtype``: chunked for every
    dtype and length the wrapper takes (a scan shorter than ``CHUNK`` is one
    masked chunk)."""
    del dtype, T
    return "chunked"


def _heads4(t: torch.Tensor) -> torch.Tensor:
    """(BH, T, X) -> (BH, 1, T, X); (B, H, T, X) as it is."""
    return t.unsqueeze(1) if t.ndim == 3 else t


def _state(t: torch.Tensor, BH: int, N: int, V: int, what: str) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != BH * N * V:
        raise ValueError(f"wkv6_scan: {what} must be a contiguous float32 tensor of "
                         f"{BH}x{N}x{V} elements, got {tuple(t.shape)} {t.dtype}")


def wkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
    *,
    kernel: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w (BH, T, N) or (B, H, T, N); v (..., T, V); u (H, N) or (BH, N)
    float32; init_state (BH, N, V) float32 or None (zero).

    Returns (out (..., T, V) in r's dtype, laid out as v is; the state after
    step T, written into ``final_state`` (a float32 buffer of BH*N*V
    elements, which may be ``init_state`` itself) or a new (BH, N, V)
    tensor). The inputs may be strided views with a contiguous last dim.
    Launches a CUDA kernel on the tensors' card: ``variant``'s, or
    ``kernel`` where given (how ``chip_smoke.py`` times the sequential
    kernel); raises on anything the kernel does not take (device, dtype, N
    or V other than 64, alignment).
    """
    _build.check_device(r)
    if r.ndim not in (3, 4) or k.shape != r.shape or w.shape != r.shape \
            or v.ndim != r.ndim or v.shape[:-1] != r.shape[:-1]:
        raise ValueError(f"wkv6_scan: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} w {tuple(w.shape)}")
    T, N = r.shape[-2:]
    V = v.shape[-1]
    if N != SUPPORTED_N or V != SUPPORTED_V:
        raise ValueError(f"wkv6_scan: N={N} V={V}; the kernel takes N = V = 64")
    if T == 0:
        raise ValueError("wkv6_scan: empty sequence")
    if r.dtype not in _build.DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6_scan: r/k/v dtypes {r.dtype} {k.dtype} {v.dtype}")
    if w.dtype not in (r.dtype, torch.float32):
        raise TypeError(f"wkv6_scan: w must be {r.dtype} or float32, got {w.dtype}")
    kind = kernel or variant(r.dtype, T)
    if kind not in VARIANT_CODES:
        raise ValueError(f"wkv6_scan: no kernel {kind!r}")
    r4, k4, v4, w4 = (_heads4(t) for t in (r, k, v, w))
    B, H = r4.shape[:2]
    BH = B * H
    if u.dtype != torch.float32 or not u.is_contiguous() or u.ndim != 2 \
            or u.shape[1] != N or BH % u.shape[0]:
        raise ValueError(f"wkv6_scan: u must be contiguous float32 (H, {N}) or (BH, {N}), "
                         f"got {tuple(u.shape)} {u.dtype}")
    if init_state is not None:
        _state(init_state, BH, N, V, "init_state")
    if final_state is None:
        final_state = torch.empty((BH, N, V), dtype=torch.float32, device=r.device)
    _state(final_state, BH, N, V, "final_state")
    out = torch.empty_like(v, dtype=r.dtype)  # v's layout (strides preserved)
    out4 = _heads4(out)
    strides = []
    for t, what in ((r4, "r"), (k4, "k"), (v4, "v"), (w4, "w"), (out4, "out")):
        sb, sh, st, sx = t.stride()
        if sx != 1:
            raise ValueError(f"wkv6_scan: {what} must have a contiguous last dim")
        if what != "out":
            vec = 16 // t.element_size()
            if t.data_ptr() % 16 or sb % vec or sh % vec or st % vec:
                raise ValueError(f"wkv6_scan: {what} must be 16-byte aligned with strides "
                                 f"of whole 16-byte vectors, got strides {t.stride()}")
        strides += [sb, sh, st]
    for t in (k, v, w, u, final_state) + ((init_state,) if init_state is not None else ()):
        if t.device != r.device:
            raise ValueError("wkv6_scan: all tensors must be on one device")
    packed = (ctypes.c_longlong * 15)(*strides)
    lib = _build.load("wkv6_scan")
    with torch.cuda.device(r.device):
        status = lib.repro_wkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if init_state is None else init_state.data_ptr(), final_state.data_ptr(),
            out.data_ptr(), B, H, T, N, V, u.shape[0], ctypes.addressof(packed),
            _build.DTYPE_CODES[r.dtype], int(w.dtype == torch.float32), VARIANT_CODES[kind],
            _build.stream_of(r))
    _build.check_status(lib, "wkv6_scan", status)
    counter.launched(kind)
    return out, final_state

"""Causal / sliding-window GQA flash attention (K4, CUDA).

Wrapper of ``csrc/flash_attention.cu``, the port of the JAX package's
Pallas ``flash_attention``. Unlike the TPU kernel, ``q_offset`` (absolute
position of the first query) is a runtime argument, so chunked prefill
runs the kernel too. Its plain PyTorch version is ``ref.attention``;
``ops.flash_attention`` picks between them by the device of the tensors.
On the card, ``variant`` picks one of the source's two kernels by dtype
and head dim before the launch: the bf16 tensor-core kernel (wgmma fed by
TMA) or the CUDA-core kernel (float32, and bf16 at D = 112).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_HEAD_DIMS = (64, 112, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)  # whole 64-column (128-byte) swizzle boxes


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention of ``dtype`` at head dim ``D``:
    wgmma for bf16 at D = 64, 128 and 256 (rows of whole 128-byte swizzle
    boxes, one to four of them), the CUDA-core kernel for float32 and for
    bf16 at D = 112 (a 224-byte row is not a whole number of boxes)."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


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
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    Launches a CUDA kernel on the tensors' card: ``variant(dtype, D)``'s,
    or ``kernel`` where given (how ``chip_smoke.py`` times the CUDA-core
    kernel on bf16); raises on anything the kernel does not take (device,
    dtype, layout, head dim, softcap).
    """
    _build.check_device(q)
    if logit_softcap != 0.0:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel computes no logit_softcap, as the Pallas "
            "kernel computes none; ops.flash_attention sends it to the plain version")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if k.shape != v.shape or (Bk, Dk) != (B, D) or Hq % Hkv:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, what, q.dtype)
        if t.device != q.device:
            raise ValueError("flash_attention: all tensors must be on one device")
    kind = kernel or variant(q.dtype, D)
    if kind not in _build.VARIANT_CODES or (kind == "wgmma" and variant(q.dtype, D) != "wgmma"):
        raise ValueError(f"flash_attention: variant {kind!r} does not take {q.dtype} D={D}")
    out = torch.empty_like(q)
    if Sq == 0 or Skv == 0:
        return out.zero_()
    scale = scale if scale is not None else D ** -0.5
    q_offset = Skv - Sq if q_offset is None else int(q_offset)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, int(bool(causal)), int(window), q_offset,
            _build.DTYPE_CODES[q.dtype], _build.VARIANT_CODES[kind], float(scale),
            _build.stream_of(q))
    _build.check_status(lib, "flash_attention", status)
    counter.launched(kind)
    return out

"""Causal / sliding-window GQA flash attention (K4, CUDA).

Wrapper of ``csrc/flash_attention.cu``, the port of the JAX package's
Pallas ``flash_attention``. Unlike the TPU kernel, ``q_offset`` (absolute
position of the first query) is a runtime argument, so chunked prefill
runs the kernel too. Its plain PyTorch version is ``ref.attention``;
``ops.flash_attention`` picks between them by the device of the tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_HEAD_DIMS = (64, 128)


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
    """q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    Launches the CUDA kernel on the tensors' card; raises on anything the
    kernel does not take (device, dtype, layout, head dim, softcap).
    """
    _build.check_device(q)
    if logit_softcap != 0.0:
        raise NotImplementedError(
            "flash_attention: logit_softcap is not in the CUDA kernel yet "
            "(gemma3 slice, see ROADMAP.md)")
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
            _build.DTYPE_CODES[q.dtype], float(scale), _build.stream_of(q))
    _build.check_status(lib, "flash_attention", status)
    counter.launches += 1
    return out

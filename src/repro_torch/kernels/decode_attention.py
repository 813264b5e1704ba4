"""One-token GQA decode attention against a KV cache (K3, CUDA).

Wrapper of ``csrc/decode_attention.cu``, the port of the JAX package's
Pallas ``decode_attention``. Its plain PyTorch version is
``ref.decode_attention``; ``ops.decode_attention`` picks between them by
the device of the tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_HEAD_DIMS = (64, 128)
MAX_Q_PER_KV = 8


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B,Hq,D), caches (B,Hkv,S,D), lengths (B,) int32 -> (B,Hq,D).

    Launches the CUDA kernel on the tensors' card; raises on anything the
    kernel does not take (device, dtype, layout, head dim, GQA ratio).
    """
    _build.check_device(q)
    B, Hq, D = q.shape
    Bk, Hkv, S, Dk = k_cache.shape
    if k_cache.shape != v_cache.shape or (Bk, Dk) != (B, D) or lengths.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
            f"v {tuple(v_cache.shape)} lengths {tuple(lengths.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_Q_PER_KV:
        raise ValueError(f"decode_attention: Hq={Hq} Hkv={Hkv} (q_per_kv <= {MAX_Q_PER_KV})")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported")
    for t, what in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        _build.check_tensor(t, what, q.dtype)
    _build.check_tensor(lengths, "lengths", torch.int32)
    for t in (k_cache, v_cache, lengths):
        if t.device != q.device:
            raise ValueError("decode_attention: all tensors must be on one device")
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    with torch.cuda.device(q.device):
        status = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            _build.DTYPE_CODES[q.dtype], float(scale), _build.stream_of(q))
    _build.check_status(lib, "decode_attention", status)
    counter.launches += 1
    return out

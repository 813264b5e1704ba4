"""The space-time super-kernel: R same-shape GEMMs in one launch (K1, CUDA).

Wrapper of ``csrc/batched_gemm.cu``, the port of the JAX package's Pallas
``batched_gemm``. Each problem's weights come from a different tenant
model: this is inter-model batching, not data batching. Its plain PyTorch
version is ``ref.batched_gemm``; ``ops.batched_gemm`` picks between them by
the device of the tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()


def batched_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[r] = x[r] @ w[r]; x (R,M,K), w (R,K,N) -> (R,M,N) in x.dtype.

    Launches the CUDA kernel on the tensors' card (float32 accumulation,
    full float32 arithmetic); raises on anything the kernel does not take
    (device, dtype, layout, shape).
    """
    _build.check_device(x)
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"batched_gemm: expected (R,M,K),(R,K,N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    R, M, K = x.shape
    Rw, Kw, N = w.shape
    if (Rw, Kw) != (R, K):
        raise ValueError(f"batched_gemm: shape mismatch x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"batched_gemm: dtype {x.dtype} not supported")
    for t, what in ((x, "x"), (w, "w")):
        _build.check_tensor(t, what, x.dtype)
    if w.device != x.device:
        raise ValueError("batched_gemm: x and w must be on one device")
    out = torch.empty((R, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("batched_gemm")
    with torch.cuda.device(x.device):
        status = lib.repro_batched_gemm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), R, M, N, K,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check_status(lib, "batched_gemm", status)
    counter.launches += 1
    return out

"""The space-time super-kernel: R same-shape GEMMs in one launch (K1, CUDA).

Wrapper of ``csrc/batched_gemm.cu``, the port of the JAX package's Pallas
``batched_gemm``. Each problem's weights come from a different tenant
model: this is inter-model batching, not data batching. Its plain PyTorch
version is ``ref.batched_gemm``; ``ops.batched_gemm`` picks between them by
the device of the tensors. On the card, ``variant`` picks one of the
source's kernels by dtype and shape before the launch: the bf16
tensor-core kernel (wgmma fed by TMA, K2's mainloop) or the float32
CUDA-core kernel (``simt``, register-tiled, K split across a cluster).

The tile arithmetic of both kernels is mirrored here in Python
(``wgmma_tiles``, ``simt_k_ranges``) so that the CPU tests can check it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
# C codes of the source's kernels; "cuda_core" is the first version of K1,
# launched only when asked for (chip_smoke.py times it as ``prior_ms``).
VARIANT_CODES = {"cuda_core": 0, "wgmma": 1, "simt": 2}
WGMMA_COLUMNS = 128   # output columns per wgmma tile
SIMT_BK = 16          # depth of one simt stage: the unit a K split is made of


def variant(dtype: torch.dtype, K: int, N: int) -> str:
    """The kernel that computes an (R, M, K) x (R, K, N) product of ``dtype``.

    wgmma for bf16 with K and N multiples of 8 (TMA needs 16-byte global
    strides; base pointers are checked 16-byte aligned) and K > 0, as K2
    decides; simt for everything else, all float32 included (its 2e-4
    tolerance rules out TF32).
    """
    if dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0:
        return "wgmma"
    return "simt"


def wgmma_tile_rows(M: int) -> int:
    """Rows of a wgmma tile: 64 (one consumer warpgroup) for M <= 64, so a
    decode-sized problem does not leave most of a tile's rows idle, else
    128 (two)."""
    return 64 if M <= 64 else 128


def wgmma_tiles(R: int, M: int, N: int) -> List[Tuple[int, int, int, int, int]]:
    """The wgmma kernel's output tiles, as it computes them from the tile
    index: (problem, first row, row it stops storing at, first column, column
    it stops at), rows counted over the (R*M, N) output. Problem r's row tile
    i starts at r*M + bm*i and stops at min(that + bm, (r+1)*M); columns come
    in tiles of 128, the epilogue storing only those below N."""
    bm = wgmma_tile_rows(M)
    per = -(-M // bm)
    tiles = []
    for rt in range(R * per):
        r, i = divmod(rt, per)
        row0 = r * M + i * bm
        row_end = min(row0 + bm, (r + 1) * M)
        for c0 in range(0, N, WGMMA_COLUMNS):
            tiles.append((r, row0, row_end, c0, min(c0 + WGMMA_COLUMNS, N)))
    return tiles


def simt_splits(K: int) -> int:
    """How many CTAs of one cluster split the simt kernel's K loop: 4 for
    K >= 1024, 2 for K >= 512, else 1. It depends on K alone, so a problem's
    sum order (and so its bits) does not depend on R, M or N: run 1's median
    dispatch (8, 256, 1152, 128) is 4 x 64 CTAs, which fills the 132 SMs."""
    return 4 if K >= 1024 else 2 if K >= 512 else 1


def simt_k_ranges(K: int, splits: Optional[int] = None) -> List[Tuple[int, int]]:
    """The [k0, k1) range each rank of a simt cluster sums, rank order: the
    K loop's 16-deep stages dealt out in equal contiguous runs, the last
    ranks' runs cut at K (possibly empty)."""
    splits = simt_splits(K) if splits is None else splits
    steps = -(-K // SIMT_BK)
    chunk = -(-steps // splits) * SIMT_BK
    return [(min(q * chunk, K), min(q * chunk + chunk, K)) for q in range(splits)]


def batched_gemm(x: torch.Tensor, w: torch.Tensor, kernel: Optional[str] = None) -> torch.Tensor:
    """out[r] = x[r] @ w[r]; x (R,M,K), w (R,K,N) -> (R,M,N) in x.dtype.

    Launches a CUDA kernel on the tensors' card, float32 accumulation:
    ``variant(dtype, K, N)``'s, or ``kernel`` where given (how
    ``chip_smoke.py`` times the first, CUDA-core kernel); raises on
    anything the kernel does not take (device, dtype, layout, shape).
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
    v = kernel or variant(x.dtype, K, N)
    if v not in VARIANT_CODES or (v == "wgmma" and variant(x.dtype, K, N) != "wgmma"):
        raise ValueError(f"batched_gemm: variant {v!r} does not take {x.dtype} K={K} N={N}")
    out = torch.empty((R, M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("batched_gemm")
    with torch.cuda.device(x.device):
        status = lib.repro_batched_gemm(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), R, M, N, K,
            _build.DTYPE_CODES[x.dtype], VARIANT_CODES[v], wgmma_tile_rows(M), simt_splits(K),
            _build.stream_of(x))
    _build.check_status(lib, "batched_gemm", status)
    counter.launched(v)
    return out

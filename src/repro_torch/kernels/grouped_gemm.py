"""Grouped (variable-size batched) GEMM: the ragged super-kernel (K2, CUDA).

Wrapper of ``csrc/grouped_gemm.cu``, the port of the JAX package's Pallas
``grouped_gemm`` (the MAGMA-vbatched analogue), and the host helper
``make_group_layout`` that builds its row layout:

    x:   (T, K)   rows sorted by group, each group zero-padded to a multiple
                  of the row-block size bm
    w:   (G, K, N) one weight matrix per group
    block_groups: (T/bm,) int32 -- which group each row block belongs to

Its plain PyTorch version is ``ref.grouped_gemm``; ``ops.grouped_gemm``
picks between them by the device of the tensors. On the card, ``variant``
picks one of the source's two kernels by dtype and shape before the launch:
the bf16 tensor-core kernel (wgmma fed by TMA) or the CUDA-core kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
DEFAULT_BM = 128
# Row tile of each kernel: the height of the tile table's tiles.
TILE_ROWS = {"cuda_core": 64, "wgmma": 128}


def variant(dtype: torch.dtype, K: int, N: int) -> str:
    """The kernel that computes a (T, K) x (G, K, N) product of ``dtype``.

    wgmma for bf16 with K and N multiples of 8 (TMA needs 16-byte global
    strides; base pointers are checked 16-byte aligned) and K > 0; the
    CUDA-core kernel for everything else, all float32 included (its 2e-4
    tolerance rules out TF32).
    """
    if dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0:
        return "wgmma"
    return "cuda_core"


def tile_table(block_groups: np.ndarray, bm: int, tile_rows: int) -> np.ndarray:
    """(n_tiles, 3) int32 rows (row0, row_end, group), one per row tile.

    Row block i (rows i*bm .. (i+1)*bm - 1) is ceil(bm / tile_rows) tiles of
    ``tile_rows`` rows; the last one ends at the block's edge, so no tile
    stores across two blocks. Each tile carries its block's group id.
    """
    ids = np.asarray(block_groups, np.int32)
    per_block = -(-bm // tile_rows)
    row0 = (np.arange(len(ids))[:, None] * bm + np.arange(per_block)[None, :] * tile_rows).ravel()
    block_end = np.repeat((np.arange(len(ids)) + 1) * bm, per_block)
    table = np.stack([row0, np.minimum(row0 + tile_rows, block_end),
                      np.repeat(ids, per_block)], axis=1)
    return np.ascontiguousarray(table, dtype=np.int32)


def make_group_layout(
    group_sizes: np.ndarray, bm: int = DEFAULT_BM
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host-side helper: padded row offsets + per-block group ids.

    Given per-group row counts, returns (row_offsets, block_groups, T_padded)
    where each group's rows are padded up to a multiple of ``bm`` so blocks
    never straddle a group boundary.
    """
    group_sizes = np.asarray(group_sizes, dtype=np.int64)
    padded = ((group_sizes + bm - 1) // bm) * bm
    offsets = np.concatenate([[0], np.cumsum(padded)])
    block_groups = np.repeat(np.arange(len(group_sizes)), padded // bm).astype(np.int32)
    return offsets.astype(np.int64), block_groups, int(offsets[-1])


def host_block_groups(block_groups: np.ndarray, n_blocks: int, n_groups: int) -> np.ndarray:
    """``block_groups`` as a host int32 array, checked: (n_blocks,) ids in
    [0, n_groups). Tensors are refused, so no copy back from a card can
    hide in the launch path."""
    if isinstance(block_groups, torch.Tensor):
        raise TypeError("grouped_gemm: block_groups must be a host (numpy) integer array, "
                        "not a tensor")
    ids = np.asarray(block_groups)
    if ids.dtype.kind not in "iu":
        raise TypeError(f"grouped_gemm: block_groups must be integers, got {ids.dtype}")
    if ids.shape != (n_blocks,):
        raise ValueError(f"grouped_gemm: block_groups shape {ids.shape}, expected ({n_blocks},)")
    if ids.size and (int(ids.min()) < 0 or int(ids.max()) >= n_groups):
        raise ValueError(f"grouped_gemm: group ids must lie in [0, {n_groups}), got "
                         f"[{int(ids.min())}, {int(ids.max())}]")
    return np.ascontiguousarray(ids, dtype=np.int32)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, block_groups: np.ndarray,
                 bm: int = DEFAULT_BM, kernel: Optional[str] = None) -> torch.Tensor:
    """out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_groups[i]].

    x (T,K) with T % bm == 0, w (G,K,N), block_groups (T/bm,) integer ids
    (a host numpy array, as ``make_group_layout`` builds it; checked on
    the host, then turned into the kernel's tile table and uploaded). Any
    bm >= 1 (see ``tile_table``).
    Launches a CUDA kernel on the tensors' card, float32 accumulation:
    ``variant(dtype, K, N)``'s, or ``kernel`` where given (how
    ``chip_smoke.py`` times the CUDA-core kernel on bf16); raises on
    anything the kernel does not take.
    """
    _build.check_device(x)
    if x.ndim != 2 or w.ndim != 3:
        raise ValueError(f"grouped_gemm: expected (T,K),(G,K,N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    T, K = x.shape
    G, Kw, N = w.shape
    if Kw != K:
        raise ValueError(f"grouped_gemm: K mismatch x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if bm < 1:
        raise ValueError(f"grouped_gemm: row block bm={bm} must be positive")
    if T % bm:
        raise ValueError(f"grouped_gemm: rows T={T} must be a multiple of the row block {bm}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"grouped_gemm: dtype {x.dtype} not supported")
    for t, what in ((x, "x"), (w, "w")):
        _build.check_tensor(t, what, x.dtype)
    if w.device != x.device:
        raise ValueError("grouped_gemm: x and w must be on one device")
    ids = host_block_groups(block_groups, T // bm, G)
    v = kernel or variant(x.dtype, K, N)
    if v not in TILE_ROWS or (v == "wgmma" and variant(x.dtype, K, N) != "wgmma"):
        raise ValueError(f"grouped_gemm: variant {v!r} does not take {x.dtype} K={K} N={N}")
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    tiles = tile_table(ids, bm, TILE_ROWS[v])
    table = torch.from_numpy(tiles).to(x.device)
    lib = _build.load("grouped_gemm")
    with torch.cuda.device(x.device):
        status = lib.repro_grouped_gemm(
            x.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), len(tiles), T, G, N,
            K, _build.DTYPE_CODES[x.dtype], _build.VARIANT_CODES[v], _build.stream_of(x))
    _build.check_status(lib, "grouped_gemm", status)
    counter.launched(v)
    return out

"""Grouped (variable-size batched) GEMM: the ragged super-kernel (K2, CUDA).

Wrapper of ``csrc/grouped_gemm.cu``, the port of the JAX package's Pallas
``grouped_gemm`` (the MAGMA-vbatched analogue), and the host helper
``make_group_layout`` that builds its row layout:

    x:   (T, K)   rows sorted by group, each group zero-padded to a multiple
                  of the row-block size bm
    w:   (G, K, N) one weight matrix per group
    block_groups: (T/bm,) int32 -- which group each row block belongs to

Its plain PyTorch version is ``ref.grouped_gemm``; ``ops.grouped_gemm``
picks between them by the device of the tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
DEFAULT_BM = 128


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
                 bm: int = DEFAULT_BM) -> torch.Tensor:
    """out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[block_groups[i]].

    x (T,K) with T % bm == 0, w (G,K,N), block_groups (T/bm,) integer ids
    (a host numpy array, as ``make_group_layout`` builds it; checked on
    the host, then uploaded). Any
    bm >= 1: a row block is ceil(bm / 64) of the kernel's 64-row tiles,
    the last one masked at the block's edge.
    Launches the CUDA kernel on the tensors' card (float32 accumulation,
    full float32 arithmetic); raises on anything the kernel does not take.
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
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    table = torch.from_numpy(ids).to(x.device)
    lib = _build.load("grouped_gemm")
    with torch.cuda.device(x.device):
        status = lib.repro_grouped_gemm(
            x.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), T, G, N, K, bm,
            _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check_status(lib, "grouped_gemm", status)
    counter.launches += 1
    return out

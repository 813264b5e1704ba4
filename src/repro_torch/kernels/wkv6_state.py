"""The WKV6 state after T steps, with no outputs (K5-state, CUDA).

Wrapper of ``csrc/wkv6_state.cu``. It replaces no Pallas kernel: the JAX
package rolls a bf16 prefill's kept state with ``_wkv_final_state``
(``src/repro/models/rwkv.py:188``), a jnp ``lax.scan`` that reads k, v and
float32 w and computes no outputs. Per head, with a float32 (N, V) state:

    d_t = exp(-exp(w_t)),    S_t = diag(d_t) S_{t-1} + k_t^T v_t

Its plain version is ``ref.wkv6_state``; ``ops.wkv6_state`` picks between
them by the device of the tensors.

The kernel cuts time, not the state. The T steps form G = ``segments(BH,
T)`` segments, segment g the steps [g L, min(T, (g + 1) L)), L = ceil(T /
G) (``segment_bounds``). Segment g rolls its own state S_g from zero
(segment 0 from ``init_state``) and keeps its decay product per row, D_g =
prod_{t in g} d_t; the state after step T is the ordered combine

    S = S_0,  then  S = diag(D_g) S + S_g  for g = 1 .. G - 1,

the same recurrence regrouped. The G CTAs of a head form one thread-block
cluster and combine through distributed shared memory.

Segment rule (``segments``), decided here before the launch: the most
segments, at most ``MAX_SEGMENTS`` (the portable cluster) and at most T //
``TILE`` (at least one 64-step tile a segment), for which all BH clusters
are resident on the card at once (``RESIDENT_CLUSTERS``); one where none
is. A second wave of clusters costs more than the segments save: at 32
heads, 8 segments (30 clusters resident) took 0.964 ms at T = 32768 and 7
(32 resident) 0.678 (``experiments/wkv6_state_sweep.py``, an H100 SXM).

The graphed prefill's pieces take a second kernel, ``row_blocks``
(``variant``: T <= ``ROW_BLOCKS_MAX_T``). Row n of a head's state evolves
alone, S_t[n, :] = d_t[n] S_{t-1}[n, :] + k_t[n] v_t[:], so a CTA owns
``ROWS`` rows of one head (``row_grid``: ceil(N / ROWS) x BH CTAs of
``ROW_THREADS`` threads): it reads k and w at its rows, all of v, and its
own rows of the state only, so ``final_state`` may be ``init_state`` with
no ordering, and needs no cluster and no combine. Its 64-step tiles arrive
in a ring three ahead of the one rolled (a piece of up to 192 steps is one
round trip), and each tile is rolled as one product: with m_t[n] the
product of the decays after step t inside the tile and P[n] the tile's,
S[n, :] <- P[n] S[n, :] + sum_t (k_t[n] m_t[n]) v_t[:], the same recurrence
regrouped by tile, the sum a (16 x 64) (64 x 64) product on the tensor
cores in 3xTF32.

Head sizes: N and V each in ``SUPPORTED_HEAD_SIZES``; the segmented kernel
runs a 64 x 64 state with the rows past N and the columns past V held at
zero (their k and v read as 0, their decay as 1), the row-block kernel no
CTA for rows past N and zero columns past V; both write only the live (N,
V).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
# C codes of the kernels: segments of time joined in a cluster (long
# sequences), and blocks of state rows (the graphed prefill's pieces)
VARIANT_CODES = {"segmented": 0, "row_blocks": 1}
ROW_BLOCKS_MAX_T = 512  # the longest piece below the top one at cache 2048
ROWS = 16           # state rows a row_blocks CTA owns (one mma tile): 128 CTAs for 32 heads of 64
ROW_THREADS = 256   # its 8 warps: warp w the state's columns 8w .. 8w + 7
SUPPORTED_HEAD_SIZES = (8, 16, 32, 64)  # N and V each, as K5 takes them
TILE = 64           # steps the kernel stages at once
MAX_SEGMENTS = 8    # the portable thread-block cluster
# Clusters of G CTAs resident at once on an H100 SXM (132 SMs, two CTAs of
# ~81 KB (bf16) or ~97 KB (float32) of shared memory each), by G: the
# card's cudaOccupancyMaxActiveClusters for the kernel, which chip_smoke.py's
# build report prints beside this table.
RESIDENT_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}


def segments(BH: int, T: int) -> int:
    """The segment count (CTAs a head, one cluster) for ``BH`` heads of
    ``T`` steps: the largest G <= min(MAX_SEGMENTS, T // TILE) with BH <=
    RESIDENT_CLUSTERS[G] (every head's cluster resident at once), else 1."""
    fits = [G for G in range(1, min(MAX_SEGMENTS, T // TILE) + 1)
            if BH <= RESIDENT_CLUSTERS[G]]
    return max(fits, default=1)


def variant(T: int) -> str:
    """The kernel for ``T`` steps, picked before the launch: ``row_blocks``
    up to ROW_BLOCKS_MAX_T steps (every piece of the graphed prefill below
    the top one), ``segmented`` above. The card measured the crossover at
    rwkv6's 32 heads only (``PERF.md``); the rule does not look at the head
    count."""
    return "row_blocks" if T <= ROW_BLOCKS_MAX_T else "segmented"


def row_grid(BH: int, N: int) -> Tuple[int, int]:
    """The row-block kernel's grid: (ceil(N / ROWS) row blocks, BH heads)
    of ROW_THREADS threads each."""
    return -(-N // ROWS), BH


def segment_bounds(T: int, G: int) -> List[Tuple[int, int]]:
    """The kernel's segments of ``T`` steps in ``G``: [g L, min(T, (g + 1)
    L)), L = ceil(T / G); every one non-empty for G = ``segments(BH, T)``."""
    L = -(-T // G)
    return [(min(T, g * L), min(T, (g + 1) * L)) for g in range(G)]


def _heads4(t: torch.Tensor) -> torch.Tensor:
    """(BH, T, X) -> (BH, 1, T, X); (B, H, T, X) as it is."""
    return t.unsqueeze(1) if t.ndim == 3 else t


def _state(t: torch.Tensor, BH: int, N: int, V: int, what: str) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != BH * N * V \
            or t.data_ptr() % 16:
        raise ValueError(f"wkv6_state: {what} must be a contiguous, 16-byte aligned float32 "
                         f"tensor of {BH}x{N}x{V} elements, got {tuple(t.shape)} {t.dtype}")


def wkv6_state(
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
    *,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """k (BH, T, N) or (B, H, T, N) and v (..., T, V) of one dtype (float32
    or bf16); w (..., T, N) float32; init_state (BH, N, V) float32 or None
    (zero).

    Returns the float32 state after step T, written into ``final_state``
    (a float32 buffer of BH*N*V elements, which may be ``init_state``
    itself) or a new (BH, N, V) tensor. The inputs may be strided views
    with a contiguous last dim. Launches ``csrc/wkv6_state.cu`` on the
    tensors' card: ``variant(T)``'s kernel, or ``kernel`` where given
    (how ``chip_smoke.py`` times the segmented kernel at the pieces), over
    ``segments(BH, T)`` segments or ``row_grid(BH, N)``; raises on anything
    the kernel does not take (device, dtype, N or V outside
    ``SUPPORTED_HEAD_SIZES``, alignment).
    """
    _build.check_device(k)
    if k.ndim not in (3, 4) or w.shape != k.shape or v.ndim != k.ndim \
            or v.shape[:-1] != k.shape[:-1]:
        raise ValueError(f"wkv6_state: shapes k {tuple(k.shape)} v {tuple(v.shape)} "
                         f"w {tuple(w.shape)}")
    T, N = k.shape[-2:]
    V = v.shape[-1]
    if N not in SUPPORTED_HEAD_SIZES or V not in SUPPORTED_HEAD_SIZES:
        raise ValueError(f"wkv6_state: N={N} V={V}; the kernel takes N and V in "
                         f"{SUPPORTED_HEAD_SIZES}")
    if T == 0:
        raise ValueError("wkv6_state: empty sequence")
    if k.dtype not in _build.DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"wkv6_state: k/v dtypes {k.dtype} {v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6_state: w must be float32, got {w.dtype}")
    k4, v4, w4 = (_heads4(t) for t in (k, v, w))
    B, H = k4.shape[:2]
    BH = B * H
    if init_state is not None:
        _state(init_state, BH, N, V, "init_state")
    if final_state is None:
        final_state = torch.empty((BH, N, V), dtype=torch.float32, device=k.device)
    _state(final_state, BH, N, V, "final_state")
    for t in (v, w, final_state) + ((init_state,) if init_state is not None else ()):
        if t.device != k.device:
            raise ValueError("wkv6_state: all tensors must be on one device")
    strides = []
    for t, what in ((k4, "k"), (v4, "v"), (w4, "w")):
        sb, sh, st, sx = t.stride()
        vec = 16 // t.element_size()
        if sx != 1 or t.data_ptr() % 16 or sb % vec or sh % vec or st % vec:
            raise ValueError(f"wkv6_state: {what} must have a contiguous last dim, be 16-byte "
                             f"aligned and have strides of whole 16-byte vectors, got "
                             f"strides {t.stride()}")
        strides += [sb, sh, st]
    packed = (ctypes.c_longlong * 9)(*strides)
    kind = kernel or variant(T)
    if kind not in VARIANT_CODES:
        raise ValueError(f"wkv6_state: no kernel {kind!r}")
    split = ROWS if kind == "row_blocks" else segments(BH, T)
    lib = _build.load("wkv6_state")
    with torch.cuda.device(k.device):
        status = lib.repro_wkv6_state(
            k.data_ptr(), v.data_ptr(), w.data_ptr(),
            None if init_state is None else init_state.data_ptr(), final_state.data_ptr(),
            B, H, T, N, V, ctypes.addressof(packed), _build.DTYPE_CODES[k.dtype],
            VARIANT_CODES[kind], split, _build.stream_of(k))
    _build.check_status(lib, "wkv6_state", status)
    counter.launched(kind, size=T)
    return final_state

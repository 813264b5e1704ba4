"""One-token GQA decode attention against a KV cache (K3, CUDA).

Wrapper of ``csrc/decode_attention.cu``, the port of the JAX package's
Pallas ``decode_attention``. Its plain PyTorch version is
``ref.decode_attention``; ``ops.decode_attention`` picks between them by
the device of the tensors. On the card every call takes the split-KV
kernel: ``splits(S)`` CTAs of one thread-block cluster share each
(sequence, kv head)'s live prefix (``key_ranges`` mirrors how) and combine
their partial softmaxes on chip, in one launch. One launch takes up to
``MAX_G`` = 8 query heads per kv head; a larger GQA ratio runs as
``head_groups`` launches against the same cache (``grouped``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_HEAD_DIMS = (32, 64, 112, 128, 256)
SINGLE_PASS_HEAD_DIMS = (64, 128)  # the first kernel's instances
MAX_G = 8  # query heads per kv head in one launch (the source's kMaxG)
# C codes of the source's kernels; "single_pass" is the first version of K3 (one
# block per (sequence, kv head)), launched only when asked for
# (chip_smoke.py times it as ``prior_ms``).
VARIANT_CODES = {"single_pass": 0, "split_kv": 1}
KEY_TILE = 64          # keys per tile: the unit a live prefix is split in
KEYS_PER_SPLIT = 512   # cache positions per CTA of a cluster
MAX_SPLITS = 8         # the portable cluster size


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes decode attention of ``dtype`` at head dim
    ``D``: split_kv for every dtype and head dim the wrapper takes (a cache
    of at most 512 positions is one CTA per cluster; D = 32 lays its lanes
    out as 64 columns and D = 112 as 128, masking the columns past D)."""
    del dtype, D
    return "split_kv"


def splits(S: int) -> int:
    """CTAs per (sequence, kv head): one per 512 cache positions, 1 to 8
    (4 at S = 2048). It depends on the allocated length S alone, never on
    ``lengths``, which stay on the card."""
    return max(1, min(MAX_SPLITS, -(-S // KEYS_PER_SPLIT)))


def lane_layout(D: int, q_per_kv: int) -> Tuple[int, int, int]:
    """split_kv's lanes at head dim ``D`` (the source's ``split::Cfg`` for
    the instance that takes one launch's ``q_per_kv``: G = 1, 2, 4 or 8):
    (the width the lanes are laid out for, lanes per key, values per lane). A row of
    D = 32 is laid out as 64 columns and one of D = 112 as 128; the lanes
    whose slice starts at or past D hold nothing."""
    G = next(g for g in (1, 2, 4, 8) if q_per_kv <= g)
    width = 64 if D <= 64 else 128 if D <= 128 else 256
    lanes = min(32, max(8, G * width // 32))
    return width, lanes, width // lanes


def ring_bytes(dtype: torch.dtype, D: int) -> int:
    """Dynamic shared memory of split_kv (its K/V ring of 64-key tiles): 3
    stages of tiles of 8 KB or less, 2 where two stages fit in 200 KB, else
    1 (float32 at D = 256). The source's ``repro_decode_attention_smem``
    answers the same on the card."""
    tile = KEY_TILE * D * (2 if dtype == torch.bfloat16 else 4)
    stages = 3 if 2 * tile <= 16384 else 2 if 4 * tile <= 200 * 1024 else 1
    return stages * 2 * tile


def key_ranges(L: int, n_splits: int) -> List[Tuple[int, int]]:
    """The [start, end) keys each rank of a cluster walks for a sequence of
    live length L, rank order: ceil(ceil(L / 64) / n_splits) whole 64-key
    tiles each, cut at L, so the last ranks of a short sequence are empty."""
    tiles = -(-L // KEY_TILE)
    per = -(-tiles // n_splits) * KEY_TILE
    return [(min(q * per, L), min(q * per + per, L)) for q in range(n_splits)]


def head_groups(q_per_kv: int) -> List[Tuple[int, int]]:
    """The [lo, hi) query heads of each kv head's group that each launch
    takes: ceil(q_per_kv / MAX_G) groups of at most MAX_G, in order."""
    return [(lo, min(lo + MAX_G, q_per_kv)) for lo in range(0, q_per_kv, MAX_G)]


def grouped(q: torch.Tensor, Hkv: int,
            attend: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``attend`` over each head group of q (B, Hq, D), outputs put back in
    place. Group [lo, hi) of ``q.view(B, Hkv, G, D)`` goes in as a
    contiguous (B, Hkv * (hi - lo), D), so kv head h still serves the
    group's query heads h * (hi - lo) onward; a ratio of at most MAX_G is
    one call on q itself."""
    B, Hq, D = q.shape
    G = Hq // Hkv
    groups = head_groups(G)
    if len(groups) == 1:
        return attend(q)
    qv = q.view(B, Hkv, G, D)
    out = torch.empty_like(qv)
    for lo, hi in groups:
        qg = qv[:, :, lo:hi].contiguous().view(B, Hkv * (hi - lo), D)
        out[:, :, lo:hi] = attend(qg).view(B, Hkv, hi - lo, D)
    return out.view(B, Hq, D)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    kernel: Optional[str] = None,
) -> torch.Tensor:
    """q (B,Hq,D), caches (B,Hkv,S,D), lengths (B,) int32 -> (B,Hq,D).

    Launches a CUDA kernel on the tensors' card: ``variant``'s, or
    ``kernel`` where given (how ``chip_smoke.py`` times the first, single-pass kernel),
    once per head group (``head_groups``: one launch up to 8 query heads
    per kv head); raises on anything the kernel does not take (device,
    dtype, layout, head dim, Hq not a multiple of Hkv).
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
    if Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported")
    for t, what in ((q, "q"), (k_cache, "k_cache"), (v_cache, "v_cache")):
        _build.check_tensor(t, what, q.dtype)
    _build.check_tensor(lengths, "lengths", torch.int32)
    for t in (k_cache, v_cache, lengths):
        if t.device != q.device:
            raise ValueError("decode_attention: all tensors must be on one device")
    kind = kernel or variant(q.dtype, D)
    if kind not in VARIANT_CODES:
        raise ValueError(f"decode_attention: no kernel {kind!r}")
    if kind == "single_pass" and D not in SINGLE_PASS_HEAD_DIMS:
        raise ValueError(f"decode_attention: the single_pass kernel takes head dims "
                         f"{SINGLE_PASS_HEAD_DIMS} only, not {D}")
    scale = float(scale if scale is not None else D ** -0.5)
    return grouped(q, Hkv, lambda qg: _launch(qg, k_cache, v_cache, lengths, kind, scale))


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            lengths: torch.Tensor, kind: str, scale: float) -> torch.Tensor:
    """One launch of ``kind`` on checked inputs, q_per_kv at most MAX_G."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    with torch.cuda.device(q.device):
        status = lib.repro_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
            _build.DTYPE_CODES[q.dtype], VARIANT_CODES[kind], splits(S), scale,
            _build.stream_of(q))
    _build.check_status(lib, "decode_attention", status)
    counter.launched(kind)
    return out

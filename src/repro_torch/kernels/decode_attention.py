"""One-token GQA decode attention against a KV cache (K3, CUDA).

Wrapper of ``csrc/decode_attention.cu``, the port of the JAX package's
Pallas ``decode_attention``. Its plain PyTorch version is
``ref.decode_attention``; ``ops.decode_attention`` picks between them by
the device of the tensors. On the card ``variant(dtype, D, q_per_kv)``
picks one of two kernels before the launch, never as a fallback; in both,
the CTAs of one thread-block cluster share each (sequence, kv head)'s live
prefix in whole 64-key tiles (``key_ranges`` mirrors how) and combine
their partial softmaxes on chip, in one launch:

* ``mma`` (bf16 at D = 256, paligemma-3b's 8 query heads on one kv head of
  256, and at D = 128 from 5 query heads a kv head, qwen2-7b's 7 and
  llama4-maverick's 5): the tensor cores' ``mma.sync.m16n8k16``, the
  group's query heads the n = 8 columns (swap-AB: scores^T = K Q^T,
  out^T = V^T P^T), over ``mma_splits(B * Hkv, S)`` CTAs, up to 16, chosen
  to fill the card;
* ``split_kv`` (everything else, float32 included): dot products on the
  CUDA cores, lanes laid out by ``lane_layout``, over ``splits(S)`` CTAs.

One launch takes up to ``MAX_G`` = 8 query heads per kv head; a larger GQA
ratio runs as ``head_groups`` launches against the same cache
(``grouped``), each by the rule at its own group size.
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
VARIANT_CODES = {"single_pass": 0, "split_kv": 1, "mma": 2}
KEY_TILE = 64          # keys per tile: the unit a live prefix is split in
KEYS_PER_SPLIT = 512   # split_kv: cache positions per CTA of a cluster
MAX_SPLITS = 8         # split_kv: the portable cluster size
MMA_HEAD_DIMS = (64, 112, 128, 256)  # the mma kernel's instances (bf16)
# where ``variant`` sends bf16 to it: head dim -> the fewest query heads a kv head
MMA_RULE = {256: 1, 128: 5}
MMA_MAX_SPLITS = 16    # the mma kernel's largest cluster (non-portable)
MMA_FILL_CTAS = 264    # its CTAs to aim for: two on each of the H100's 132 SMs


def variant(dtype: torch.dtype, D: int, q_per_kv: int) -> str:
    """The kernel that computes one launch of decode attention of ``dtype``
    at head dim ``D`` with ``q_per_kv`` (at most MAX_G) query heads per kv
    head, by ``MMA_RULE``: mma for bf16 at D = 256 (any q_per_kv: its n = 8
    columns hold up to 8 heads) and at D = 128 from q_per_kv 5; split_kv
    for everything else: float32, whose products mma.sync does not take,
    and bf16 at D = 32, 64 and 112 and at D = 128 below q_per_kv 5. Phase 1
    of chip_smoke.py times both kernels at every registered architecture's
    decode shape (the ``k3_rule`` line): mma was faster at paligemma-3b's
    (8, 256), qwen2-7b's (7, 128) and llama4-maverick's (5, 128), slower at
    q_per_kv 1 and 2 and mixed at granite-3-8b's (4, 128)."""
    if not 1 <= q_per_kv <= MAX_G:
        raise ValueError(f"decode_attention: one launch takes 1..{MAX_G} query heads per kv "
                         f"head, not {q_per_kv}")
    if dtype == torch.bfloat16 and q_per_kv >= MMA_RULE.get(D, MAX_G + 1):
        return "mma"
    return "split_kv"


def splits(S: int) -> int:
    """split_kv's CTAs per (sequence, kv head): one per 512 cache positions,
    1 to 8 (4 at S = 2048). It depends on the allocated length S alone,
    never on ``lengths``, which stay on the card."""
    return max(1, min(MAX_SPLITS, -(-S // KEYS_PER_SPLIT)))


def mma_splits(rows: int, S: int) -> int:
    """The mma kernel's CTAs per (sequence, kv head) for ``rows`` = B * Hkv
    of them and a cache of S positions: the largest power of two up to 16
    with rows * splits at most MMA_FILL_CTAS and no more than S's 64-key
    tiles (16 for paligemma's one tenant, rows 4, and for its merged step,
    rows 16; 1 from rows 133 on). A fixed rule on the shapes, never on
    ``lengths``, which stay on the card."""
    n = 1
    tiles = -(-S // KEY_TILE)
    while n * 2 <= MMA_MAX_SPLITS and rows * n * 2 <= MMA_FILL_CTAS and n * 2 <= tiles:
        n *= 2
    return n


def launch_splits(kind: str, rows: int, S: int) -> int:
    """CTAs per (sequence, kv head) of one launch of ``kind``: ``mma_splits``
    for mma, ``splits`` for split_kv (single_pass ignores it)."""
    return mma_splits(rows, S) if kind == "mma" else splits(S)


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


def mma_ring_bytes(D: int) -> int:
    """Dynamic shared memory of the mma kernel at head dim D (bf16): its
    ring of 64-key tiles of K and V whose rows are padded by 16 bytes (2 D +
    16 bytes a row, so the eight rows one ldmatrix reads lie in eight bank
    groups), two stages where they fit in 72 KB (three CTAs a
    multiprocessor), else one (D = 256). The source's
    ``repro_decode_attention_mma_smem`` answers the same on the card."""
    tile = KEY_TILE * (2 * D + 16)
    stages = 2 if 4 * tile <= 72 * 1024 else 1
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

    Launches a CUDA kernel on the tensors' card: ``variant``'s at each
    launch's group size, or ``kernel`` where given (how ``chip_smoke.py``
    times the previous kernels and holds mma at shapes its rule does not
    take), once per head group (``head_groups``: one launch up to 8 query
    heads per kv head); raises on anything the kernel does not take
    (device, dtype, layout, head dim, Hq not a multiple of Hkv).
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
    if kernel is not None and kernel not in VARIANT_CODES:
        raise ValueError(f"decode_attention: no kernel {kernel!r}")
    if kernel == "single_pass" and D not in SINGLE_PASS_HEAD_DIMS:
        raise ValueError(f"decode_attention: the single_pass kernel takes head dims "
                         f"{SINGLE_PASS_HEAD_DIMS} only, not {D}")
    if kernel == "mma" and (q.dtype != torch.bfloat16 or D not in MMA_HEAD_DIMS):
        raise ValueError(f"decode_attention: the mma kernel takes bf16 at head dims "
                         f"{MMA_HEAD_DIMS} only, not {q.dtype} D={D}")
    scale = float(scale if scale is not None else D ** -0.5)
    return grouped(q, Hkv, lambda qg: _launch(
        qg, k_cache, v_cache, lengths, kernel or variant(q.dtype, D, qg.shape[1] // Hkv), scale))


def launch_variants(dtype: torch.dtype, D: int, q_per_kv: int) -> List[str]:
    """The kernel of each launch of one call (``head_groups`` order) by
    ``variant``'s rule at the launch's group size."""
    return [variant(dtype, D, hi - lo) for lo, hi in head_groups(q_per_kv)]


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
            _build.DTYPE_CODES[q.dtype], VARIANT_CODES[kind], launch_splits(kind, B * Hkv, S),
            scale, _build.stream_of(q))
    _build.check_status(lib, "decode_attention", status)
    counter.launched(kind)
    return out

"""The host side and the arithmetic of K1's and K3's Hopper kernels.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions. What the CPU can check is what surrounds them,
which the wrappers expose as pure Python:

* the routing rules (``batched_gemm.variant``, ``decode_attention.variant``
  and ``splits``);
* K1's wgmma tiles, computed from the tile index as the kernel computes them:
  every output element stored exactly once, no tile storing outside its own
  problem;
* the key ranges of K3's cluster ranks and the K ranges of K1's simt
  cluster ranks: each covers its axis exactly once, in rank order;
* the arithmetic those splits bring, emulated in plain torch: K3's partial
  softmax (m, l, acc) per rank combined in rank order, and K1's partial
  products per K range summed in rank order, held against the Pallas kernels
  in interpret mode, ``repro.kernels.ref`` and the port's plain versions, at
  ``chip_smoke.py``'s tolerances.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batched_gemm import batched_gemm as pallas_batched_gemm  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402

from repro_torch.kernels import batched_gemm as tbg  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

K1_SHAPES = [(R, M, K, N) for R, M, K, N in chip_smoke.K1_CASES]
DECODE_CASES = [
    # B, Hq, Hkv, S, D, lengths: tests/test_torch_kernels_attention.py's
    # decode cases (length 0, q_per_kv 7 included), and stablelm's shape
    (3, 8, 2, 300, 64, [300, 17, 128]),
    (3, 8, 2, 300, 64, [1, 1, 1]),
    (2, 14, 2, 96, 128, [96, 33]),
    (2, 4, 2, 64, 32, [0, 10]),
    (4, 32, 32, 2048, 64, [0, 1, 1040, 2048]),
    (2, 7, 1, 777, 64, [449, 65]),
]


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype,K,N,want", [
    (torch.bfloat16, 2048, 5632, "wgmma"),    # scheduler run 2's MLP shape
    (torch.bfloat16, 2056, 5640, "wgmma"),    # K and N tails inside a tile
    (torch.bfloat16, 8, 40, "wgmma"),
    (torch.bfloat16, 1152, 128, "wgmma"),
    (torch.float32, 1152, 128, "simt"),       # run 1: float32 never takes TF32
    (torch.float32, 2048, 5632, "simt"),
    (torch.float32, 70, 33, "simt"),
    (torch.bfloat16, 70, 33, "simt"),         # rows not 16-byte multiples
    (torch.bfloat16, 512, 1, "simt"),         # the matvec
    (torch.bfloat16, 12, 8, "simt"),
    (torch.bfloat16, 0, 8, "simt"),           # nothing to load
], ids=str)
def test_batched_gemm_variant(dtype, K, N, want):
    assert tbg.variant(dtype, K, N) == want


@pytest.mark.parametrize("M,rows", [(1, 64), (16, 64), (64, 64), (65, 128), (100, 128),
                                    (1024, 128)])
def test_wgmma_tile_rows(M, rows):
    assert tbg.wgmma_tile_rows(M) == rows


@pytest.mark.parametrize("K,want", [(0, 1), (70, 1), (256, 1), (511, 1), (512, 2), (1023, 2),
                                    (1024, 4), (1152, 4), (2048, 4)])
def test_simt_splits_follow_K_alone(K, want):
    assert tbg.simt_splits(K) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", [64, 128])
def test_decode_variant_is_split_kv(dtype, D):
    """split_kv at D 64 and 128 up to 4 query heads a kv head (stablelm's,
    granite-moe's, gemma3's and granite-3-8b's ratios), for float32 at every
    ratio; bf16 at D 128 from 5 heads takes the mma kernel."""
    for g in range(1, tda.MAX_G + 1):
        mma = dtype == torch.bfloat16 and D == 128 and g >= 5
        assert tda.variant(dtype, D, g) == ("mma" if mma else "split_kv")


@pytest.mark.parametrize("S,want", [(1, 1), (64, 1), (512, 1), (513, 2), (600, 2), (777, 2),
                                    (1024, 2), (2048, 4), (4096, 8), (32768, 8)])
def test_decode_splits_follow_S_alone(S, want):
    assert tda.splits(S) == want


# ----------------------------------------------------------------- K1 wgmma tiles
def _tile_layouts():
    out = []
    for R, M, K, N in K1_SHAPES:
        out.append((R, M, N))
    for M in (1, 16, 100, 129):
        for R in (1, 3, 8):
            out.append((R, M, 40))
    out += [(1, 645, 5632), (2, 300, 5640)]
    return out


TILE_LAYOUTS = _tile_layouts()


@pytest.mark.parametrize("R,M,N", TILE_LAYOUTS, ids=str)
def test_wgmma_tiles_store_each_output_once_inside_its_problem(R, M, N):
    bm = tbg.wgmma_tile_rows(M)
    covered = np.zeros((R * M, N), np.int64)
    for r, row0, row_end, c0, c1 in tbg.wgmma_tiles(R, M, N):
        assert r * M <= row0 < row_end <= (r + 1) * M, "a tile stores outside its problem"
        assert row_end - row0 <= bm and (row0 - r * M) % bm == 0
        assert c0 % tbg.WGMMA_COLUMNS == 0 and c0 < c1 <= min(c0 + tbg.WGMMA_COLUMNS, N)
        covered[row0:row_end, c0:c1] += 1
    assert np.all(covered == 1)


@pytest.mark.parametrize("R,M,N", TILE_LAYOUTS[::4], ids=str)
def test_wgmma_tile_walk_computes_the_plain_product(R, M, N):
    """Each tile's rows, read from the flat (R*M, K) x as the kernel's 2-D
    map reads them (the rows past row_end belong to the next problem),
    times its problem's w, stored only up to row_end: the plain product."""
    K = 24
    rng = np.random.default_rng(R * M + N)
    x = torch.from_numpy(rng.standard_normal((R, M, K), np.float32))
    w = torch.from_numpy(rng.standard_normal((R, K, N), np.float32))
    flat = x.reshape(R * M, K)
    bm = tbg.wgmma_tile_rows(M)
    got = torch.full((R * M, N), float("nan"))
    for r, row0, row_end, c0, c1 in tbg.wgmma_tiles(R, M, N):
        rows = flat[row0:row0 + bm]  # may run into problem r + 1
        prod = rows @ w[r][:, c0:c1]
        got[row0:row_end, c0:c1] = prod[:row_end - row0]
    torch.testing.assert_close(got.reshape(R, M, N), ref.batched_gemm(x, w), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- split ranges
@pytest.mark.parametrize("K", [0, 8, 16, 70, 128, 256, 300, 512, 1152, 2056])
@pytest.mark.parametrize("splits", [None, 1, 2, 4])
def test_simt_k_ranges_cover_K_once_in_rank_order(K, splits):
    ranges = tbg.simt_k_ranges(K, splits)
    assert len(ranges) == (tbg.simt_splits(K) if splits is None else splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for a0, a1 in ranges:
        assert a0 <= a1 and (a0 == K or a0 % tbg.SIMT_BK == 0)


@pytest.mark.parametrize("L,S", [(L, S) for S in (64, 600, 777, 2048)
                                 for L in (0, 1, 63, 64, 65, 777, 2048) if L <= S])
def test_decode_key_ranges_cover_the_live_prefix_once(L, S):
    n = tda.splits(S)
    ranges = tda.key_ranges(L, n)
    assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == L
    covered = np.zeros(L, np.int64)
    for (a0, a1) in ranges:
        assert a0 <= a1 and (a0 == L or a0 % tda.KEY_TILE == 0)
        covered[a0:a1] += 1
    assert np.all(covered == 1)
    longest = max(a1 - a0 for a0, a1 in ranges)
    assert longest <= -(-(-(-L // tda.KEY_TILE)) // n) * tda.KEY_TILE  # ~ L / splits


# ----------------------------------------------------------------- K3 split-KV arithmetic
def emulate_split_kv(q, k, v, lengths, n_splits, scale=None):
    """K3's split_kv kernel in plain torch: each rank's partial (m, l, acc)
    over its key range in float32 (m the running max of the scaled scores,
    l the sum of exp(s - m), acc the weighted sum of V rows); then every
    output is combined from the partials in rank order, rescaled to the
    largest m; 0 where no key is live; rounded once to q's dtype."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, Hkv, g, D)
    out = torch.zeros((B, Hkv, g, D))
    for b in range(B):
        L = int(np.clip(int(lengths[b]), 0, S))
        parts = []
        for a0, a1 in tda.key_ranges(L, n_splits):
            kf, vf = k[b, :, a0:a1].float(), v[b, :, a0:a1].float()
            s = torch.einsum("hgd,hkd->hgk", qf[b], kf) * scale
            m = s.amax(-1) if a1 > a0 else torch.full((Hkv, g), ref.NEG_INF)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgk,hkd->hgd", p, vf)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        acc, l = torch.zeros((Hkv, g, D)), torch.zeros((Hkv, g))
        for m, lq, aq in parts:  # rank order
            f = torch.exp(m - mx)
            acc = acc + aq * f[..., None]
            l = l + lq * f
        out[b] = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def _decode_inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("how", ["splits(S)", "3", "8"])
def test_split_kv_arithmetic_fits_pallas_oracle_and_plain_version(case, how):
    B, Hq, Hkv, S, D, lengths = case
    n = tda.splits(S) if how == "splits(S)" else int(how)
    q, kc, vc = _decode_inputs(len(lengths) + S, B, Hq, Hkv, S, D)
    lens = np.asarray(lengths, np.int32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, lens)]
    got = emulate_split_kv(*t, n).numpy()
    rtol, atol = chip_smoke.TOL["torch.float32"]
    plain = ref.decode_attention(*t).numpy()
    np.testing.assert_allclose(got, plain, rtol=rtol, atol=atol)
    j = [jnp.asarray(a) for a in (q, kc, vc, lens)]
    pallas = np.asarray(pallas_decode(*j, bkv=min(512, S), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=rtol, atol=atol)
    live = lens > 0  # the jnp oracle averages uniformly over a length-0 row
    oracle = np.asarray(jref.decode_attention(*j))
    np.testing.assert_allclose(got[live], oracle[live], rtol=rtol, atol=atol)
    assert np.all(got[~live] == 0.0)


@pytest.mark.parametrize("case", DECODE_CASES[::2], ids=str)
def test_split_kv_arithmetic_in_bf16_fits_the_plain_version(case):
    B, Hq, Hkv, S, D, lengths = case
    q, kc, vc = _decode_inputs(7 + S, B, Hq, Hkv, S, D)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc)]
    lens = torch.from_numpy(np.asarray(lengths, np.int32))
    got = emulate_split_kv(*t, lens, tda.splits(S))
    assert got.dtype == torch.bfloat16
    rtol, atol = chip_smoke.TOL["torch.bfloat16"]
    torch.testing.assert_close(got.float(), ref.decode_attention(*t, lens).float(), rtol=rtol,
                               atol=atol)


def test_split_kv_ignores_rows_past_the_live_length():
    """Stale NaN past L never meets a zero weight: the emulation reads only
    each rank's live range, as the kernel copies only the live rows."""
    q, kc, vc = _decode_inputs(3, 2, 4, 4, 2048, 64)
    lens = torch.tensor([700, 65], dtype=torch.int32)
    kt, vt = torch.from_numpy(kc), torch.from_numpy(vc)
    kt[0, :, 700:] = float("nan")
    vt[1, :, 65:] = float("nan")
    got = emulate_split_kv(torch.from_numpy(q), kt, vt, lens, tda.splits(2048))
    assert torch.isfinite(got).all()


# ----------------------------------------------------------------- K1 simt split-K arithmetic
def emulate_simt(x, w):
    """K1's simt kernel in plain torch: each cluster rank's product over
    its K range in float32, the partials summed in rank order, rounded once
    to x's dtype."""
    K = x.shape[2]
    xf, wf = x.float(), w.float()
    total = None
    for k0, k1 in tbg.simt_k_ranges(K):
        part = xf[:, :, k0:k1] @ wf[:, k0:k1]
        total = part if total is None else total + part
    return total.to(x.dtype)


@pytest.mark.parametrize("shape", K1_SHAPES, ids=str)
def test_simt_split_k_fits_the_pallas_kernel(shape):
    R, M, K, N = shape
    rng = np.random.default_rng(K1_SHAPES.index(shape))
    x = rng.standard_normal((R, M, K), np.float32)
    w = rng.standard_normal((R, K, N), np.float32)
    got = emulate_simt(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    rtol, atol = chip_smoke.gemm_tol(torch.float32, K)
    want = np.asarray(pallas_batched_gemm(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jref.batched_gemm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=rtol, atol=atol)


"""The host side of the port's tensor-core kernels (K2 and K4 on wgmma).

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against their plain versions. What the CPU can check is what
surrounds them and the one new rounding they bring:

* the routing predicates that pick the wgmma or the CUDA-core kernel from
  dtype and shape before a launch;
* K2's host-built tile table: every row of every row block covered once,
  no tile storing past its block's end, each tile carrying its block's
  group, and a walk over the table computing what the plain version does;
* K4's bf16 arithmetic, emulated in plain torch (S in float32 from bf16 Q
  and K, P rounded to bf16 before P V, float32 accumulation, 64-key tiles
  with an online softmax): it lies within ``chip_smoke.py``'s bf16
  tolerance of the Pallas kernel in interpret mode (which rounds P to the
  value dtype the same way) and of the port's plain version.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.config import ScheduleConfig  # noqa: E402
from repro_torch.core import SuperKernelCache  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import grouped_gemm as tgg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BF16_TOL = chip_smoke.TOL["torch.bfloat16"]  # (rtol, atol)
ATTENTION_CASES = [
    # B, Hq, Hkv, S, D: tests/test_torch_kernels_attention.py's cases
    (2, 4, 4, 128, 64),
    (2, 8, 2, 160, 64),
    (1, 8, 1, 96, 32),
    (2, 4, 2, 64, 128),
    (1, 7, 1, 80, 64),
    (1, 8, 1, 130, 256),  # paligemma-3b's GQA ratio and head dim: four boxes a row
]


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype,K,N,want", [
    (torch.bfloat16, 2048, 5632, "wgmma"),     # scheduler run 2's MLP shape
    (torch.bfloat16, 2056, 5640, "wgmma"),     # K and N tails inside a tile
    (torch.bfloat16, 48, 40, "wgmma"),
    (torch.bfloat16, 24, 8, "wgmma"),
    (torch.float32, 2048, 5632, "cuda_core"),  # float32 never takes TF32
    (torch.float32, 48, 40, "cuda_core"),
    (torch.bfloat16, 70, 33, "cuda_core"),     # rows not 16-byte multiples
    (torch.bfloat16, 2048, 5641, "cuda_core"),
    (torch.bfloat16, 12, 8, "cuda_core"),
    (torch.bfloat16, 0, 8, "cuda_core"),       # nothing to load
], ids=str)
def test_grouped_gemm_variant(dtype, K, N, want):
    assert tgg.variant(dtype, K, N) == want


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.float32, 64, "cuda_core"),
    (torch.float32, 128, "cuda_core"),
    (torch.bfloat16, 32, "cuda_core"),
], ids=str)
def test_flash_attention_variant(dtype, D, want):
    assert tfa.variant(dtype, D) == want


def test_counter_counts_launches_by_variant():
    c = _build.OpCounter()
    for v in ("wgmma", "wgmma", "cuda_core"):
        c.launched(v)
    assert c.launches == 3 and c.variants == {"wgmma": 2, "cuda_core": 1}
    c.reset()
    assert c.launches == 0 and c.variants == {}


# ----------------------------------------------------------------- K2 tile table
def _run2_layouts():
    """(name, block_groups, T) for the layouts ``SuperKernelCache.ragged_layout``
    gives the row counts of scheduler run 2's trace (``chip_smoke.ragged_trace``),
    merged as runs of 2-6 consecutive arrivals, plus PERF.md's median
    dispatch M = [981, 140]."""
    sizes = [m for tick in chip_smoke.ragged_trace(0) for _, m in tick]
    merges = [sizes[i:i + n] for n, i in ((2, 0), (3, 5), (4, 11), (5, 20), (6, 30))]
    merges.append([981, 140])
    cache = SuperKernelCache(ScheduleConfig())
    out = []
    for m in merges:
        _, t_bucket, bg, _ = cache.ragged_layout(m)
        out.append((f"run2 M={m}", bg, t_bucket))
    return out


def _group_layouts():
    out = []
    for sizes in chip_smoke.GROUP_SIZES:
        for bm in (32, 96, 128):
            _, bg, T = tgg.make_group_layout(np.asarray(sizes), bm=bm)
            out.append((f"sizes={sizes} bm={bm}", bg, T))
    return out


LAYOUTS = [(name, bg, T, T // len(bg)) for name, bg, T in _group_layouts() + _run2_layouts()]


@pytest.mark.parametrize("layout", LAYOUTS, ids=[lay[0] for lay in LAYOUTS])
@pytest.mark.parametrize("tile_rows", sorted(set(tgg.TILE_ROWS.values())))
def test_tile_table_covers_each_row_once_within_its_block(layout, tile_rows):
    _, bg, T, bm = layout
    table = tgg.tile_table(bg, bm, tile_rows)
    assert table.dtype == np.int32 and table.shape[1] == 3
    row0, row_end, group = table[:, 0].astype(np.int64), table[:, 1].astype(np.int64), table[:, 2]
    block = row0 // bm
    assert np.all(row_end > row0) and np.all(row_end - row0 <= tile_rows)
    assert np.all(row_end <= (block + 1) * bm), "a tile stores past its row block's end"
    assert np.array_equal(group, np.asarray(bg)[block]), "a tile's group is not its block's"
    covered = np.zeros(T, np.int64)
    for a, b in zip(row0, row_end):
        covered[a:b] += 1
    assert np.all(covered == 1)


@pytest.mark.parametrize("layout", LAYOUTS[::3], ids=[lay[0] for lay in LAYOUTS[::3]])
def test_tile_walk_computes_the_plain_product(layout):
    """Each tile's rows times its group's w, as the kernels walk the table,
    is the plain version's output (tail blocks of group 0 included)."""
    _, bg, T, bm = layout
    G = int(np.max(bg)) + 1
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((T, 16), np.float32))
    w = torch.from_numpy(rng.standard_normal((G, 16, 8), np.float32))
    want = ref.grouped_gemm(x, w, bg, bm)
    for tile_rows in tgg.TILE_ROWS.values():
        got = torch.full_like(want, float("nan"))
        for r0, r1, g in tgg.tile_table(bg, bm, tile_rows):
            got[r0:r1] = x[r0:r1] @ w[g]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------- K4 bf16 arithmetic
def emulate_wgmma_attention(q, k, v, *, causal=True, window=0, q_offset=None, tile=64):
    """K4's wgmma variant in plain torch: for each 64-key tile, S = Q K^T in
    float32 from the bf16 inputs, masked; an online softmax in float32; P
    rounded to bf16 before O += P V in float32; O / l, 0 for a row with no
    visible key; the output rounded once to bf16."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    g = Hq // k.shape[1]
    q_offset = Skv - Sq if q_offset is None else q_offset
    scale = D ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    m = torch.full((B, Hq, Sq, 1), ref.NEG_INF)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for j0 in range(0, Skv, tile):
        kt, vt = kf[:, :, j0:j0 + tile], vf[:, :, j0:j0 + tile]
        mask = ref._mask(Sq, kt.shape[2], q_offset, causal, window, j0, q.device)
        s = torch.where(mask, qf @ kt.transpose(-1, -2), ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp((m - m_new) * scale)
        live = mask & (m_new > ref.NEG_INF)
        p = torch.where(live, torch.exp((s - m_new) * scale), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0).to(q.dtype)


def _bf16_qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    return ts, js


def _assert_within_bf16_tol(got, want):
    rtol, atol = BF16_TOL
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ATTENTION_CASES, ids=str)
@pytest.mark.parametrize("window", [0, 32])
def test_wgmma_rounding_fits_the_pallas_kernel_and_the_plain_version(case, window):
    B, Hq, Hkv, S, D = case
    (q, k, v), (qj, kj, vj) = _bf16_qkv(11, B, Hq, Hkv, S, S, D)
    got = emulate_wgmma_attention(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16
    pallas = pallas_flash(qj, kj, vj, causal=True, window=window, bq=64, bkv=64, interpret=True)
    plain = ref.attention(q, k, v, causal=True, window=window)
    _assert_within_bf16_tol(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)))
    _assert_within_bf16_tol(got.float().numpy(), plain.float().numpy())


@pytest.mark.parametrize("Sq,Skv,q_offset,window", [
    (64, 200, 100, 0),   # a chunk of a prefill at a runtime offset
    (40, 40, 0, 0),      # fewer keys than one tile
    (100, 300, 200, 48),  # ragged lengths, windowed
    (16, 64, -8, 0),     # the first rows see no key: 0
])
def test_wgmma_rounding_fits_the_plain_version_at_runtime_offsets(Sq, Skv, q_offset, window):
    (q, k, v), _ = _bf16_qkv(12, 1, 4, 2, Sq, Skv, 64)
    got = emulate_wgmma_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    plain = ref.attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    _assert_within_bf16_tol(got.float().numpy(), plain.float().numpy())
    if q_offset < 0:
        assert torch.all(got[:, :, :-q_offset] == 0)

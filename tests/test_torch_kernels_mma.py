"""The host side and the arithmetic of K3's mma kernel and of K4's wgmma
kernel at the padded head dim 112.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against their plain versions. What the CPU can check is what surrounds them,
which the wrappers keep in pure Python, and the arithmetic they bring:

* the routing rules: ``decode_attention.variant(dtype, D, q_per_kv)`` over
  every registered architecture's shape, ``flash_attention.variant`` and
  ``bwd_variant`` at D = 112;
* ``mma_splits``: at most the cluster size, a fixed rule on (B * Hkv, S)
  that fills the card, never decided by ``lengths`` (a launch with its C
  call stood in for records the split count it is given);
* the mma kernel's ring (``mma_ring_bytes``): it fits a block, three CTAs a
  multiprocessor, and holds the warps' and the CTA's partials;
* the mma kernel's arithmetic, emulated in plain torch (each warp's 16-key
  blocks with their own online softmax in log2 units, P rounded to bf16
  before O^T += V^T P^T, warps merged in warp order, ranks in rank order):
  within ``chip_smoke.py``'s bf16 tolerance of the Pallas kernel in
  interpret mode (which rounds P to the value dtype the same way) and of the
  port's plain version, at q_per_kv 1, 7 and 8, the tile and split edges;
* K4's padded layout at D = 112: the rows widened with 16 zero columns, as
  TMA fills them past the tensor, give the product over 112 columns, held
  against the Pallas kernel and the plain version.
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.config import get_config, list_configs  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

BF16_TOL = chip_smoke.TOL["torch.bfloat16"]  # (rtol, atol)
LOG2E = 1.4426950408889634
SMEM_PER_BLOCK = 232448      # an H100 block's most shared memory
SMEM_PER_SM = 233472         # an H100 multiprocessor's
ATTENTION_ARCHS = [a for a in list_configs() if get_config(a).num_heads]


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_decode_variant_at_every_registered_architecture(arch, dtype):
    """mma for bf16 at paligemma-3b's (q_per_kv 8, D 256), qwen2-7b's (7,
    128) and llama4-maverick's (5, 128), where phase 1 timed it faster;
    split_kv for every other registered shape and for float32."""
    cfg = get_config(arch)
    taken = arch in ("paligemma-3b", "qwen2-7b", "llama4-maverick-400b-a17b")
    want = "mma" if dtype == torch.bfloat16 and taken else "split_kv"
    assert tda.variant(dtype, cfg.head_dim, cfg.q_per_kv) == want
    assert tda.launch_variants(dtype, cfg.head_dim, cfg.q_per_kv) == [want]


@pytest.mark.parametrize("q_per_kv", range(1, tda.MAX_G + 1))
@pytest.mark.parametrize("D", tda.SUPPORTED_HEAD_DIMS)
def test_decode_variant_rule_over_one_launchs_group_sizes(D, q_per_kv):
    taken = D == 256 or (D == 128 and q_per_kv >= 5)
    assert tda.variant(torch.bfloat16, D, q_per_kv) == ("mma" if taken else "split_kv")
    assert tda.variant(torch.float32, D, q_per_kv) == "split_kv"


@pytest.mark.parametrize("q_per_kv", [0, 9, 16])
def test_decode_variant_takes_one_launchs_group(q_per_kv):
    with pytest.raises(ValueError, match="one launch"):
        tda.variant(torch.bfloat16, 256, q_per_kv)


@pytest.mark.parametrize("D,q_per_kv,want", [
    (256, 12, ["mma", "mma"]), (256, 16, ["mma", "mma"]), (256, 17, ["mma", "mma", "mma"]),
    (128, 12, ["mma", "split_kv"]), (128, 13, ["mma", "mma"]), (64, 16, ["split_kv"] * 2)])
def test_decode_head_groups_each_take_the_rule(D, q_per_kv, want):
    """Each launch of a ratio above 8 takes the rule at its own group size."""
    assert tda.launch_variants(torch.bfloat16, D, q_per_kv) == want
    assert tda.launch_variants(torch.float32, D, q_per_kv) == ["split_kv"] * len(want)


@pytest.mark.parametrize("dtype,D,fwd,bwd", [
    (torch.bfloat16, 112, "wgmma", "cuda_core"),  # padded forward; no padded backward
    (torch.bfloat16, 64, "wgmma", "wgmma"),
    (torch.bfloat16, 128, "wgmma", "wgmma"),
    (torch.bfloat16, 256, "wgmma", "wgmma"),
    (torch.bfloat16, 32, "cuda_core", "cuda_core"),
    (torch.float32, 112, "cuda_core", "cuda_core"),
], ids=str)
def test_flash_forward_and_backward_rules(dtype, D, fwd, bwd):
    assert tfa.variant(dtype, D) == fwd
    assert tfa.bwd_variant(dtype, D) == bwd


def test_training_route_saves_no_lse_at_d112():
    """``ops._FlashAttention`` allocates an lse only where the backward reads
    one: at bf16 D 112 the forward runs wgmma, the backward cuda_core."""
    assert tfa.variant(torch.bfloat16, 112) == "wgmma"
    assert tfa.bwd_variant(torch.bfloat16, 112) != "wgmma"


# ----------------------------------------------------------------- mma splits
@pytest.mark.parametrize("rows,S,want", [
    (4, 2048, 16),    # paligemma-3b, one tenant's decode: 4 sequences x 1 kv head
    (16, 2048, 16),   # its merged step
    (1, 2048, 16),
    (17, 2048, 8),
    (32, 2048, 8),
    (64, 2048, 4),
    (132, 2048, 2),
    (133, 2048, 1),
    (512, 2048, 1),   # stablelm-1.6b's merged step, were it taken
    (4, 64, 1),       # one tile: one rank
    (4, 65, 2),
    (4, 300, 4),
    (4, 777, 8),
    (4, 32768, 16),
], ids=str)
def test_mma_splits_fill_the_card_within_the_cluster(rows, S, want):
    n = tda.mma_splits(rows, S)
    assert n == want
    assert 1 <= n <= tda.MMA_MAX_SPLITS and n & (n - 1) == 0
    assert n == 1 or rows * n <= tda.MMA_FILL_CTAS
    assert n <= -(-S // tda.KEY_TILE)


@pytest.mark.parametrize("kind", ["mma", "split_kv"])
@pytest.mark.parametrize("B,Hq,Hkv,S", [(4, 8, 1, 2048), (16, 8, 1, 2048), (10, 14, 2, 777)])
def test_launch_splits_are_never_decided_by_lengths(monkeypatch, kind, B, Hq, Hkv, S):
    """The wrapper's path up to the C call, with the call stood in for: the
    split count it passes is the same for empty, ragged and full lengths,
    and is ``launch_splits``' for the launch's shape."""
    seen = []

    class FakeLib:
        def repro_decode_attention(self, *args):
            seen.append((args[11], args[12]))  # variant code, splits
            return 0

    monkeypatch.setattr(tda._build, "check_device", lambda t: None)
    monkeypatch.setattr(tda._build, "load", lambda name: FakeLib())
    monkeypatch.setattr(tda._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(tda.torch.cuda, "device", lambda d: contextlib.nullcontext())
    D = 256
    q = torch.zeros((B, Hq, D), dtype=torch.bfloat16)
    kc = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16)
    rng = np.random.RandomState(B + S)
    for lengths in (np.zeros(B), np.full(B, S), rng.randint(0, S + 1, size=B)):
        lens = torch.from_numpy(lengths.astype(np.int32))
        tda.decode_attention(q, kc, kc.clone(), lens, kernel=kind)
    want = tda.launch_splits(kind, B * Hkv, S)
    launches = len(tda.head_groups(Hq // Hkv))
    assert seen == [(tda.VARIANT_CODES[kind], want)] * (3 * launches)
    assert want <= (tda.MMA_MAX_SPLITS if kind == "mma" else tda.MAX_SPLITS)


@pytest.mark.parametrize("L", [0, 1, 63, 64, 65, 300, 777, 1040, 2047, 2048])
@pytest.mark.parametrize("rows", [4, 16, 64])
def test_mma_ranks_cover_the_live_prefix_once(rows, L):
    n = tda.mma_splits(rows, 2048)
    ranges = tda.key_ranges(L, n)
    covered = np.zeros(L, np.int64)
    for a0, a1 in ranges:
        assert a0 == L or a0 % tda.KEY_TILE == 0
        covered[a0:a1] += 1
    assert np.all(covered == 1)


# ----------------------------------------------------------------- mma ring
@pytest.mark.parametrize("D", tda.MMA_HEAD_DIMS)
def test_mma_ring_fits_three_blocks_and_holds_the_partials(D):
    ring = tda.mma_ring_bytes(D)
    row = 2 * D + 16
    assert ring % (2 * tda.KEY_TILE * row) == 0 and ring <= SMEM_PER_BLOCK
    assert 3 * (ring + 1024) <= SMEM_PER_SM  # + the block's reserved and static bytes
    warps, heads = 4, 8
    assert (warps + 1) * (heads * D + 2 * heads) * 4 <= ring
    # a padded row puts the 16-byte chunk c of keys r .. r + 7 in eight bank groups
    assert len({(r * row // 16) % 8 for r in range(8)}) == 8


# ----------------------------------------------------------------- mma arithmetic
def emulate_mma_decode(q, k, v, lengths, n_splits, scale=None):
    """K3's mma kernel in plain torch (bf16 inputs): every rank walks its
    key range (``key_ranges``) in 64-key tiles; warp w takes keys 16w ..
    16w + 15 of each, scores in float32 from the bf16 inputs scaled into
    log2 units, a running max and sum of its own, P = 2^(x - m) rounded to
    bf16 for O += P V in float32 (the sum of unrounded P); the warps merged
    in warp order, then the ranks in rank order, each rescaled to the
    largest max; 0 where no key is live; rounded once to bf16."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl = torch.tensor((D ** -0.5 if scale is None else scale) * LOG2E, dtype=torch.float32)
    out = torch.zeros((B, Hq, D))

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        acc, l = torch.zeros((G, D)), torch.zeros(G)
        for m, lq, aq in parts:
            f = torch.exp2(m - mx)
            acc, l = acc + aq * f[:, None], l + lq * f
        return mx, l, acc

    for b in range(B):
        L = int(np.clip(int(lengths[b]), 0, S))
        for h in range(Hkv):
            qg = q[b, h * G:(h + 1) * G].float()
            kf, vf = k[b, h].float(), v[b, h].float()
            ranks = []
            for a0, a1 in tda.key_ranges(L, n_splits):
                warps = [[torch.full((G,), ref.NEG_INF), torch.zeros(G), torch.zeros((G, D))]
                         for _ in range(4)]
                for t0 in range(a0, a1, tda.KEY_TILE):
                    n = min(tda.KEY_TILE, a1 - t0)
                    for w, state in enumerate(warps):
                        if 16 * w >= n:
                            continue
                        keys = torch.arange(t0 + 16 * w, t0 + min(16 * w + 16, n))
                        x = (kf[keys] @ qg.T) * sl  # (keys, G)
                        m, l, acc = state
                        m_new = torch.maximum(m, x.amax(0))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new)
                        state[:] = [m_new, l * alpha + p.sum(0),
                                    acc * alpha[:, None] + p.to(torch.bfloat16).float().T @ vf[keys]]
                ranks.append(merge(warps))
            _, l, acc = merge(ranks)
            out[b, h * G:(h + 1) * G] = torch.where(
                l[:, None] > 0, acc / torch.where(l > 0, l, 1.0)[:, None], 0.0)
    return out.to(torch.bfloat16)


def _bf16_decode_inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a, jnp.bfloat16) for a in arrs])


MMA_CASES = [
    # B, Hq, Hkv, S, D, lengths: q_per_kv 8, 7 and 1, at the tile and split edges
    (4, 8, 1, 300, 256, [0, 1, 63, 300]),
    (3, 8, 1, 300, 256, [64, 65, 299]),
    (2, 14, 2, 200, 256, [128, 129]),
    (3, 2, 2, 160, 256, [17, 160, 127]),
    (2, 8, 1, 130, 128, [130, 80]),
    (2, 7, 1, 96, 112, [96, 33]),
    (2, 4, 4, 150, 64, [150, 1]),
]


def _assert_within_bf16_tol(got, want):
    rtol, atol = BF16_TOL
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
@pytest.mark.parametrize("how", ["mma_splits", "1", "16"])
def test_mma_arithmetic_fits_pallas_and_the_plain_version(case, how):
    B, Hq, Hkv, S, D, lengths = case
    n = tda.mma_splits(B * Hkv, S) if how == "mma_splits" else int(how)
    (q, kc, vc), (qj, kj, vj) = _bf16_decode_inputs(S + D + len(lengths), B, Hq, Hkv, S, D)
    lens = np.asarray(lengths, np.int32)
    got = emulate_mma_decode(q, kc, vc, lens, n)
    assert got.dtype == torch.bfloat16
    plain = ref.decode_attention(q, kc, vc, torch.from_numpy(lens))
    _assert_within_bf16_tol(got.float().numpy(), plain.float().numpy())
    pallas = pallas_decode(qj, kj, vj, jnp.asarray(lens), bkv=min(512, S), interpret=True)
    _assert_within_bf16_tol(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)))
    assert torch.all(got[torch.from_numpy(lens) == 0] == 0)


def test_mma_emulation_fails_its_controls():
    """What chip_smoke.py's controls change must move the result beyond the
    tolerance: lengths - 1 and each group's query heads rolled by one."""
    B, Hq, Hkv, S, D = 4, 8, 1, 300, 256
    lengths = np.asarray([1, 64, 65, 300], np.int32)
    (q, kc, vc), _ = _bf16_decode_inputs(5, B, Hq, Hkv, S, D)
    want = ref.decode_attention(q, kc, vc, torch.from_numpy(lengths)).float().numpy()
    n = tda.mma_splits(B * Hkv, S)
    rolled = q.view(B, Hkv, Hq // Hkv, D).roll(1, dims=2).reshape(B, Hq, D)
    for qq, ll in ((q, np.maximum(lengths - 1, 0)), (rolled, lengths)):
        got = emulate_mma_decode(qq, kc, vc, ll, n).float().numpy()
        with pytest.raises(AssertionError):
            _assert_within_bf16_tol(got, want)


# ----------------------------------------------------------------- K4 at D = 112
def _bf16_qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.RandomState(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrs],
            [jnp.asarray(a, jnp.bfloat16) for a in arrs])


def padded_attention(q, k, v, **kw):
    """K4's wgmma layout at a padded head dim: q, k and v widened to whole
    64-column boxes by zeros (what TMA reads past the tensor), attention
    over the wide rows at the true head dim's scale, the first D columns
    kept."""
    D = q.shape[-1]
    pad = -(-D // 64) * 64 - D
    wide = [torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)]
    out = ref.attention(*wide, scale=D ** -0.5, **kw)
    assert torch.all(out[..., D:] == 0)  # V's zero columns give O's
    return out[..., :D]


@pytest.mark.parametrize("Sq,Skv,window,q_offset", [
    (130, 130, 0, None), (100, 300, 0, None), (100, 300, 48, 150), (70, 130, 0, -20)])
def test_padded_d112_layout_is_the_product_over_112(Sq, Skv, window, q_offset):
    (q, k, v), (qj, kj, vj) = _bf16_qkv(Sq + Skv, 1, 8, 1, Sq, Skv, 112)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    got = padded_attention(q, k, v, **kw)
    plain = ref.attention(q, k, v, **kw)
    _assert_within_bf16_tol(got.float().numpy(), plain.float().numpy())
    if q_offset is None:  # the Pallas kernel places queries at the end
        pallas = pallas_flash(qj, kj, vj, causal=True, window=window, bq=64, bkv=64,
                              interpret=True)
        _assert_within_bf16_tol(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)))

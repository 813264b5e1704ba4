"""K3 and K4 at head dims 112 and 256 (the dims zamba2-7b and paligemma-3b
need), against the JAX package's Pallas kernels in interpret mode.

The port's plain versions (``ref.decode_attention``, ``ref.attention``:
what its ops run on the CPU and what its CUDA kernels are held against on
the card) must agree with the Pallas kernels on the same numpy inputs, in
float32, at the reference kernel tests' own tolerance (rtol 2e-5, atol
2e-4: float32 arithmetic, only the order of sums differs). Cases are at
q_per_kv 1 and 8, with lengths at the edges of the kernels' 64-key tiles,
causal and windowed, and with queries at an offset. The host side of the
CUDA kernels at these dims is pure Python and is checked here too: the
``variant`` rules, the head dims each wrapper takes, the single-pass
kernel's refusal, and the split_kv lane layout and ring size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

RTOL, ATOL = 2e-5, 2e-4
NEW_DIMS = (112, 256)
SMEM_PER_BLOCK = 232_448  # an H100 block's most shared memory (227 KB)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------- K3
DECODE_CASES = [
    # B, Hq, Hkv, S, lengths: every length at a 64-key tile edge, and S
    (5, 2, 2, 130, [1, 63, 64, 65, 130]),   # q_per_kv 1
    (5, 8, 1, 130, [1, 63, 64, 65, 130]),   # q_per_kv 8 (paligemma)
    (3, 16, 2, 200, [200, 129, 7]),         # q_per_kv 8, two kv heads
]


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_decode_plain_version_matches_pallas(D, case):
    B, Hq, Hkv, S, lengths = case
    rng = np.random.RandomState(D + S)
    q, kc, vc = _randn(rng, B, Hq, D), _randn(rng, B, Hkv, S, D), _randn(rng, B, Hkv, S, D)
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, lens))).numpy()
    want = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                         bkv=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- K4
FLASH_CASES = [
    # B, Hq, Hkv, Sq, Skv, window: neither length a multiple of 64
    (1, 2, 2, 100, 100, 0),    # q_per_kv 1, causal
    (1, 8, 1, 130, 130, 0),    # q_per_kv 8, causal
    (1, 8, 1, 130, 130, 48),   # windowed
    (2, 2, 2, 70, 190, 0),     # queries at offset Skv - Sq = 120
    (1, 8, 1, 45, 150, 40),    # an offset and a window
]


@pytest.mark.parametrize("D", NEW_DIMS)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_attention_plain_version_matches_pallas(D, case):
    B, Hq, Hkv, Sq, Skv, window = case
    rng = np.random.RandomState(D + Sq)
    q, k, v = _randn(rng, B, Hq, Sq, D), _randn(rng, B, Hkv, Skv, D), _randn(rng, B, Hkv, Skv, D)
    got = ref.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                        window=window).numpy()
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        window=window, bq=64, bkv=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- host side
@pytest.mark.parametrize("D", [64, 112, 128, 256])
def test_both_wrappers_take_the_four_head_dims(D):
    assert D in tda.SUPPORTED_HEAD_DIMS and D in tfa.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 256, "wgmma"),      # paligemma's prefill: four boxes a row
    (torch.bfloat16, 112, "cuda_core"),  # a 224-byte row is not whole boxes
    (torch.float32, 112, "cuda_core"),
    (torch.float32, 256, "cuda_core"),
], ids=str)
def test_flash_attention_variant_at_the_new_dims(dtype, D, want):
    assert tfa.variant(dtype, D) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("D", NEW_DIMS)
def test_decode_variant_is_split_kv_at_the_new_dims(dtype, D):
    assert tda.variant(dtype, D) == "split_kv"


@pytest.mark.parametrize("D", NEW_DIMS)
def test_single_pass_refuses_the_new_dims_with_its_reason(D, monkeypatch):
    """The first kernel keeps its instances at 64 and 128: asked for at
    another head dim, the wrapper raises, naming the dims it takes."""
    monkeypatch.setattr(tda._build, "check_device", lambda t: None)
    q = torch.zeros((1, 8, D))
    kc = torch.zeros((1, 1, 64, D))
    lens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"single_pass kernel takes head dims \(64, 128\) only"):
        tda.decode_attention(q, kc, kc.clone(), lens, kernel="single_pass")


@pytest.mark.parametrize("D", [64, 112, 128, 256])
@pytest.mark.parametrize("q_per_kv", [1, 2, 4, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_kv_lanes_cover_each_column_once(D, q_per_kv, dtype):
    """Every column of a row is held by exactly one lane of a key's group,
    each lane's slice is one 8-byte or 16-byte-multiple vector at an
    aligned offset, and no lane holds more than 64 values of q and of the
    accumulator together."""
    width, lanes, vals = tda.lane_layout(D, q_per_kv)
    assert 32 % lanes == 0 and width == lanes * vals and width >= D
    starts = [lane * vals for lane in range(lanes)]
    cols = [c for s in starts if s < D for c in range(s, s + vals)]
    assert sorted(cols) == list(range(D))
    esize = 2 if dtype == torch.bfloat16 else 4
    nbytes = vals * esize
    assert nbytes == 8 or nbytes % 16 == 0
    assert all((s * esize) % min(nbytes, 16) == 0 for s in starts)
    assert (D * esize) % 16 == 0  # each row, so each slice, stays aligned
    G = next(g for g in (1, 2, 4, 8) if q_per_kv <= g)
    assert G * vals <= 64


@pytest.mark.parametrize("D", [64, 112, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_kv_ring_fits_a_block_and_holds_the_partials(D, dtype):
    """The ring (1-3 stages of a 64-key K and V tile) fits in a block's
    shared memory, and after the key loop holds the 4 warps' and the CTA's
    float32 partials of 8 query heads."""
    ring = tda.ring_bytes(dtype, D)
    tile = 2 * 64 * D * (2 if dtype == torch.bfloat16 else 4)
    assert ring % tile == 0 and 1 <= ring // tile <= 3
    assert ring <= SMEM_PER_BLOCK - 1024
    assert (4 + 1) * 8 * (D + 2) * 4 <= ring
    if dtype == torch.float32 and D == 256:
        assert ring == tile  # one stage: two would need 256 KB

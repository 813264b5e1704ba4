"""K3 ``decode_attention`` at GQA ratios above one launch's 8 query heads
per kv head.

The CUDA kernel takes at most ``MAX_G`` = 8 query heads per kv head in one
launch; the wrapper runs a larger ratio G as ceil(G / 8) launches over
head groups against the same cache, as pure Python that the CPU reaches.
Checked here: the group arithmetic; the grouping around the plain version
equals the plain version on the whole; the wrapper's own path (its launch
stubbed by the plain version) launches once per group, counted by variant;
and the plain version at G = 16 and 12 against the JAX package's Pallas
kernel in interpret mode (float32, the reference kernel tests' tolerance:
rtol 2e-5, atol 2e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402

RTOL, ATOL = 2e-5, 2e-4


def _inputs(seed, B, Hq, Hkv, S, D, lengths):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return q, kc, vc, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("G,want", [
    (1, [(0, 1)]), (7, [(0, 7)]), (8, [(0, 8)]), (9, [(0, 8), (8, 9)]),
    (12, [(0, 8), (8, 12)]), (16, [(0, 8), (8, 16)]), (20, [(0, 8), (8, 16), (16, 20)]),
])
def test_head_groups_cover_each_query_head_once(G, want):
    groups = tda.head_groups(G)
    assert groups == want
    assert len(groups) == -(-G // tda.MAX_G)
    assert all(0 < hi - lo <= tda.MAX_G for lo, hi in groups)


@pytest.mark.parametrize("Hq,Hkv", [(32, 2), (24, 2), (16, 1), (8, 1), (4, 4)])
def test_grouped_plain_version_equals_the_whole(Hq, Hkv):
    """Each group of a kv head's query heads, attended alone against the
    same cache, gives the rows the whole call gives."""
    q, kc, vc, lens = (torch.from_numpy(a) for a in
                       _inputs(Hq, 3, Hq, Hkv, 70, 64, [70, 1, 33]))
    calls = []

    def attend(qg):
        calls.append(qg.shape[1] // Hkv)
        assert qg.is_contiguous()
        return ref.decode_attention(qg, kc, vc, lens)

    got = tda.grouped(q, Hkv, attend)
    want = ref.decode_attention(q, kc, vc, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert calls == [hi - lo for lo, hi in tda.head_groups(Hq // Hkv)]


@pytest.mark.parametrize("Hq,Hkv,launches", [(16, 1, 2), (24, 2, 2), (48, 2, 3), (8, 1, 1)])
def test_wrapper_launches_once_per_head_group(monkeypatch, Hq, Hkv, launches):
    """The wrapper's path with its launch stubbed by the plain version (no
    card here): ceil(G / 8) launches, each counted as split_kv, and the
    whole call's result."""
    monkeypatch.setattr(tda._build, "check_device", lambda t: None)
    seen = []

    def fake_launch(q, k_cache, v_cache, lengths, kind, scale):
        seen.append((q.shape[1] // k_cache.shape[1], kind))
        tda.counter.launched(kind)
        return ref.decode_attention(q, k_cache, v_cache, lengths, scale=scale)

    monkeypatch.setattr(tda, "_launch", fake_launch)
    q, kc, vc, lens = (torch.from_numpy(a) for a in
                       _inputs(Hq + Hkv, 2, Hq, Hkv, 130, 128, [130, 64]))
    ops.reset_counters()
    got = tda.decode_attention(q, kc, vc, lens)
    torch.testing.assert_close(got, ref.decode_attention(q, kc, vc, lens), rtol=0, atol=0)
    assert len(seen) == launches and all(g <= tda.MAX_G and k == "split_kv" for g, k in seen)
    assert tda.counter.launches == launches
    assert tda.counter.variants == {"split_kv": launches}


def test_wrapper_refuses_a_ratio_that_is_not_whole(monkeypatch):
    monkeypatch.setattr(tda._build, "check_device", lambda t: None)
    q, kc, vc, lens = (torch.from_numpy(a) for a in _inputs(0, 1, 12, 5, 64, 64, [3]))
    with pytest.raises(ValueError, match="not a multiple"):
        tda.decode_attention(q, kc, vc, lens)


@pytest.mark.parametrize("Hq,Hkv,D", [(16, 1, 128), (32, 2, 64), (12, 1, 128)])
def test_plain_version_at_large_ratios_matches_pallas(Hq, Hkv, D):
    """The Pallas kernel takes any ratio (it reshapes q to (B, Hkv, G, D));
    so does the port's op: on the CPU, its plain version."""
    q, kc, vc, lens = _inputs(Hq * D, 4, Hq, Hkv, 200, D, [1, 63, 129, 200])
    got = ops.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc, lens))).numpy()
    want = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                         bkv=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)

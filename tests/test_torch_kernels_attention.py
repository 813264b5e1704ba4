"""The port's attention functions against the JAX package's.

The port's plain PyTorch versions (what its ops run on the CPU, and what
its CUDA kernels are held against on the card) must agree with the JAX
Pallas kernels in interpret mode and with the jnp oracle in
``repro.kernels.ref``, on the same numpy inputs, at the JAX kernel tests'
own tolerance (rtol 2e-5, atol 2e-4: float32 arithmetic, only the order of
sums differs). Cases keep away from fully-masked rows, where the jnp
oracle returns the uniform average and the TPU kernels (and the port) 0;
one test pins the port to the kernels there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as cuda_decode  # noqa: E402
from repro_torch.kernels import flash_attention as cuda_flash  # noqa: E402

RTOL, ATOL = 2e-5, 2e-4

CASES = [
    # B, Hq, Hkv, S, D  (the JAX kernel tests' cases, plus q_per_kv = 7)
    (2, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 160, 64),      # GQA 4:1, ragged S
    (1, 8, 1, 96, 32),       # MQA
    (2, 4, 2, 64, 128),      # wide head
    (1, 7, 1, 80, 64),       # GQA 7:1
]


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(seed, B, Hq, Hkv, Sq, Skv, D):
    rng = np.random.RandomState(seed)
    return _randn(rng, B, Hq, Sq, D), _randn(rng, B, Hkv, Skv, D), _randn(rng, B, Hkv, Skv, D)


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("window", [0, 32])
def test_attention_vs_pallas_and_oracle(case, window):
    B, Hq, Hkv, S, D = case
    q, k, v = _qkv(0, B, Hq, Hkv, S, S, D)
    got = ref.attention(_t(q), _t(k), _t(v), causal=True, window=window).numpy()
    kernel = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          window=window, bq=64, bkv=64, interpret=True)
    oracle = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                            window=window)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)


def test_suffix_queries():
    """Sq < Skv (queries are the suffix) must align causally."""
    q, k, v = _qkv(1, 1, 2, 2, 32, 96, 32)
    got = ref.attention(_t(q), _t(k), _t(v), causal=True).numpy()
    kernel = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          bq=32, bkv=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("q_offset", [0, 40, 64])
def test_runtime_q_offset_matches_oracle(q_offset):
    """Chunked prefill: queries at q_offset.. against a longer cache whose
    slots past the chunk are stale; causality must hide them."""
    q, k, v = _qkv(2, 2, 8, 2, 32, 128, 64)
    got = ref.attention(_t(q), _t(k), _t(v), causal=True, q_offset=q_offset).numpy()
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                          q_offset=q_offset)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # the chunked form agrees too
    got_c = ref.attention_chunked(_t(q), _t(k), _t(v), causal=True, q_offset=q_offset,
                                  kv_chunk=48).numpy()
    np.testing.assert_allclose(got_c, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (64, 0.0), (0, 30.0)])
def test_chunked_vs_oracles(window, cap):
    """The O(S) chunked version equals the JAX chunked oracle and the port's dense one."""
    q, k, v = _qkv(3, 2, 4, 2, 200, 200, 32)
    got = ref.attention_chunked(_t(q), _t(k), _t(v), causal=True, window=window,
                                logit_softcap=cap, kv_chunk=64).numpy()
    want = jref.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                  window=window, logit_softcap=cap, kv_chunk=64)
    dense = ref.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                          logit_softcap=cap).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=RTOL, atol=ATOL)


def _decode_inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.RandomState(seed)
    return _randn(rng, B, Hq, D), _randn(rng, B, Hkv, S, D), _randn(rng, B, Hkv, S, D)


@pytest.mark.parametrize("lengths", [[300, 17, 128], [1, 1, 1], [256, 256, 256]], ids=str)
def test_decode_vs_pallas_and_oracle(lengths):
    q, kc, vc = _decode_inputs(4, 3, 8, 2, 300, 64)
    lens = np.asarray(lengths, np.int32)
    got = ref.decode_attention(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    kernel = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                           bkv=128, interpret=True)
    oracle = jref.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=RTOL, atol=ATOL)


def test_decode_gqa7_vs_pallas():
    q, kc, vc = _decode_inputs(5, 2, 14, 2, 96, 128)
    lens = np.asarray([96, 33], np.int32)
    got = ref.decode_attention(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    kernel = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                           bkv=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)


def test_decode_ignores_stale_cache():
    """Cache positions beyond `lengths` must not affect the output: the
    property slot reuse in the serving engine relies on."""
    q, kc, vc = _decode_inputs(6, 1, 2, 1, 64, 32)
    lens = _t(np.asarray([20], np.int32))
    out1 = ref.decode_attention(_t(q), _t(kc), _t(vc), lens)
    kc2, vc2 = _t(kc).clone(), _t(vc).clone()
    kc2[:, :, 20:] = 99.0
    vc2[:, :, 20:] = -99.0
    out2 = ref.decode_attention(_t(q), kc2, vc2, lens)
    assert torch.equal(out1, out2)


def test_fully_masked_rows_are_zero_like_the_tpu_kernels():
    """A length-0 decode row and a query that sees no key give 0, as the
    Pallas kernels do (the jnp oracle would give the uniform average)."""
    q, kc, vc = _decode_inputs(7, 2, 4, 2, 64, 32)
    lens = np.asarray([0, 10], np.int32)
    got = ref.decode_attention(_t(q), _t(kc), _t(vc), _t(lens)).numpy()
    kernel = pallas_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
                           bkv=32, interpret=True)
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, np.asarray(kernel), rtol=RTOL, atol=ATOL)
    # queries placed before every key (negative offset) see nothing
    qa, ka, va = _qkv(8, 1, 2, 2, 4, 16, 32)
    out = ref.attention(_t(qa), _t(ka), _t(va), causal=True, q_offset=-8).numpy()
    chunked = ref.attention_chunked(_t(qa), _t(ka), _t(va), causal=True, q_offset=-8,
                                    kv_chunk=8).numpy()
    assert np.all(out == 0.0) and np.all(chunked == 0.0)


def test_bf16_inputs_compute_in_f32():
    """bf16 in, bf16 out, float32 arithmetic: equals the f32 result of the
    same (bf16-representable) inputs, rounded once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(9, 1, 4, 2, 40, 40, 64))
    got = ref.attention(q, k, v, causal=True)
    want = ref.attention(q.float(), k.float(), v.float(), causal=True).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_ops_route_cpu_tensors_to_the_plain_versions():
    q, k, v = (_t(a) for a in _qkv(10, 1, 4, 2, 24, 24, 64))
    ops.reset_counters()
    out = ops.flash_attention(q, k, v, window=8)
    assert torch.equal(out, ref.attention(q, k, v, window=8))
    qd, kc, vc = (_t(a) for a in _decode_inputs(11, 2, 4, 2, 32, 64))
    lens = _t(np.asarray([5, 32], np.int32))
    assert torch.equal(ops.decode_attention(qd, kc, vc, lens),
                       ref.decode_attention(qd, kc, vc, lens))
    assert ops.COUNTERS["flash_attention"].plain_calls == 1
    assert ops.COUNTERS["decode_attention"].plain_calls == 1
    assert all(c.launches == 0 for c in ops.COUNTERS.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise; they never fall back."""
    q, k, v = (_t(a) for a in _qkv(12, 1, 4, 2, 24, 24, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_flash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_decode.decode_attention(q[:, :, 0], k, v, _t(np.asarray([3], np.int32)))


def test_build_library_names_follow_the_sources():
    """Each CUDA source builds into its own content-hashed library under
    build/repro_torch/; nothing is built at import."""
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("is_cuda", [True, False])
def test_softcap_route_is_an_op_level_rule(is_cuda, cap):
    """K4 takes CUDA tensors without an attention softcap; a softcap goes to
    the plain version, as the reference's op sends it to its jnp path, and
    CPU tensors always do. The rule is decided before any launch."""
    want = "kernel" if is_cuda and cap == 0.0 else "plain"
    assert ops.flash_attention_route(is_cuda, cap) == want


def test_softcap_op_matches_the_reference_op():
    """ops.flash_attention with a softcap equals the reference's op (which
    takes its jnp path there), through one counted plain call."""
    from repro.kernels import ops as jops

    qkv = _qkv(13, 1, 4, 2, 48, 48, 64)
    ops.reset_counters()
    got = ops.flash_attention(*(_t(a) for a in qkv), logit_softcap=30.0)
    want = jops.flash_attention(*(jnp.asarray(a) for a in qkv), logit_softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert ops.COUNTERS["flash_attention"].plain_calls == 1
    assert all(c.launches == 0 for c in ops.COUNTERS.values())


def test_kernel_wrapper_keeps_refusing_a_softcap(monkeypatch):
    """Called directly, K4's wrapper raises on a softcap before it looks at
    anything else (the device check is lifted to reach it on the CPU)."""
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    q, k, v = (_t(a) for a in _qkv(14, 1, 4, 2, 24, 24, 64))
    with pytest.raises(NotImplementedError, match="softcap"):
        cuda_flash.flash_attention(q, k, v, logit_softcap=30.0)

"""The port's WKV6 scan (K5's plain version) against the JAX package's.

The port's plain PyTorch ``ref.wkv6_scan`` (what its ops run on the CPU,
and what the CUDA kernel is held against on the card) must agree with the
Pallas kernel in interpret mode (zero state, the JAX kernel test's cases
and tolerance: rtol 2e-4, atol 2e-3), and with the JAX serving prefill's
pair, the jnp oracle with ``init_state`` plus ``_wkv_final_state``, on a
random state (float32, only the order of sums differs: 1e-5).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6_scan import wkv6_scan as pallas_wkv6  # noqa: E402
from repro.models.rwkv import _wkv_final_state  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6_scan as cuda_wkv6  # noqa: E402

STATE_TOL = 1e-5


def _inputs(seed, BH, T, N, V, u_rows=None):
    """The JAX kernel test's scales: r, k, v 0.5; w, u 0.3."""
    rng = np.random.RandomState(seed)
    r, k = (rng.standard_normal((BH, T, N)).astype(np.float32) * 0.5 for _ in range(2))
    v = rng.standard_normal((BH, T, V)).astype(np.float32) * 0.5
    w = rng.standard_normal((BH, T, N)).astype(np.float32) * 0.3
    u = rng.standard_normal((u_rows or BH, N)).astype(np.float32) * 0.3
    return r, k, v, w, u


def _state(seed, BH, N, V):
    return np.random.RandomState(seed).standard_normal((BH, N, V)).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", [(2, 64, 16, 16), (4, 70, 16, 32), (1, 33, 8, 8)], ids=str)
@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_vs_pallas_interpret(case, chunk):
    BH, T, N, V = case
    r, k, v, w, u = _inputs(0, BH, T, N, V)
    got, state = ref.wkv6_scan(*_t(r, k, v, w, u))
    kernel = pallas_wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=2e-4, atol=2e-3)
    assert state.shape == (BH, N, V) and state.dtype == torch.float32


@pytest.mark.parametrize("case", [(2, 1, 16, 16), (4, 13, 16, 32), (3, 33, 8, 8),
                                  (2, 70, 32, 32)], ids=str)
def test_plain_vs_oracle_and_final_state_scan(case):
    """From a random state, T not a multiple of any chunk: outputs equal the
    jnp oracle's and the final state equals ``_wkv_final_state``'s, the
    state the JAX serving prefill gets from a second scan."""
    BH, T, N, V = case
    r, k, v, w, u = _inputs(1, BH, T, N, V)
    s0 = _state(2, BH, N, V)
    got, state = ref.wkv6_scan(*_t(r, k, v, w, u), init_state=torch.from_numpy(s0))
    j = [jnp.asarray(a) for a in (r, k, v, w, u, s0)]
    want = jref.wkv6_scan(*j[:5], init_state=j[5])
    want_state = _wkv_final_state(j[1], j[2], j[3], j[5])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state), rtol=STATE_TOL,
                               atol=STATE_TOL)


@pytest.mark.parametrize("split", [1, 17, 39])
def test_scan_continues_from_the_carried_state(split):
    """scan(T) equals scan(a) then scan(T - a) from its state, through the
    ops entry point with the state updated in one buffer, as the model's
    chunked prefill does with its cache."""
    BH, T, N = 3, 40, 16
    r, k, v, w, u = _t(*_inputs(3, BH, T, N, N))
    s0 = torch.from_numpy(_state(4, BH, N, N))
    whole, want_state = ops.wkv6_scan(r, k, v, w, u, init_state=s0)
    buf = s0.clone()
    a, _ = ops.wkv6_scan(r[:, :split], k[:, :split], v[:, :split], w[:, :split], u,
                         init_state=buf, final_state=buf)
    b, state = ops.wkv6_scan(r[:, split:], k[:, split:], v[:, split:], w[:, split:], u,
                             init_state=buf, final_state=buf)
    assert state is buf
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(), rtol=STATE_TOL,
                               atol=STATE_TOL)
    np.testing.assert_allclose(buf.numpy(), want_state.numpy(), rtol=STATE_TOL, atol=STATE_TOL)


def test_decode_steps_equal_the_scan_and_the_jax_step():
    """``wkv6_step`` T times equals the scan, and each step the JAX step."""
    BH, T, N = 2, 12, 8
    r, k, v, w, u = _inputs(5, BH, T, N, N)
    want, want_state = ref.wkv6_scan(*_t(r, k, v, w, u))
    state = torch.zeros((BH, N, N))
    jstate = jnp.zeros((BH, N, N), jnp.float32)
    outs = []
    for t in range(T):
        step = (r[:, t], k[:, t], v[:, t], w[:, t], u)
        state, o = ops.wkv6_step(state, *_t(*step))
        jstate, jo = jref.wkv6_step(jstate, *(jnp.asarray(a) for a in step))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=STATE_TOL, atol=STATE_TOL)
        outs.append(o)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), want.numpy(), rtol=STATE_TOL,
                               atol=STATE_TOL)
    np.testing.assert_allclose(state.numpy(), want_state.numpy(), rtol=STATE_TOL, atol=STATE_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), rtol=STATE_TOL, atol=STATE_TOL)


def test_head_views_and_shared_bonus():
    """(B, H, T, N) strided views of (B, T, H, N) projections with a per-head
    u (H, N) give what the (B*H, T, N) copies with u per row give."""
    B, H, T, N = 2, 3, 9, 8
    rng = np.random.RandomState(6)
    r, k, v, w = (torch.from_numpy(rng.standard_normal((B, T, H, N)).astype(np.float32))
                  for _ in range(4))
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (r, k, v, w)]
    got, state = ref.wkv6_scan(*views, u)
    flat = [t.reshape(B * H, T, N) for t in views]
    want, want_state = ref.wkv6_scan(*flat, u.repeat(B, 1))
    assert got.shape == (B, H, T, N)
    assert torch.equal(got.reshape(B * H, T, N), want) and torch.equal(state, want_state)


def test_bf16_inputs_compute_in_f32():
    """bf16 in, bf16 out, float32 state and arithmetic: equals the float32
    scan of the same (bf16-representable) inputs, rounded once."""
    r, k, v, w, u = _t(*_inputs(7, 2, 20, 16, 16))
    rb, kb, vb, wb = (t.to(torch.bfloat16) for t in (r, k, v, w))
    got, state = ref.wkv6_scan(rb, kb, vb, wb, u)
    want, want_state = ref.wkv6_scan(rb.float(), kb.float(), vb.float(), wb.float(), u)
    assert got.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert torch.equal(got, want.to(torch.bfloat16)) and torch.equal(state, want_state)


def test_ops_route_cpu_tensors_to_the_plain_version():
    r, k, v, w, u = _t(*_inputs(8, 2, 10, 8, 8))
    ops.reset_counters()
    out, state = ops.wkv6_scan(r, k, v, w, u)
    want, want_state = ref.wkv6_scan(r, k, v, w, u)
    assert torch.equal(out, want) and torch.equal(state, want_state)
    assert ops.COUNTERS["wkv6_scan"].plain_calls == 1
    ops.wkv6_scan_plain(r, k, v, w, u)
    assert ops.COUNTERS["wkv6_scan"].plain_calls == 2
    assert all(c.launches == 0 for c in ops.COUNTERS.values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never falls back."""
    r, k, v, w, u = _t(*_inputs(9, 2, 10, 64, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_wkv6.wkv6_scan(r, k, v, w, u)

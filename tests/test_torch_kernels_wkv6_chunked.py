"""The arithmetic of K5's chunked kernel, emulated in torch, against the JAX
package's WKV6 scan.

``chunked_scan`` below computes what ``csrc/wkv6_scan.cu``'s ``chunked``
kernel computes, chunk by chunk, in float32: per chunk of ``CHUNK`` steps
from the state S0 entering it, the running products P_t (forward) and Q_s
(backward) of the decays, A[t, s] built for fixed s by multiplying one more
decay per step of t, o_t = (r_t . P_t) S0 + sum_{s<=t} A[t, s] v_s, and
S = diag(P_16) S0 + sum_s (k_s . Q_s)^T v_s; a short last chunk masks its
missing rows (zero r, k, v; decay 1). It is held against the jnp oracle
(outputs, rtol 2e-4, atol 2e-3) and the JAX serving prefill's final-state
scan (state, 1e-5 of the state's largest entry), from a zero and a random
state, and at a zero state against the Pallas kernel in interpret mode (its
test's tolerance, rtol 2e-4, atol 2e-3), under strong decay (products
underflow inside a chunk) and weak decay (d close to 1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.wkv6_scan import wkv6_scan as pallas_wkv6  # noqa: E402
from repro.models.rwkv import _wkv_final_state  # noqa: E402

from repro_torch.kernels import wkv6_scan as cuda_wkv6  # noqa: E402

C = cuda_wkv6.CHUNK
OUT_TOL = dict(rtol=2e-4, atol=2e-3)
# The state is held to 1e-5 of its largest entry, not elementwise: under weak
# decay at T = 777 it grows to tens, where the float32 rounding of the
# reference scan itself (against a float64 scan) exceeds an elementwise 1e-5.
STATE_REL = 1e-5
B, H, N = 2, 2, 64  # the kernel's head size, N = V = 64
# decay logits w ~ N(mean, std): strong (d = exp(-e^w) from ~1e-24 to 0.7;
# 16-step products underflow to 0) and weak (d ~ 0.9997, the state grows)
REGIMES = {"strong": (1.0, 1.0), "weak": (-8.0, 0.5)}


def chunked_scan(r, k, v, w, u, s0=None):
    """The chunked kernel's formulas. r, k, w (BH, T, N); v (BH, T, V); u
    (H, N) or (BH, N) (row bh % rows, as the kernel reads it); s0 (BH, N, V)
    or None. Returns (out (BH, T, V), state (BH, N, V)), float32. Every
    chunk is the same computation on 16 rows, masked where T ends."""
    BH, T, _ = r.shape
    V = v.shape[-1]
    u = u[torch.arange(BH) % u.shape[0]]
    S = torch.zeros((BH, N, V)) if s0 is None else s0.clone()
    out = torch.empty((BH, T, V))
    for t0 in range(0, T, C):
        nt = min(C, T - t0)
        rc, kc = torch.zeros((BH, C, N)), torch.zeros((BH, C, N))
        vc, dc = torch.zeros((BH, C, V)), torch.ones((BH, C, N))
        rc[:, :nt], kc[:, :nt], vc[:, :nt] = r[:, t0:t0 + nt], k[:, t0:t0 + nt], v[:, t0:t0 + nt]
        dc[:, :nt] = torch.exp(-torch.exp(w[:, t0:t0 + nt]))
        P = torch.ones((BH, C + 1, N))  # P[t] = prod_{j<t} d_j
        for t in range(C):
            P[:, t + 1] = P[:, t] * dc[:, t]
        Q = torch.ones((BH, C, N))      # Q[s] = prod_{s<j<C} d_j
        for s in range(C - 2, -1, -1):
            Q[:, s] = Q[:, s + 1] * dc[:, s + 1]
        A = torch.zeros((BH, C, C))     # A[t, s], zero above the diagonal
        for s in range(C):
            kd = kc[:, s]               # k_s . prod_{s<j<t} d_j
            A[:, s, s] = (rc[:, s] * u * kc[:, s]).sum(-1)
            for t in range(s + 1, C):
                A[:, t, s] = (rc[:, t] * kd).sum(-1)
                kd = kd * dc[:, t]
        o = torch.bmm(rc * P[:, :C], S) + torch.bmm(A, vc)
        S = P[:, C, :, None] * S + torch.bmm((kc * Q).transpose(1, 2), vc)
        out[:, t0:t0 + nt] = o[:, :nt]
    return out, S


def _inputs(seed, T, regime, u_rows):
    """(B*H, T, N) r, k, v ~ 0.5 N(0, 1), w in ``regime``, u ~ 0.3 N(0, 1)
    with ``u_rows`` rows (H: per head, shared by the batch; B*H: per row)."""
    rng = np.random.RandomState(seed)
    mean, std = REGIMES[regime]
    r, k, v = (rng.standard_normal((B * H, T, N)).astype(np.float32) * 0.5 for _ in range(3))
    w = (rng.standard_normal((B * H, T, N)) * std + mean).astype(np.float32)
    u = rng.standard_normal((u_rows, N)).astype(np.float32) * 0.3
    return r, k, v, w, u


def _state(seed):
    return np.random.RandomState(seed).standard_normal((B * H, N, N)).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _check(name, got, want, tol):
    got = got.numpy()
    assert np.isfinite(got).all(), f"{name}: non-finite values"
    np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **tol)


def _state_tol(want):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    return dict(rtol=STATE_REL, atol=STATE_REL * scale)


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("u_rows", [H, B * H], ids=["u(H,N)", "u(BH,N)"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 33, 777])
def test_chunk_math_vs_oracle_and_final_state_scan(T, u_rows, regime):
    """From a zero and a random state: outputs equal the jnp oracle's, the
    state equals the JAX prefill's final-state scan."""
    r, k, v, w, u = _inputs(T, T, regime, u_rows)
    u_bh = np.tile(u, (B * H // u_rows, 1))  # the oracle takes a row per head
    for s0 in (None, _state(T + 1)):
        got, state = chunked_scan(*_t(r, k, v, w, u), None if s0 is None else _t(s0)[0])
        init = np.zeros((B * H, N, N), np.float32) if s0 is None else s0
        j = [jnp.asarray(a) for a in (r, k, v, w, u_bh, init)]
        what = f"T={T} {regime} {'zero' if s0 is None else 'random'} state"
        _check(f"{what} out", got, jref.wkv6_scan(*j[:5], init_state=j[5]), OUT_TOL)
        want_state = _wkv_final_state(j[1], j[2], j[3], j[5])
        _check(f"{what} state", state, want_state, _state_tol(want_state))


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("T", [1, 15, 16, 17, 33, 777])
def test_chunk_math_vs_pallas_interpret(T, regime):
    """At a zero state, against the Pallas kernel in interpret mode."""
    r, k, v, w, u = _inputs(100 + T, T, regime, B * H)
    got, _ = chunked_scan(*_t(r, k, v, w, u))
    want = pallas_wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), interpret=True)
    _check(f"T={T} {regime}", got, want, OUT_TOL)


def test_strong_decay_underflows_inside_a_chunk():
    """The strong regime does reach what the chunked form must survive:
    16-step decay products that underflow float32 to 0, where dividing by a
    cumulative decay would overflow; the outputs stay finite."""
    r, k, v, w, u = _inputs(7, 777, "strong", H)
    d = np.exp(-np.exp(w[:, :768].reshape(B * H, -1, C, N)))
    assert (np.prod(d, axis=2, dtype=np.float32) == 0).any()
    out, state = chunked_scan(*_t(r, k, v, w, u))
    assert torch.isfinite(out).all() and torch.isfinite(state).all()


def test_split_at_a_chunk_boundary_is_bit_identical():
    """512 + 265 steps from the carried state equal the whole 777 bitwise:
    chunk boundaries fall at multiples of 16 from the start of each call,
    so both scans run the same chunks."""
    r, k, v, w, u = _t(*_inputs(8, 777, "weak", H))
    s0 = _t(_state(9))[0]
    whole, whole_state = chunked_scan(r, k, v, w, u, s0)
    a, mid = chunked_scan(r[:, :512], k[:, :512], v[:, :512], w[:, :512], u, s0)
    b, state = chunked_scan(r[:, 512:], k[:, 512:], v[:, 512:], w[:, 512:], u, mid)
    assert torch.equal(torch.cat([a, b], 1), whole) and torch.equal(state, whole_state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 742, 777, 1024, 100_000])
def test_variant_is_chunked_for_every_shape(dtype, T):
    """The wrapper's rule picks the chunked kernel for every dtype and length
    it takes; the sequential kernel runs only when asked for by name."""
    assert cuda_wkv6.variant(dtype, T) == "chunked"
    assert set(cuda_wkv6.VARIANT_CODES) == {"sequential", "chunked"}

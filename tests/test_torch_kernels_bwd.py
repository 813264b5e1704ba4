"""The plain backward functions of K4 and K5 (``ref.attention_bwd``,
``ref.wkv6_scan_bwd``), which the hand-written backward kernels are held
against on the card, against the JAX package: ``jax.vjp`` of
``repro.kernels.ref.attention`` and ``repro.kernels.ref.wkv6_scan`` on the
same numpy inputs and output gradient, and torch autograd through the
port's plain forwards. Also the routing rules the card path follows, as
far as they run on the CPU.

Tolerance: every gradient within 1e-5 of that output's largest magnitude
(absolute), in float32: the formulas against automatic differentiation of
the forward, the same float32 quantities summed in another order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv6_scan as wk  # noqa: E402

TOL = 1e-5


def _close(got, want, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ attention
ATTN_CASES = [  # B, Hq, Hkv, S, D, causal, window
    (2, 4, 4, 37, 32, True, 0),
    (1, 4, 2, 64, 64, True, 0),      # GQA 2
    (1, 8, 1, 50, 16, True, 0),      # GQA 8 (MQA)
    (2, 4, 2, 45, 32, True, 7),      # sliding window
    (1, 2, 1, 33, 16, False, 0),     # non-causal
    (1, 2, 2, 40, 16, False, 9),     # non-causal window
]


def _attn_inputs(B, Hq, Hkv, S, D, seed):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    do = rng.standard_normal((B, Hq, S, D)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_matches_jax_vjp_and_autograd(case):
    B, Hq, Hkv, S, D, causal, window = case
    q, k, v, do = _attn_inputs(B, Hq, Hkv, S, D, seed=S + D)
    out, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal, window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    o = ref.attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    _close(o, out, "forward")
    dq, dk, dv = ref.attention_bwd(_t(q), _t(k), _t(v), o, _t(do), causal=causal, window=window)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        _close(got, want, f"{name} vs jax.vjp")
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    to = ref.attention(tq, tk, tv, causal=causal, window=window)
    gq, gk, gv = torch.autograd.grad(to, (tq, tk, tv), _t(do))
    for got, want, name in ((dq, gq, "dq"), (dk, gk, "dk"), (dv, gv, "dv")):
        _close(got, want.numpy(), f"{name} vs torch autograd")


def test_attention_bwd_keeps_input_dtypes():
    q, k, v, do = (_t(a).to(torch.bfloat16) for a in _attn_inputs(1, 2, 1, 20, 16, 0))
    o = ref.attention(q, k, v)
    grads = ref.attention_bwd(q, k, v, o, do)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_flash_attention_op_differentiates_the_plain_version_on_cpu():
    """On the CPU the op runs the plain version (one plain call, no launch,
    no backward launch) and autograd differentiates it."""
    q, k, v, do = (_t(a).requires_grad_(True) for a in _attn_inputs(1, 4, 2, 24, 16, 1))
    ops.reset_counters()
    o = ops.flash_attention(q, k, v, window=5)
    o.backward(do.detach())
    c, cb = ops.COUNTERS["flash_attention"], ops.COUNTERS["flash_attention_bwd"]
    assert (c.plain_calls, c.launches, cb.launches, cb.plain_calls) == (1, 0, 0, 0)
    want = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(), do.detach(),
                             window=5)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        _close(got, w.numpy(), "grad")


@pytest.mark.parametrize("kw,exc", [
    (dict(q_len=8, kv_len=16), ValueError),           # Sq != Skv
    (dict(q_offset=3), ValueError),                   # a chunked continuation
    (dict(D=48), ValueError),                         # no kernel at D = 48
    (dict(dtype=torch.float16), TypeError),
])
def test_flash_attention_bwd_refuses_what_its_kernel_does_not_take(kw, exc):
    """``check_bwd``, which ``ops.flash_attention`` asks before the forward
    launch of its autograd route, raises: nothing drops to the plain version."""
    D = kw.get("D", 64)
    dtype = kw.get("dtype", torch.bfloat16)
    q = torch.zeros((1, 2, kw.get("q_len", 16), D), dtype=dtype)
    k = torch.zeros((1, 2, kw.get("kv_len", 16), D), dtype=dtype)
    with pytest.raises(exc):
        fa.check_bwd(q, k, q_offset=kw.get("q_offset"))


def test_flash_attention_bwd_takes_every_forward_head_dim():
    """Every head dim and dtype the forward takes has a backward kernel: the
    wgmma kernel at bf16 D 64, 128 and 256 (where the forward's wgmma
    kernel writes the lse it reads), the CUDA-core kernel elsewhere. At bf16
    D 112 the two differ: the forward runs wgmma over a padded row, the
    backward has no padded layout and recomputes the lse."""
    for D in fa.SUPPORTED_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.zeros((1, 2, 8, D), dtype=dtype)
            fa.check_bwd(t, t, q_offset=0)
            want = "wgmma" if dtype == torch.bfloat16 and D in (64, 128, 256) else "cuda_core"
            assert fa.bwd_variant(dtype, D) == want
            fwd = "wgmma" if dtype == torch.bfloat16 and D in (64, 112, 128, 256) else "cuda_core"
            assert fa.variant(dtype, D) == fwd


def test_backward_wrappers_need_a_card():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(q, q, q, q, q)
    r = torch.zeros((2, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        wk.wkv6_scan_bwd(r, r, r, r, torch.zeros((2, 64)), r)


# ------------------------------------------------------------------ wkv6
WKV_CASES = [  # BH, H (rows of u), T, N, V, w mean, w std
    (4, 2, 37, 16, 16, -3.0, 1.0),
    (2, 2, 21, 8, 16, -3.0, 1.0),      # N != V
    (3, 3, 40, 16, 8, 1.0, 1.0),       # strong decay: d_t underflows to 0 (w >~ 4.5)
    (2, 1, 33, 16, 16, -8.0, 0.5),     # weak decay, d ~ 0.9997
    (2, 2, 1, 8, 8, -3.0, 1.0),        # a single step
]


def _wkv_inputs(BH, H, T, N, V, w_mean, w_std, seed):
    rng = np.random.RandomState(seed)
    r = (0.5 * rng.standard_normal((BH, T, N))).astype(np.float32)
    k = (0.5 * rng.standard_normal((BH, T, N))).astype(np.float32)
    v = (0.5 * rng.standard_normal((BH, T, V))).astype(np.float32)
    w = (w_mean + w_std * rng.standard_normal((BH, T, N))).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, N))).astype(np.float32)
    do = rng.standard_normal((BH, T, V)).astype(np.float32)
    return r, k, v, w, u, do


@pytest.mark.parametrize("case", WKV_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wkv6_scan_bwd_matches_jax_vjp_and_autograd(case):
    BH, H, T, N, V, wm, ws = case
    r, k, v, w, u, do = _wkv_inputs(*case, seed=T + N)
    if wm > 0:
        assert float(np.exp(-np.exp(w)).min()) == 0.0  # underflowing decays are exercised

    def jfn(r_, k_, v_, w_, u_):  # u (H, N) broadcast over the batch, as the model's train path
        return jref.wkv6_scan(r_, k_, v_, w_, jnp.tile(u_, (BH // H, 1)))

    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (r, k, v, w, u)))
    jgrads = vjp(jnp.asarray(do))
    o, _ = ref.wkv6_scan(_t(r), _t(k), _t(v), _t(w), _t(u))
    _close(o, out, "forward")
    grads = ref.wkv6_scan_bwd(_t(r), _t(k), _t(v), _t(w), _t(u), _t(do))
    names = ("dr", "dk", "dv", "dw", "du")
    for got, want, name in zip(grads, jgrads, names):
        _close(got, want, f"{name} vs jax.vjp")
    leaves = [_t(a).requires_grad_(True) for a in (r, k, v, w, u)]
    to, _ = ref.wkv6_scan(*leaves)
    tgrads = torch.autograd.grad(to, leaves, _t(do), allow_unused=True)  # T = 1: w unused
    tgrads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, tgrads)]
    for got, want, name in zip(grads, tgrads, names):
        _close(got, want.numpy(), f"{name} vs torch autograd")


def test_wkv6_scan_bwd_takes_the_model_layout_and_dtypes():
    """(B, H, T, N) strided views, bf16 r/k/v with a bf16 w, u (H, N): each
    gradient in its input's shape and dtype, du summed over the batch."""
    r, k, v, w, u, do = _wkv_inputs(4, 2, 19, 16, 16, -3.0, 1.0, seed=3)

    def view(a):  # (B=2, T, H=2, X) storage read as (B, H, T, X)
        return _t(a).reshape(2, 2, 19, -1).transpose(1, 2).contiguous().transpose(1, 2)

    args = [view(a).to(torch.bfloat16) for a in (r, k, v, w)] + [_t(u)]
    grads = ref.wkv6_scan_bwd(*args, view(do).to(torch.bfloat16))
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4 + [torch.float32]


def test_wkv6_scan_bwd_padding_rule_leaves_the_live_gradients():
    """The backward wrapper runs heads of 8-32 zero-padded to 64 (r, k, w,
    u rows; v, do columns): the padded problem's live gradients are the
    unpadded one's and every padded entry of dr, dk, dv and du is 0."""
    r, k, v, w, u, do = _wkv_inputs(2, 2, 23, 16, 8, -3.0, 1.0, seed=4)
    NP, VP = wk.padded_dims(16, 8)

    def pad(a, width):
        out = np.zeros(a.shape[:-1] + (width,), np.float32)
        out[..., :a.shape[-1]] = a
        return out

    want = ref.wkv6_scan_bwd(*(_t(a) for a in (r, k, v, w, u, do)))
    got = ref.wkv6_scan_bwd(_t(pad(r, NP)), _t(pad(k, NP)), _t(pad(v, VP)), _t(pad(w, NP)),
                            _t(pad(u, NP)), _t(pad(do, VP)))
    for g, w_, width in zip(got, want, (16, 16, 8, 16, 16)):
        _close(g[..., :width], w_.numpy(), "live part")
    for g, width in zip((got[0], got[1], got[2], got[4]), (16, 16, 8, 16)):
        assert float(g[..., width:].abs().max()) == 0.0


def test_wkv6_scan_op_differentiates_the_plain_version_on_cpu():
    r, k, v, w, u, do = _wkv_inputs(2, 1, 17, 8, 8, -3.0, 1.0, seed=5)
    leaves = [_t(a).requires_grad_(True) for a in (r, k, v, w, u)]
    ops.reset_counters()
    out, state = ops.wkv6_scan(*leaves)
    out.backward(_t(do))
    c, cb = ops.COUNTERS["wkv6_scan"], ops.COUNTERS["wkv6_scan_bwd"]
    assert (c.plain_calls, c.launches, cb.launches) == (1, 0, 0)
    want = ref.wkv6_scan_bwd(*(t.detach() for t in leaves), _t(do))
    for t, g in zip(leaves, want):
        _close(t.grad, g.numpy(), "grad")


def test_wkv6_scan_bwd_refuses_a_kept_state():
    r = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError):
        wk.check_bwd(r, r, torch.zeros((2, 64, 64)), None)
    with pytest.raises(ValueError):
        wk.check_bwd(r, r, None, torch.zeros((2, 64, 64)))
    with pytest.raises(ValueError):
        wk.check_bwd(torch.zeros((2, 8, 48)), r, None, None)  # no kernel at N = 48
    wk.check_bwd(torch.zeros((2, 8, 32)), torch.zeros((2, 8, 16)), None, None)
    assert wk.bwd_variant(torch.bfloat16, 777) == "cluster"

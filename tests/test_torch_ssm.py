"""The port's Mamba2 (SSD) block against the JAX package's ``repro.models.ssm``.

Seeded numpy inputs and weights go through both, in float32, at rtol/atol
1e-4 (as ``test_torch_models.py``). Cases: the chunked scan at a length
that is not a multiple of the chunk, from a zero and from a given state;
the depthwise causal conv; the block's prefill whole, and split in two
chunks that continue from the first chunk's conv tails and SSM state; and
the one-token decode step over a tenant axis, continuing from a prefill's
caches; and a 4-layer zamba2-shaped model through ``ops`` against its
``plain_kernels`` twin.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402

RTOL = ATOL = 1e-4


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _configs():
    """zamba2's smoke SSM (d_model 64: 4 heads of 32, state 16, conv 4,
    chunk 16), the same in both packages."""
    t = smoke_variant(get_config("zamba2-7b"), d_model=64)
    j = jsmoke(jget_config("zamba2-7b"), d_model=64)
    return t, j


def _params(cfg, seed, R=None):
    """Seeded numpy weights in the reference's layout (leading R if given):
    a decay spread over heads, a non-zero dt bias, D and norm off 1."""
    rng = np.random.RandomState(seed)
    d_inner, H, P, N = ssm.dims(cfg)
    lead = () if R is None else (R,)
    W, d = cfg.ssm.conv_width, cfg.d_model

    def w(*shape, scale=None):
        return _randn(rng, *(lead + shape), scale=scale or 1.0 / np.sqrt(shape[0]))

    return {
        "wz": w(d, d_inner), "wx": w(d, d_inner), "wB": w(d, N), "wC": w(d, N),
        "wdt": w(d, H), "conv_x_w": w(W, d_inner, scale=0.3), "conv_x_b": w(d_inner, scale=0.1),
        "conv_B_w": w(W, N, scale=0.3), "conv_B_b": w(N, scale=0.1),
        "conv_C_w": w(W, N, scale=0.3), "conv_C_b": w(N, scale=0.1),
        "A_log": np.broadcast_to(np.log(np.linspace(1.0, 16.0, H)), lead + (H,))
        .astype(np.float32).copy(),
        "D": 1.0 + w(H, scale=0.2), "dt_bias": w(H, scale=0.5),
        "norm": 1.0 + w(d_inner, scale=0.1), "out_proj": w(d_inner, d),
    }


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
@pytest.mark.parametrize("S", [37, 5])
def test_ssd_scan_matches_jax(S, with_state):
    """S = 37 is two whole chunks of 16 and a padded third; S = 5 one chunk
    shorter than the chunk size."""
    rng = np.random.RandomState(S + with_state)
    B, H, P, N = 2, 3, 8, 4
    xh = _randn(rng, B, S, H, P)
    dt = np.log1p(np.exp(_randn(rng, B, S, H)))  # softplus: positive steps
    A = -np.linspace(0.5, 4.0, H).astype(np.float32)
    Bm, Cm = _randn(rng, B, S, N), _randn(rng, B, S, N)
    s0 = _randn(rng, B, H, P, N) if with_state else None
    y, state = ssm.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)), 16,
                            init_state=None if s0 is None else torch.from_numpy(s0))
    jy, jstate = jssm.ssd_scan(*(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), 16,
                               init_state=None if s0 is None else jnp.asarray(s0))
    assert y.shape == (B, S, H, P) and state.dtype == torch.float32
    _close(y.numpy(), jy)
    _close(state.numpy(), jstate)


def test_causal_conv_matches_jax():
    rng = np.random.RandomState(1)
    x, w, b = _randn(rng, 2, 9, 6), _randn(rng, 4, 6), _randn(rng, 6)
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    _close(got.numpy(), jssm._causal_conv(*(jnp.asarray(a) for a in (x, w, b))))


def test_prefill_whole_and_in_two_chunks_match_jax():
    """40 tokens whole, and as 23 + 17 (the second chunk continuing from the
    first's conv tails and SSM state): outputs and caches equal the JAX
    block's whole prefill."""
    tcfg, jcfg = _configs()
    p = _params(tcfg, seed=2)
    x = _randn(np.random.RandomState(3), 2, 40, tcfg.d_model)
    jy, jc = jssm.mamba2_forward(_j(p), jnp.asarray(x), jcfg, return_cache=True)
    y, c = ssm.mamba2_forward(_t(p), torch.from_numpy(x), tcfg)
    _close(y.numpy(), jy)
    assert sorted(c) == sorted(ssm.CACHE_NAMES) == sorted(jc)
    for name in ssm.CACHE_NAMES:
        _close(c[name].numpy(), jc[name])
    y1, c1 = ssm.mamba2_forward(_t(p), torch.from_numpy(x[:, :23]), tcfg)
    y2, c2 = ssm.mamba2_forward(_t(p), torch.from_numpy(x[:, 23:]), tcfg, init_cache_state=c1)
    _close(torch.cat([y1, y2], dim=1).numpy(), jy)
    for name in ssm.CACHE_NAMES:
        _close(c2[name].numpy(), jc[name])


def test_short_prefill_pads_the_conv_tails_as_jax():
    """2 tokens, fewer than the conv's 3-row tail: the tail is zero-padded."""
    tcfg, jcfg = _configs()
    p = _params(tcfg, seed=4)
    x = _randn(np.random.RandomState(5), 1, 2, tcfg.d_model)
    _, jc = jssm.mamba2_forward(_j(p), jnp.asarray(x), jcfg, return_cache=True)
    _, c = ssm.mamba2_forward(_t(p), torch.from_numpy(x), tcfg)
    for name in ("conv_x", "conv_B", "conv_C"):
        assert c[name].shape[1] == tcfg.ssm.conv_width - 1
        _close(c[name].numpy(), jc[name])


def test_decode_steps_over_tenants_match_jax():
    """Two tenants' weights, two slots each: a 12-token prefill per tenant,
    then 3 merged decode steps updating the caches in place, each tenant
    against its own JAX decode chain."""
    tcfg, jcfg = _configs()
    R, B = 2, 2
    p = _params(tcfg, seed=6, R=R)
    rng = np.random.RandomState(7)
    x = _randn(rng, R, B, 12, tcfg.d_model)
    jcaches, tcache = [], {n: [] for n in ssm.CACHE_NAMES}
    for r in range(R):
        pr = jax.tree.map(lambda a: a[r], p)
        _, jc = jssm.mamba2_forward(_j(pr), jnp.asarray(x[r]), jcfg, return_cache=True)
        jcaches.append(jc)
        _, c = ssm.mamba2_forward(_t(pr), torch.from_numpy(x[r]), tcfg)
        for n in ssm.CACHE_NAMES:
            tcache[n].append(c[n])
    cache = {n: torch.stack(v) for n, v in tcache.items()}
    for _ in range(3):
        tok = _randn(rng, R, B, tcfg.d_model)
        out = ssm.mamba2_decode(_t(p), torch.from_numpy(tok), tcfg, cache)
        for r in range(R):
            pr = jax.tree.map(lambda a: a[r], p)
            jy, jcaches[r] = jssm.mamba2_decode(_j(pr), jnp.asarray(tok[r][:, None]), jcfg,
                                                jcaches[r])
            _close(out[r].numpy(), jy[:, 0])
            for n in ssm.CACHE_NAMES:
                _close(cache[n][r].numpy(), jcaches[r][n])


def test_param_and_cache_specs_match_the_jax_init():
    """Every leaf the JAX init makes, with its shape and dtype; the caches'
    shapes and dtypes as its init_cache gives them."""
    tcfg, jcfg = _configs()
    jp = jssm.mamba2_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    spec = ssm.param_specs(tcfg)
    assert sorted(spec) == sorted(jp)
    for k, leaf in jp.items():
        assert spec[k][0] == leaf.shape
        assert (spec[k][2] if len(spec[k]) > 2 else torch.float32) == torch.float32
    cfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    jc = jssm.init_cache(cfg16, 3, jnp.bfloat16)
    for name, (shape, dt) in ssm.cache_specs(tcfg).items():
        assert (3,) + shape == jc[name].shape
        assert (dt is None) == (jc[name].dtype == jnp.bfloat16)


def test_plain_kernels_model_is_bitwise_the_default_one_on_the_cpu():
    """zamba2's smoke variant at 4 layers (2 Mamba2, 2 shared attention):
    with ``plain_kernels`` False (``ops.ssd_scan`` / ``ops.ssd_step``, which
    route a CPU tensor to the plain versions) and True (the plain versions
    named), a whole prefill, a two-piece prefill and 3 decode steps give
    bitwise-equal logits and caches; every SSD call of either model is a
    plain call, one a Mamba2 layer a prefill pass or decode step."""
    cfg = smoke_variant(get_config("zamba2-7b"), num_layers=4)
    n_mamba = sum(k.name == "MAMBA2" for k in cfg.layer_pattern)
    models = [build_model(cfg, device="cpu", plain_kernels=plain) for plain in (False, True)]
    gen = torch.Generator()
    gen.manual_seed(3)
    params = models[0].init(gen)
    tok = torch.randint(1, cfg.vocab_size, (1, 37), generator=gen)
    runs = []
    ops.reset_counters()
    with torch.no_grad():
        for model in models:
            out = {}
            out["whole"], caches = model.forward_prefill(params, tok, 64)
            _, cc = model.forward_prefill(params, tok[:, :20], 64)
            out["pieces"], cc = model.forward_prefill(params, tok[:, 20:], 64, caches=cc, start=20)
            lengths = torch.tensor([37])
            for step in range(3):
                out[f"step {step}"], caches = model.forward_decode(params, tok[:, step], caches,
                                                                   lengths)
                lengths = lengths + 1
            runs.append((out, caches, cc))
    (a, ca, pa), (b, cb, pb) = runs
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for x, y in ((ca, cb), (pa, pb)):
        for name in x:
            assert all(torch.equal(u, v) for u, v in zip(x[name], y[name])), name
    scan, step = ops.COUNTERS["ssd_scan"], ops.COUNTERS["ssd_step"]
    assert (scan.launches, step.launches) == (0, 0)
    assert scan.plain_calls == 2 * 3 * n_mamba and step.plain_calls == 2 * 3 * n_mamba
    ops.reset_counters()

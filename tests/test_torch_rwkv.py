"""The port's RWKV-6 model against the JAX package's, on the same weights.

rwkv6-1.6b's smoke variant in float32: the JAX ``Model.init`` pytree goes
to the port through numpy (``params_from_jax_numpy``), with ``w_lora_b``
made non-zero in both so that the decay is data-dependent (at the JAX init
it is the constant exp(-exp(-4))). The same numpy tokens go to both, and
logits and caches must agree to float32 rounding (rtol/atol 1e-4, as in
``test_torch_models.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.core.tenancy import tenant_view  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build_model, layers, rwkv  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_jax_numpy,
    caches_to_jax_numpy,
    params_from_jax_numpy,
)

RTOL = ATOL = 1e-4
CACHE_LEN = 32
ARCH = "rwkv6-1.6b"
CACHE_NAMES = ("wkv", "shift_tm", "shift_cm")


def _with_live_decay(tree, seed=11):
    """JAX params (numpy leaves) with a random w_lora_b in every layer."""
    rng = np.random.RandomState(seed)

    def fix(path, a):
        if getattr(path[-1], "key", None) == "w_lora_b":
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


def _pair(dtype="float32"):
    jcfg = dataclasses.replace(jsmoke(jget_config(ARCH)), dtype=dtype)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype=dtype)
    jm = jbuild_model(jcfg)
    jp = _with_live_decay(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    tm = build_model(tcfg, device="cpu")
    if dtype == "float32":
        tp = params_from_jax_numpy(tcfg, jp, device="cpu")
    else:  # torch reads no numpy bfloat16: go through float32, exact for bf16 values
        tp = params_from_jax_numpy(tcfg, jax.tree.map(lambda a: a.astype(np.float32), jp),
                                   device="cpu")
        tp = jax.tree.map(lambda t, o: t.to(o.dtype), tp, tm.init(torch.Generator()))
    return tcfg, jm, jp, tm, tp


def _tokens(seed, B, S):
    return np.random.RandomState(seed).randint(1, 1024, size=(B, S)).astype(np.int32)


def _assert_caches(got_tree, want_tree):
    for group in ("unit", "rem"):
        for key, want in want_tree[group].items():
            assert sorted(got_tree[group][key]) == sorted(CACHE_NAMES)
            for name in CACHE_NAMES:
                np.testing.assert_allclose(got_tree[group][key][name],
                                           np.asarray(want[name], np.float32),
                                           rtol=RTOL, atol=ATOL, err_msg=name)


def test_prefill_and_decode_match_jax():
    """Fresh prefill of 13 tokens, then 3 decode steps: logits at each, and
    the wkv / token-shift caches at the end."""
    cfg, jm, jp, tm, tp = _pair()
    toks = _tokens(0, 2, 13)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, torch.from_numpy(toks).long(), cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    _assert_caches(caches_to_jax_numpy(cfg, tc), jc)
    lengths = np.asarray([13, 13], np.int32)
    rng = np.random.RandomState(1)
    for _ in range(3):
        tok = rng.randint(1, 1024, size=2).astype(np.int32)
        jl, jc = jm.forward_decode(jp, jnp.asarray(tok), jc, jnp.asarray(lengths))
        tl, tc = tm.forward_decode(tp, torch.from_numpy(tok).long(), tc,
                                   torch.from_numpy(lengths).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        lengths = lengths + 1
    _assert_caches(caches_to_jax_numpy(cfg, tc), jc)
    assert tc["wkv"][0].dtype == torch.float32 and tc["wkv"][0].shape == (2, 8, 32, 32)


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_prefill_matches_jax_continuation(chunk):
    """Chunked prefill carries wkv and token-shift state through each chunk
    (the scan's init_state): equal to JAX's ``prefill_continue`` chain and
    to one whole prefill."""
    cfg, jm, jp, tm, tp = _pair()
    toks = _tokens(3, 1, 14)
    t = torch.from_numpy(toks).long()
    whole, wc = tm.forward_prefill(tp, t, cache_len=CACHE_LEN)
    logits, cache = tm.forward_prefill(tp, t[:, :chunk], cache_len=CACHE_LEN)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks[:, :chunk]), cache_len=CACHE_LEN)
    for pos in range(chunk, 14, chunk):
        logits, cache = tm.forward_prefill(tp, t[:, pos:pos + chunk], cache_len=CACHE_LEN,
                                           caches=cache, start=pos)
        jl, jc = jm.forward_prefill(jp, jnp.asarray(toks[:, pos:pos + chunk]),
                                    cache_len=CACHE_LEN, caches=jc, start=jnp.int32(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
    _assert_caches(caches_to_jax_numpy(cfg, cache), jc)
    for name in CACHE_NAMES:
        for a, b in zip(cache[name], wc[name]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_caches_convert_both_ways():
    cfg, jm, jp, tm, tp = _pair()
    toks = _tokens(4, 1, 7)
    _, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=16)
    tree = jax.tree.map(np.asarray, jc)
    tc = caches_from_jax_numpy(cfg, tree, device="cpu")
    assert sorted(tc) == sorted(CACHE_NAMES) and len(tc["wkv"]) == cfg.num_layers
    back = caches_to_jax_numpy(cfg, tc)
    for name in CACHE_NAMES:
        np.testing.assert_array_equal(back["unit"]["pos0"][name], tree["unit"]["pos0"][name])
    # a decode from converted JAX caches matches the JAX decode
    tok = np.asarray([5], np.int32)
    jl, _ = jm.forward_decode(jp, jnp.asarray(tok), jc, jnp.asarray([7], np.int32))
    tl, _ = tm.forward_decode(tp, torch.from_numpy(tok).long(), tc, torch.tensor([7]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_tenant_batched_decode_matches_per_tenant():
    """One merged step over stacked (R, ...) params and caches (each
    projection a batched product, ``wkv6_step`` over all R*B*H heads)
    equals each tenant's own decode step."""
    cfg = smoke_variant(get_config(ARCH))
    tm = build_model(cfg, device="cpu")
    stacked = tm.init_stacked([torch.Generator().manual_seed(t) for t in range(3)])
    rng = np.random.RandomState(4)
    for lp in stacked["layers"]:
        lp["w_lora_b"].copy_(torch.from_numpy(rng.standard_normal(lp["w_lora_b"].shape) * 0.1))
    R, B = 3, 2
    caches = tm.init_caches(B, CACHE_LEN, tenants=R)
    for c in caches["wkv"] + caches["shift_tm"] + caches["shift_cm"]:
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape).astype(np.float32)))
    per_tenant = {n: [c.clone() for c in caches[n]] for n in CACHE_NAMES}
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(R, B)))
    lengths = torch.from_numpy(rng.randint(1, 20, size=(R, B)))
    merged, _ = tm.forward_decode_tenants(stacked, tokens, caches, lengths)
    for t in range(R):
        view = {n: [c[t] for c in per_tenant[n]] for n in CACHE_NAMES}
        lg, _ = tm.forward_decode(tenant_view(stacked, t), tokens[t], view, lengths[t])
        np.testing.assert_allclose(merged[t].numpy(), lg.numpy(), rtol=RTOL, atol=ATOL)
    for name in CACHE_NAMES:
        for a, b in zip(caches[name], per_tenant[name]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_prefill_runs_one_scan_per_layer_and_the_plain_opt_in():
    """On the CPU each layer's prefill is one call of the scan's plain
    version; ``plain_kernels=True`` takes the explicit plain entry point and
    gives the same logits."""
    cfg, jm, jp, tm, tp = _pair()
    toks = torch.from_numpy(_tokens(5, 1, 9)).long()
    ops.reset_counters()
    a, _ = tm.forward_prefill(tp, toks, cache_len=CACHE_LEN)
    assert ops.COUNTERS["wkv6_scan"].plain_calls == cfg.num_layers
    b, _ = build_model(cfg, device="cpu", plain_kernels=True).forward_prefill(
        tp, toks, cache_len=CACHE_LEN)
    assert ops.COUNTERS["wkv6_scan"].plain_calls == 2 * cfg.num_layers
    assert torch.equal(a, b)
    assert all(c.launches == 0 for c in ops.COUNTERS.values())


def test_init_dtypes_and_scales_follow_jax():
    """bf16 model: every leaf bf16 but w_base and u (float32), as in the JAX
    init; mu in [0.25, 0.75], w_base -4, w_lora_b 0, norms 1; a stacked
    init's slices equal single inits."""
    cfg = dataclasses.replace(smoke_variant(get_config(ARCH)), dtype="bfloat16")
    jcfg = dataclasses.replace(jsmoke(jget_config(ARCH)), dtype="bfloat16")
    tm = build_model(cfg, device="cpu")
    one = tm.init(torch.Generator().manual_seed(7))
    jlayer = jbuild_model(jcfg).init(jax.random.PRNGKey(0))["unit"]["pos0"]
    lp = one["layers"][0]
    assert sorted(lp) == sorted(jlayer)
    for name, leaf in lp.items():
        if name.startswith("norm"):
            assert leaf["scale"].dtype == torch.bfloat16 and torch.all(leaf["scale"] == 1)
            continue
        want = torch.float32 if name in ("w_base", "u") else torch.bfloat16
        assert leaf.dtype == want, name
        assert tuple(leaf.shape) == jlayer[name].shape[1:], name
    assert torch.all(lp["w_base"] == -4.0) and torch.all(lp["w_lora_b"] == 0)
    for name in ("mu", "mu_ck", "mu_cr"):
        assert 0.25 <= float(lp[name].min()) and float(lp[name].max()) <= 0.75  # bf16-rounded
    assert abs(float(lp["u"].std()) - 0.1) < 0.03
    stacked = tm.init_stacked([torch.Generator().manual_seed(5), torch.Generator().manual_seed(7)])
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(tenant_view(stacked, 1))):
        assert torch.equal(a, b)


def test_w_rounding_divergence_at_bf16(capsys):
    """ROADMAP F4. The JAX prefill scans its outputs with w rounded to the
    model dtype but rolls the state it keeps with float32 w; the port runs
    one scan, with rounded w, so at bf16 its state differs. Measured here,
    on the bf16 smoke variant: (a) in isolation, the layer-0 state from
    rounded against float32 w on the same projections; (b) end to end, the
    JAX model's caches against the port's, and the port's first decode
    logits from its own caches against those from the JAX wkv state."""
    cfg, jm, jp, tm, tp = _pair("bfloat16")
    H, N = rwkv.dims(cfg)
    toks = _tokens(6, 1, 24)
    t = torch.from_numpy(toks).long()

    lp = tp["layers"][0]
    x = tp["embed"][t]
    h = layers.rmsnorm(lp["norm_tm"]["scale"], x, cfg.norm_eps)
    r, k, v, _, w = rwkv._time_mix(lp, h, rwkv._token_shift(h, torch.zeros_like(h[:, 0])),
                                   rwkv._same)
    heads = [a.view(1, 24, H, N).transpose(1, 2) for a in (r, k, v)]
    _, s_round = ref.wkv6_scan(*heads, w.to(r.dtype).view(1, 24, H, N).transpose(1, 2),
                               lp["u"])
    _, s_f32 = ref.wkv6_scan(*heads, w.view(1, 24, H, N).transpose(1, 2), lp["u"])
    layer0 = float((s_round - s_f32).abs().max() / s_f32.abs().max())

    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, t, cache_len=CACHE_LEN)
    jtree = jax.tree.map(lambda a: np.asarray(a, np.float32), jc)
    jwkv = caches_from_jax_numpy(cfg, jtree, device="cpu")["wkv"]
    state = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(tc["wkv"], jwkv))
    prefill = float((tl.float() - torch.from_numpy(np.asarray(jl, np.float32))).abs().max())
    swapped = {n: [c.clone() for c in tc[n]] for n in CACHE_NAMES}
    swapped["wkv"] = jwkv
    tok, lengths = tl.argmax(-1), torch.tensor([24])
    own, _ = tm.forward_decode(tp, tok, tc, lengths)
    theirs, _ = tm.forward_decode(tp, tok, swapped, lengths)
    decode = float((own.float() - theirs.float()).abs().max())
    scale = float(theirs.float().abs().max())
    with capsys.disabled():
        print(f"\nF4 at bf16, {ARCH} smoke, 24 tokens: layer-0 state from rounded w vs "
              f"float32 w: max |d| / max |S| = {layer0:.3e}; port vs JAX caches: "
              f"max |d wkv| / max |wkv| = {state:.3e} (worst layer); prefill logits "
              f"max |d| = {prefill:.3e}; first decode logits, own vs JAX wkv state: "
              f"max |d| = {decode:.3e} of max |logit| {scale:.3e}")
    assert 0 < layer0 < 0.05 and state < 0.1 and decode < 0.05 * scale

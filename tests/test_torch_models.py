"""The port's model against the JAX package's, on the same weights.

stablelm-1.6b's smoke variant in float32: the JAX ``Model.init`` pytree
goes to the port through numpy (``params_from_jax_numpy``), the same numpy
tokens go to both, and logits and caches must agree to float32 rounding
(rtol/atol 1e-4 on logits of magnitude ~3: a few layers of float32
products summed in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import AttentionKind as JAttentionKind  # noqa: E402
from repro.config import BlockKind as JBlockKind  # noqa: E402
from repro.config import SSMConfig as JSSMConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.config import (  # noqa: E402
    AttentionKind,
    BlockKind,
    SSMConfig,
    get_config,
    smoke_variant,
)
from repro_torch.core.tenancy import tenant_view  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_jax_numpy,
    caches_to_jax_numpy,
    params_from_jax_numpy,
)

RTOL = ATOL = 1e-4
CACHE_LEN = 32


def _pair(sliding_window=0, **overrides):
    jcfg = dataclasses.replace(jsmoke(jget_config("stablelm-1.6b")), **overrides)
    tcfg = dataclasses.replace(smoke_variant(get_config("stablelm-1.6b")), **overrides)
    if sliding_window:
        jcfg = dataclasses.replace(jcfg, attention_kind=JAttentionKind.SLIDING,
                                   sliding_window=sliding_window)
        tcfg = dataclasses.replace(tcfg, attention_kind=AttentionKind.SLIDING,
                                   sliding_window=sliding_window)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


def _np(x):
    return np.asarray(x)


def _decode_both(jm, jp, tm, tp, jc, tc, lengths, steps, seed):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        tok = rng.randint(1, 1024, size=len(lengths)).astype(np.int32)
        jl, jc = jm.forward_decode(jp, jnp.asarray(tok), jc, jnp.asarray(lengths))
        tl, tc = tm.forward_decode(tp, torch.from_numpy(tok).long(), tc,
                                   torch.from_numpy(lengths).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=RTOL, atol=ATOL)
        lengths = lengths + 1
    return jc, tc


@pytest.mark.parametrize("sliding_window", [0, 8], ids=["global", "ring"])
def test_prefill_and_decode_match_jax(sliding_window):
    """Fresh prefill of 13 tokens then 3 decode steps; with a window of 8
    the caches are ring buffers (prefill keeps the last 8 keys rolled into
    slot p % 8; decode writes wrap)."""
    cfg, jm, jp, tm, tp = _pair(sliding_window)
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, torch.from_numpy(toks).long(), cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=RTOL, atol=ATOL)
    lengths = np.asarray([13, 13], np.int32)
    jc, tc = _decode_both(jm, jp, tm, tp, jc, tc, lengths, 3, seed=1)
    want = jax.tree.map(np.asarray, jc)
    got = caches_to_jax_numpy(cfg, tc)
    for name in ("k", "v"):
        s_alloc = want["unit"]["pos0"][name].shape[3]
        assert s_alloc == (sliding_window or CACHE_LEN)
        np.testing.assert_allclose(got["unit"]["pos0"][name], want["unit"]["pos0"][name],
                                   rtol=RTOL, atol=ATOL)


def test_config_branches_match_jax():
    """The config fields stablelm leaves off (QKV bias, tied embeddings,
    embedding scale, final-logit softcap, an ungated GELU MLP) follow the
    JAX model too."""
    overrides = dict(qkv_bias=True, tie_embeddings=True, scale_embed=True,
                     logit_softcap=30.0, mlp_gated=False)
    cfg, jm, jp, tm, tp = _pair(**overrides)
    rng = np.random.RandomState(5)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)  # non-zero biases and norm scales
    tp = params_from_jax_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    assert "lm_head" not in tp and "bq" in tp["layers"][0]["attn"]
    toks = rng.randint(1, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, torch.from_numpy(toks).long(), cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=RTOL, atol=ATOL)
    _decode_both(jm, jp, tm, tp, jc, tc, np.asarray([9, 9], np.int32), 2, seed=6)


def test_caches_convert_both_ways():
    cfg, jm, jp, tm, tp = _pair()
    toks = np.arange(1, 8, dtype=np.int32)[None, :]
    _, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=16)
    tree = jax.tree.map(np.asarray, jc)
    tc = caches_from_jax_numpy(cfg, tree, device="cpu")
    assert len(tc["k"]) == cfg.num_layers and tc["k"][0].shape == (1, 4, 16, 64)
    back = caches_to_jax_numpy(cfg, tc)
    np.testing.assert_array_equal(back["unit"]["pos0"]["k"], tree["unit"]["pos0"]["k"])
    # a decode from converted JAX caches matches the JAX decode
    lengths = np.asarray([7], np.int32)
    _decode_both(jm, jp, tm, tp, jc, tc, lengths, 1, seed=2)


@pytest.mark.parametrize("chunk", [4, 5])
def test_chunked_prefill_matches_whole(chunk):
    """Chunked continuation (the flash kernel's runtime q_offset path)
    equals one whole prefill, in the port and against JAX."""
    cfg, jm, jp, tm, tp = _pair()
    toks = np.random.RandomState(3).randint(1, cfg.vocab_size, size=(1, 14)).astype(np.int32)
    t = torch.from_numpy(toks).long()
    whole, wc = tm.forward_prefill(tp, t, cache_len=CACHE_LEN)
    logits, cache = tm.forward_prefill(tp, t[:, :chunk], cache_len=CACHE_LEN)
    for pos in range(chunk, 14, chunk):
        logits, cache = tm.forward_prefill(tp, t[:, pos:pos + chunk], cache_len=CACHE_LEN,
                                           caches=cache, start=pos)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(cache["k"], wc["k"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
    jl, _ = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), _np(jl), rtol=RTOL, atol=ATOL)


def test_chunked_prefill_refuses_ring_caches():
    cfg, jm, jp, tm, tp = _pair(sliding_window=8)
    t = torch.arange(1, 5)[None, :]
    _, cache = tm.forward_prefill(tp, t, cache_len=CACHE_LEN)
    with pytest.raises(NotImplementedError):
        tm.forward_prefill(tp, t, cache_len=CACHE_LEN, caches=cache, start=4)


def test_tenant_batched_decode_matches_per_tenant():
    """One merged step over stacked (R, ...) params and caches equals each
    tenant's own decode step (the space-time merge changes no math)."""
    cfg = smoke_variant(get_config("stablelm-1.6b"))
    tm = build_model(cfg, device="cpu")
    gens = [torch.Generator().manual_seed(t) for t in range(3)]
    stacked = tm.init_stacked(gens)
    R, B = 3, 2
    rng = np.random.RandomState(4)
    caches = tm.init_caches(B, CACHE_LEN, tenants=R)
    for c in caches["k"] + caches["v"]:
        c.copy_(torch.from_numpy(rng.standard_normal(c.shape).astype(np.float32)))
    per_tenant = {n: [c.clone() for c in caches[n]] for n in ("k", "v")}
    tokens = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(R, B)))
    lengths = torch.from_numpy(rng.randint(1, 20, size=(R, B)))
    merged, _ = tm.forward_decode_tenants(stacked, tokens, caches, lengths)
    for t in range(R):
        view = {n: [c[t] for c in per_tenant[n]] for n in ("k", "v")}
        lg, _ = tm.forward_decode(tenant_view(stacked, t), tokens[t], view, lengths[t])
        np.testing.assert_allclose(merged[t].numpy(), lg.numpy(), rtol=RTOL, atol=ATOL)
    for a, b in zip(caches["k"], per_tenant["k"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_init_stacked_slices_equal_init_and_match_jax_scales():
    cfg = smoke_variant(get_config("stablelm-1.6b"))
    tm = build_model(cfg, device="cpu")
    one = tm.init(torch.Generator().manual_seed(7))
    stacked = tm.init_stacked([torch.Generator().manual_seed(5), torch.Generator().manual_seed(7)])
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(tenant_view(stacked, 1))):
        assert torch.equal(a, b)
    # truncated normal in [-2, 2] times 1/sqrt(d_in), as the JAX init draws
    wq = one["layers"][0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.d_model) + 1e-6
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.05
    assert torch.equal(one["layers"][0]["norm1"]["scale"], torch.ones(cfg.d_model))


def test_unported_block_kinds_raise():
    """No block kind is left unported: a pattern that mixes mamba2 with
    attn_mlp (which no assigned config has) builds, and its prefill and
    decode logits follow the JAX model's."""
    ssm = {"state_dim": 16, "head_dim": 32, "chunk_size": 16}
    tcfg = dataclasses.replace(smoke_variant(get_config("stablelm-1.6b")), family="hybrid",
                               block_pattern=(BlockKind.MAMBA2, BlockKind.ATTN_MLP),
                               ssm=SSMConfig(**ssm))
    jcfg = dataclasses.replace(jsmoke(jget_config("stablelm-1.6b")), family="hybrid",
                               block_pattern=(JBlockKind.MAMBA2, JBlockKind.ATTN_MLP),
                               ssm=JSSMConfig(**ssm))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.RandomState(5).randint(1, tcfg.vocab_size, size=(2, 9)).astype(np.int32)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len=CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, torch.from_numpy(toks).long(), cache_len=CACHE_LEN)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=RTOL, atol=ATOL)
    tok, lengths = np.asarray([3, 4], np.int32), np.asarray([9, 9], np.int32)
    jl, _ = jm.forward_decode(jp, jnp.asarray(tok), jc, jnp.asarray(lengths))
    tl, _ = tm.forward_decode(tp, torch.from_numpy(tok).long(), tc, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=RTOL, atol=ATOL)


def test_default_device_is_the_card():
    """With no device argument the model runs on cuda, and raises when
    there is no card rather than carrying on on the CPU."""
    cfg = smoke_variant(get_config("stablelm-1.6b"))
    if torch.cuda.is_available():
        assert build_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)

"""The port's model against the JAX package's for paligemma-3b and
musicgen-large (stub frontends: precomputed prefix embeddings projected by
``frontend_proj``), qwen2-7b, granite-3-8b and gemma3-27b (dense, config
only), granite-moe-1b-a400m (every layer attention + MoE), zamba2-7b
(Mamba2 layers and one shared attention block applied at every hybrid
position) and llama4-maverick (dense and MoE layers in turn, with a shared
expert).

Smoke variants in float32, the JAX ``Model.init`` pytree converted to the
port through numpy, the same numpy tokens and prefix embeddings fed to
both: logits of a prefill and of decode steps, and the caches, must agree
to float32 rounding (rtol/atol 1e-4, as ``test_torch_models.py``: a few
layers of float32 products summed in another order). paligemma's smoke
variant also runs with its head dim overridden to 256 (its own) and 112
(zamba2's), so the model path itself takes the head dims K3 and K4 gained;
gemma3 runs 6 layers so that its sixth, global layer exists beside five
sliding-window (ring-cache) layers. zamba2 runs 4 layers (mamba2, shared,
mamba2, shared), so the one shared block is applied twice; llama4's smoke
variant drops its shared expert, so its tests put it back in both packages'
configs.
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
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.config import AttentionKind, get_config, smoke_variant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.config import BlockKind  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_jax_numpy,
    caches_to_jax_numpy,
    params_from_jax_numpy,
    params_to_jax_numpy,
)

RTOL = ATOL = 1e-4
CACHE_LEN = 32


def _pair(arch, num_layers=2, adjust=None, **overrides):
    """Both packages' smoke variants with ``overrides`` (and ``adjust``, a
    function of each package's config) applied alike; the JAX model, its
    init, and the port's model and converted params."""
    jcfg = dataclasses.replace(jsmoke(jget_config(arch), num_layers=num_layers), **overrides)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch), num_layers=num_layers),
                               **overrides)
    if adjust is not None:
        jcfg, tcfg = adjust(jcfg), adjust(tcfg)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


def _prefix(cfg, B, seed):
    """(B, P, frontend width) seeded numpy embeddings, or None."""
    if not cfg.num_prefix_embeddings:
        return None
    rng = np.random.RandomState(seed)
    width = cfg.frontend_embed_dim or cfg.d_model
    return rng.standard_normal((B, cfg.num_prefix_embeddings, width)).astype(np.float32)


def _check_both(arch, prompt_len, decode_steps, num_layers=2, adjust=None, **overrides):
    """Prefill ``prompt_len`` tokens (the first P placeholders for a stub
    frontend's prefix), then ``decode_steps`` decode steps, in both
    packages; logits and caches must agree. Returns the port's config and
    params."""
    cfg, jm, jp, tm, tp = _pair(arch, num_layers, adjust, **overrides)
    B = 2
    rng = np.random.RandomState(1)
    toks = rng.randint(1, cfg.vocab_size, size=(B, prompt_len)).astype(np.int32)
    pref = _prefix(cfg, B, seed=2)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks), CACHE_LEN,
                                None if pref is None else jnp.asarray(pref))
    tl, tc = tm.forward_prefill(tp, torch.from_numpy(toks).long(), CACHE_LEN,
                                prefix_embeds=None if pref is None else torch.from_numpy(pref))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    lengths = np.full(B, prompt_len, np.int32)
    for _ in range(decode_steps):
        tok = rng.randint(1, cfg.vocab_size, size=B).astype(np.int32)
        jl, jc = jm.forward_decode(jp, jnp.asarray(tok), jc, jnp.asarray(lengths))
        tl, tc = tm.forward_decode(tp, torch.from_numpy(tok).long(), tc,
                                   torch.from_numpy(lengths).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        lengths = lengths + 1
    want = jax.tree.map(np.asarray, jc)
    got = caches_to_jax_numpy(cfg, tc)
    for group in ("unit", "rem"):
        for key, leaves in want[group].items():
            for name, leaf in leaves.items():
                np.testing.assert_allclose(got[group][key][name], leaf, rtol=RTOL, atol=ATOL)
    return cfg, tp


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large"])
def test_prefix_embeds_prefill_and_decode_match_jax(arch):
    """A stub frontend's prefix embeddings, projected by frontend_proj,
    replace the first P positions; prefill and decode logits follow the
    JAX model's."""
    cfg, _ = _check_both(arch, prompt_len=9, decode_steps=3)
    assert cfg.num_prefix_embeddings == 4
    assert (cfg.frontend_embed_dim or cfg.d_model) == {"paligemma-3b": 256,
                                                       "musicgen-large": 256}[arch]


def test_prefix_embeds_change_the_logits():
    """The prefix really enters the sequence: other embeddings, other logits."""
    cfg, jm, jp, tm, tp = _pair("paligemma-3b")
    toks = torch.from_numpy(np.random.RandomState(3).randint(1, cfg.vocab_size, size=(1, 7)))
    pref = torch.from_numpy(_prefix(cfg, 1, seed=4))
    with_prefix, _ = tm.forward_prefill(tp, toks, CACHE_LEN, prefix_embeds=pref)
    other, _ = tm.forward_prefill(tp, toks, CACHE_LEN, prefix_embeds=pref + 1.0)
    without, _ = tm.forward_prefill(tp, toks, CACHE_LEN)
    assert not torch.allclose(with_prefix, other)
    assert not torch.allclose(with_prefix, without)


@pytest.mark.parametrize("head_dim", [256, 112])
def test_head_dim_override_matches_jax(head_dim):
    """paligemma's smoke variant at head dims 256 and 112 (q_per_kv 4):
    the model path runs zamba2's and paligemma's head dims."""
    cfg, _ = _check_both("paligemma-3b", prompt_len=11, decode_steps=2, head_dim=head_dim)
    assert cfg.head_dim == head_dim and cfg.q_per_kv == 4


NEW_ARCH_LAYERS = {"granite-moe-1b-a400m": 2, "zamba2-7b": 4, "llama4-maverick-400b-a17b": 2}


def _with_shared_expert(cfg):
    """llama4's shared expert, which ``smoke_variant`` drops, put back."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared_experts=1))


@pytest.mark.parametrize("arch", ["paligemma-3b", "musicgen-large", "gemma3-27b",
                                  *NEW_ARCH_LAYERS])
def test_params_round_trip_through_convert(arch):
    """JAX pytree -> port params -> JAX pytree gives every leaf back,
    frontend_proj and zamba2's top-level shared_attn included."""
    num_layers = {"gemma3-27b": 6, **NEW_ARCH_LAYERS}.get(arch, 2)
    cfg, jm, jp, tm, tp = _pair(arch, num_layers)
    tree = jax.tree.map(np.asarray, jp)
    back = params_to_jax_numpy(cfg, tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    if cfg.num_prefix_embeddings:
        assert tp["frontend_proj"].shape == (cfg.frontend_embed_dim, cfg.d_model)


@pytest.mark.parametrize("arch,num_layers", [("qwen2-7b", 2), ("granite-3-8b", 2),
                                             ("gemma3-27b", 6)])
def test_dense_config_prefill_and_decode_match_jax(arch, num_layers):
    """qwen2 (QKV bias, q_per_kv 4 at smoke width), granite (GQA) and
    gemma3 (5 sliding layers with 16-slot ring caches, one global layer,
    tied and scaled embeddings, softcapped logits): a 20-token prompt
    wraps the rings, and decode steps keep wrapping them."""
    cfg, _ = _check_both(arch, prompt_len=20, decode_steps=3, num_layers=num_layers)
    kinds = [cfg.attention_kind_at(i) for i in range(cfg.num_layers)]
    if arch == "gemma3-27b":
        assert kinds == [AttentionKind.SLIDING] * 5 + [AttentionKind.FULL]
        assert cfg.sliding_window == 16 and cfg.logit_softcap == 30.0


def test_gemma3_chunked_prefill_refuses_its_sliding_layers():
    """As in the reference: a continuation cannot run over ring caches."""
    cfg, jm, jp, tm, tp = _pair("gemma3-27b", 6)
    t = torch.arange(1, 5)[None, :]
    _, cache = tm.forward_prefill(tp, t, CACHE_LEN)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tm.forward_prefill(tp, t, CACHE_LEN, caches=cache, start=4)


@pytest.mark.parametrize("arch", sorted(NEW_ARCH_LAYERS))
def test_moe_and_hybrid_prefill_and_decode_match_jax(arch):
    """granite-moe (top-4 of 4 experts at smoke width), zamba2 (mamba2,
    shared, mamba2, shared: conv and SSM caches beside k/v caches) and
    llama4 (dense then MoE, top-1 with the shared expert): a 20-token
    prefill and 3 decode steps, logits and every cache."""
    adjust = _with_shared_expert if arch.startswith("llama4") else None
    cfg, tp = _check_both(arch, prompt_len=20, decode_steps=3,
                          num_layers=NEW_ARCH_LAYERS[arch], adjust=adjust)
    if arch.startswith("llama4"):
        assert cfg.layer_pattern == (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE)
        assert cfg.moe.num_shared_experts == 1 and "shared" in tp["layers"][1]["moe"]
        assert "mlp" in tp["layers"][0] and "moe" not in tp["layers"][0]


def test_zamba2_shared_block_is_held_once_and_applied_twice():
    """The shared attention block is one set of weights at the top level;
    the hybrid positions hold none of their own, each keeps its own k/v
    cache, and the port holds exactly the JAX tree's parameters."""
    cfg, jm, jp, tm, tp = _pair("zamba2-7b", 4)
    assert cfg.layer_pattern == (BlockKind.MAMBA2, BlockKind.HYBRID_SHARED_ATTN) * 2
    assert tp["layers"][1] == {} and tp["layers"][3] == {}
    assert sorted(tp["shared_attn"]) == ["attn", "mlp", "norm1", "norm2"]
    n_port = sum(t.numel() for t in jax.tree.leaves(tp))
    assert n_port == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in jax.tree.leaves(fresh)) == n_port
    caches = tm.init_caches(2, CACHE_LEN)
    assert len(caches["k"]) == 2 and len(caches["ssm"]) == 2
    assert caches["ssm"][0].dtype == torch.float32
    # the shared block's weights reach both positions: changing them moves
    # the logits, and a stacked cohort keeps them once per tenant
    toks = torch.arange(1, 9)[None, :]
    base, _ = tm.forward_prefill(tp, toks, CACHE_LEN)
    tp["shared_attn"]["mlp"]["down"].mul_(2.0)
    assert not torch.allclose(base, tm.forward_prefill(tp, toks, CACHE_LEN)[0])
    stacked = tm.init_stacked([torch.Generator().manual_seed(t) for t in range(3)])
    assert stacked["shared_attn"]["attn"]["wq"].shape[0] == 3
    assert stacked["layers"][1] == {}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_chunked_prefill_matches_jax_chunk_by_chunk(arch):
    """A 20-token prompt as 12 + 8 in both packages: the second chunk
    continues the SSM state and conv tails (zamba2) or takes its own
    per-sequence capacity (granite-moe) as the reference's does."""
    cfg, jm, jp, tm, tp = _pair(arch, NEW_ARCH_LAYERS[arch])
    toks = np.random.RandomState(6).randint(1, cfg.vocab_size, size=(2, 20)).astype(np.int32)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks[:, :12]), CACHE_LEN)
    jl, jc = jm.forward_prefill(jp, jnp.asarray(toks[:, 12:]), CACHE_LEN, caches=jc, start=12)
    t = torch.from_numpy(toks).long()
    tl, tc = tm.forward_prefill(tp, t[:, :12], CACHE_LEN)
    tl, tc = tm.forward_prefill(tp, t[:, 12:], CACHE_LEN, caches=tc, start=12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    want, got = jax.tree.map(np.asarray, jc), caches_to_jax_numpy(cfg, tc)
    for key, leaves in want["unit"].items():
        for name, leaf in leaves.items():
            np.testing.assert_allclose(got["unit"][key][name], leaf, rtol=RTOL, atol=ATOL)
    if arch == "zamba2-7b":  # the SSM continuation is the whole prefill's too
        whole, wc = tm.forward_prefill(tp, t, CACHE_LEN)
        np.testing.assert_allclose(tl.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
        for a, b in zip(tc["ssm"], wc["ssm"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_zamba2_caches_round_trip_through_convert():
    """JAX caches (conv tails and SSM states at mamba2 positions, k/v at the
    shared positions) -> the port's per-name lists -> JAX caches."""
    cfg, jm, jp, tm, tp = _pair("zamba2-7b", 4)
    toks = jnp.asarray(np.random.RandomState(8).randint(1, cfg.vocab_size, size=(2, 7)))
    _, jc = jm.forward_prefill(jp, toks, CACHE_LEN)
    tree = jax.tree.map(np.asarray, jc)
    caches = caches_from_jax_numpy(cfg, tree, device="cpu")
    assert sorted(caches) == ["conv_B", "conv_C", "conv_x", "k", "ssm", "v"]
    back = caches_to_jax_numpy(cfg, caches)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)

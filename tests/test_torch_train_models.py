"""The port's ``Model.forward_train`` against the JAX package's, for every
registered architecture.

Smoke variants in float32, the JAX ``Model.init`` pytree converted to the
port through numpy, the same numpy tokens, labels and prefix embeddings
fed to both. On the CPU the port's kernel ops run their plain versions and
torch autograd differentiates them, as the reference differentiates its jnp
oracles there. Tolerances:

* the loss within 1e-5 relative: a few layers of float32 products summed
  in another order;
* every gradient leaf, converted back to the JAX layout
  (``convert.params_to_jax_numpy``), within 2e-4 of that leaf's largest
  reference magnitude (absolute), the same float32 reordering carried
  through the backward pass.

gemma3 runs 6 layers (five sliding-window layers and one global), zamba2
4 (the shared block applied twice, its gradient summed over both
positions), llama4 2 with its shared expert put back, as
``test_torch_archs.py`` runs them.
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
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax_numpy, params_to_jax_numpy  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4  # of each leaf's largest reference magnitude
LAYERS = {"gemma3-27b": 6, "zamba2-7b": 4}
B, S = 2, 24


def _with_shared_expert(cfg):
    if cfg.moe is None or not cfg.name.startswith("llama4"):
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_shared_experts=1))


def _pair(arch, remat="block"):
    n = LAYERS.get(arch, 2)
    jcfg = _with_shared_expert(dataclasses.replace(jsmoke(jget_config(arch), num_layers=n),
                                                   dtype="float32"))
    tcfg = _with_shared_expert(dataclasses.replace(smoke_variant(get_config(arch), num_layers=n),
                                                   dtype="float32"))
    jm = jbuild_model(jcfg, remat=remat)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, device="cpu", remat=remat)
    tp = params_from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return tcfg, jm, jp, tm, tp


def _batch(cfg, seed, batch=B):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(batch, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, size=(batch, S)).astype(np.int32)
    pref = None
    if cfg.num_prefix_embeddings:
        width = cfg.frontend_embed_dim or cfg.d_model
        pref = rng.standard_normal((batch, cfg.num_prefix_embeddings, width)).astype(np.float32)
    return toks, labels, pref


def _port_grads(tm, tp, toks, labels, pref, loss_mask=None):
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = tm.forward_train(
        tp, torch.from_numpy(toks).long(), torch.from_numpy(labels).long(),
        prefix_embeds=None if pref is None else torch.from_numpy(pref),
        loss_mask=None if loss_mask is None else torch.from_numpy(loss_mask))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _rebuild(tp, it)


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def _jax_grads(jm, jp, toks, labels, pref, loss_mask=None):
    def loss_fn(p):
        return jm.forward_train(p, jnp.asarray(toks), jnp.asarray(labels),
                                prefix_embeds=None if pref is None else jnp.asarray(pref),
                                loss_mask=None if loss_mask is None else jnp.asarray(loss_mask))

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    return loss, metrics, grads


def _assert_grads_close(cfg, tgrads, jgrads):
    got = params_to_jax_numpy(cfg, tgrads)
    want = jax.tree.map(np.asarray, jgrads)
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for path, g, w in zip(jax.tree_util.tree_flatten_with_path(want)[0], got_leaves,
                          want_leaves):
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(scale, 1e-30),
                                   err_msg=jax.tree_util.keystr(path[0]))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch):
    cfg, jm, jp, tm, tp = _pair(arch)
    toks, labels, pref = _batch(cfg, seed=5)
    jloss, jmetrics, jgrads = _jax_grads(jm, jp, toks, labels, pref)
    tloss, tmetrics, tgrads = _port_grads(tm, tp, toks, labels, pref)
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), rtol=LOSS_RTOL,
                                   atol=1e-7)
    if cfg.moe is not None:
        assert float(tmetrics["aux"]) > 0  # the load-balance loss is kept in train mode
    _assert_grads_close(cfg, tgrads, jgrads)


def test_loss_mask_and_prefix_mask_match_jax():
    """A caller's loss mask, multiplied by the prefix mask, as the reference."""
    cfg, jm, jp, tm, tp = _pair("paligemma-3b")
    toks, labels, pref = _batch(cfg, seed=6)
    mask = (np.random.RandomState(7).rand(B, S) > 0.3).astype(np.float32)
    jloss, _, jgrads = _jax_grads(jm, jp, toks, labels, pref, mask)
    tloss, _, tgrads = _port_grads(tm, tp, toks, labels, pref, mask)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads_close(cfg, tgrads, jgrads)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-7b",
                                  "granite-moe-1b-a400m"])
def test_remat_block_and_none_give_equal_gradients(arch):
    """Recomputing each block in the backward pass changes no gradient:
    the recompute runs the same float32 operations on the same inputs."""
    cfg, _, jp, tm_block, tp = _pair(arch, remat="block")
    tm_none = build_model(cfg, device="cpu", remat="none")
    toks, labels, pref = _batch(cfg, seed=8)
    lb, _, gb = _port_grads(tm_block, tp, toks, labels, pref)
    ln, _, gn = _port_grads(tm_none, tp, toks, labels, pref)
    assert float(lb) == float(ln)
    for a, b in zip(tree_leaves(gb), tree_leaves(gn)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_rejects_unknown_mode():
    with pytest.raises(ValueError):
        build_model(smoke_variant(get_config("stablelm-1.6b")), device="cpu", remat="unit")


def test_zamba2_shared_block_gradient_sums_over_positions():
    """Zamba2's shared attention block is one set of tensors applied at
    every hybrid position: its gradient is there, at the top level, and
    equals the reference's (which closes over the same weights in its scan)."""
    cfg, jm, jp, tm, tp = _pair("zamba2-7b")
    toks, labels, pref = _batch(cfg, seed=9)
    _, _, tgrads = _port_grads(tm, tp, toks, labels, pref)
    assert sum(k.value == "hybrid_shared_attn" for k in cfg.layer_pattern) == 2
    assert all(not lp for lp, k in zip(tgrads["layers"], cfg.layer_pattern)
               if k.value == "hybrid_shared_attn")
    assert float(tgrads["shared_attn"]["attn"]["wq"].abs().max()) > 0


def test_microbatch_equivalence():
    """k-microbatched accumulated gradients == full-batch gradients (the
    reference's ``tests/test_launch.py::test_microbatch_equivalence``,
    mirrored with its tolerances)."""
    cfg = dataclasses.replace(smoke_variant(get_config("stablelm-1.6b")), dtype="float32")
    m = build_model(cfg, device="cpu", remat="none")
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen)
    Bm, Sm, k = 4, 16, 2
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(Bm, Sm)))
    labels = torch.roll(toks, -1, dims=1)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def value_and_grad(t, l):
        loss, _ = m.forward_train(params, t, l)
        return loss, torch.autograd.grad(loss, leaves)

    full_loss, full_grads = value_and_grad(toks, labels)
    mb_loss = 0.0
    mb_grads = [torch.zeros_like(p) for p in leaves]
    for i in range(k):
        sl = slice(i * Bm // k, (i + 1) * Bm // k)
        loss, grads = value_and_grad(toks[sl], labels[sl])
        mb_loss += float(loss.detach()) / k
        mb_grads = [a + b / k for a, b in zip(mb_grads, grads)]
    np.testing.assert_allclose(mb_loss, float(full_loss.detach()), rtol=1e-5)
    for a, b in zip(mb_grads, full_grads):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-4, atol=1e-5)


def test_forward_train_leaves_no_cache_and_serving_is_unchanged():
    """Train mode writes nothing in place and the serving entry points
    still give the logits they gave before a training forward."""
    cfg, _, _, tm, tp = _pair("stablelm-1.6b")
    toks, labels, _ = _batch(cfg, seed=10)
    before, _ = tm.forward_prefill(tp, torch.from_numpy(toks).long(), 32)
    _port_grads(tm, tp, toks, labels, None)
    after, _ = tm.forward_prefill(tp, torch.from_numpy(toks).long(), 32)
    torch.testing.assert_close(before, after, rtol=0, atol=0)

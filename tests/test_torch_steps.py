"""The port's step builders (``repro_torch.launch.steps``) against the JAX
package's ``repro.launch.steps`` at smoke width in float32.

Both builders take small input shapes registered in both packages' shape
tables for the test (``monkeypatch.setitem``): the assigned shapes would
not fit a CPU test at any width. The reference's step runs under
``jax.jit`` on a 1x1 ``jax.make_mesh``; the port's on the CPU. Weights go
from the reference's ``Model.init`` to the port through numpy
(``models.convert``: per layer, then ``params_to_scan``, the reference's
own layout, which the port's step takes). Tolerances: loss rtol 1e-5
(``tests/test_launch.py``'s); logits rtol / atol 1e-4 (the port's model
tests'). After one AdamW step (taken at step 50 of the schedule, where the
rate is not zero): the first moment, (1 - b1) times the clipped gradient,
by the port's gradient rule (``tests/test_torch_train_models.py``: within
2e-4 of each leaf's largest reference magnitude), and the gradient
magnitude the second moment implies likewise; the params rtol 1e-5, atol
1e-6 wherever the reference's first moment stands 10 tolerances clear of
zero, and elsewhere within one update's reach (2 lr), since AdamW's first
step moves a param by about lr times the sign of a gradient that the
gradient rule does not resolve there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.config.shapes as jshapes  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import get_shape as jget_shape  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.training.optimizer import AdamWState as JAdamWState  # noqa: E402
from repro.training.optimizer import lr_schedule as jlr_schedule  # noqa: E402

import repro_torch.config.shapes as tshapes  # noqa: E402
from repro_torch.config import InputShape, get_config, get_shape, smoke_variant  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_jax_numpy,
    params_from_jax_numpy,
    params_to_scan,
)
from repro_torch.training.optimizer import AdamWState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = 2e-4  # of each leaf's largest reference magnitude
TINY = {"tiny_train": (16, 4, "train"), "tiny_prefill": (16, 2, "prefill"),
        "tiny_decode": (24, 4, "decode")}
STEP = 50  # AdamW step the train comparison takes (lr > 0 there)


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, (seq, batch, kind) in TINY.items():
        monkeypatch.setitem(jshapes.INPUT_SHAPES, name,
                            jshapes.InputShape(name, seq_len=seq, global_batch=batch, kind=kind))
        monkeypatch.setitem(tshapes.INPUT_SHAPES, name,
                            InputShape(name, seq_len=seq, global_batch=batch, kind=kind))


def _pair(arch, seed=0):
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if arch.startswith("rwkv"):  # a data-dependent decay (zero LoRA at init)
        rng = np.random.RandomState(seed + 11)
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
            if getattr(path[-1], "key", None) == "w_lora_b" else a, jp)
    tp = params_to_scan(tcfg, params_from_jax_numpy(tcfg, jp, device="cpu"))
    return jcfg, tcfg, jp, tp


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


def _assert_tree(got, want, **tol):
    """got: the port's scan-layout tree of tensors; want: the reference's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _layout(tree):
    """Key paths and shapes, order-free."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layout(v) for v in tree]
    return tuple(tree.shape)


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_by_path(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _tokens(rng, cfg, shape):
    return rng.randint(1, cfg.vocab_size, size=shape).astype(np.int32)


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_train_step_matches_the_reference(arch, microbatch, tiny_shapes):
    jcfg, tcfg, jp, tp = _pair(arch)
    shape = get_shape("tiny_train")
    rng = np.random.RandomState(1)
    toks = _tokens(rng, tcfg, (shape.global_batch, shape.seq_len))
    labels = np.roll(toks, -1, axis=1)
    jfn, jargs, _, _ = jsteps.build_step(jcfg, "tiny_train", _mesh(), remat="none",
                                         microbatch=microbatch)
    tfn, targs, _, _ = tsteps.build_step(tcfg, "tiny_train", make_host_mesh(), remat="none",
                                         microbatch=microbatch, device="cpu")
    jopt = jax.tree.map(jnp.zeros_like, jargs[1])._replace(step=jnp.int32(STEP))
    jparams, jopt, jloss = jax.jit(jfn)(jp, jopt, jnp.asarray(toks), jnp.asarray(labels))
    assert isinstance(targs[1], AdamWState) and isinstance(jargs[1], JAdamWState)
    assert _layout(targs[1].mu) == _layout(tp)  # the moments mirror the params
    zeros = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32), tp)
    opt = AdamWState(torch.tensor(STEP, dtype=torch.int32), zeros,
                     tree_map(torch.zeros_like, zeros))
    params, opt, loss = tfn(tp, opt, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(opt.step) == int(jopt.step) == STEP + 1
    lr = float(jlr_schedule(jnp.int32(STEP), 3e-4, 100, 1000))
    mus, nus, news = (_leaves_by_path(opt.mu), _leaves_by_path(opt.nu),
                      _leaves_by_path(params))
    jmus, jnus, jnews = (_leaves_by_path(jopt.mu), _leaves_by_path(jopt.nu),
                         _leaves_by_path(jparams))
    assert sorted(mus) == sorted(jmus) == sorted(news) == sorted(jnews)
    for path in jmus:
        mu, jmu = mus[path].numpy(), np.asarray(jmus[path])
        mu_tol = GRAD_TOL * max(float(np.abs(jmu).max()), 1e-30)
        np.testing.assert_allclose(mu, jmu, rtol=0, atol=mu_tol, err_msg=path)
        g, jg = np.sqrt(nus[path].numpy()), np.sqrt(np.asarray(jnus[path]))
        np.testing.assert_allclose(g, jg, rtol=0, atol=GRAD_TOL * max(float(jg.max()), 1e-30),
                                   err_msg=path)
        new, jnew = news[path].detach().numpy(), np.asarray(jnews[path])
        resolved = np.abs(jmu) > 10 * mu_tol
        np.testing.assert_allclose(new[resolved], jnew[resolved], rtol=1e-5, atol=1e-6,
                                   err_msg=path)
        assert float(np.abs(new - jnew).max()) <= 2 * lr + 1e-6, path


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "paligemma-3b"])
def test_prefill_step_matches_the_reference(arch, tiny_shapes):
    jcfg, tcfg, jp, tp = _pair(arch)
    shape = get_shape("tiny_prefill")
    rng = np.random.RandomState(2)
    toks = _tokens(rng, tcfg, (shape.global_batch, shape.seq_len))
    jfn, jargs, _, jout = jsteps.build_step(jcfg, "tiny_prefill", _mesh())
    tfn, targs, _, tout = tsteps.build_step(tcfg, "tiny_prefill", make_host_mesh(),
                                            device="cpu")
    extra_j, extra_t = (), ()
    if tcfg.num_prefix_embeddings:
        pref = rng.standard_normal(tuple(targs[2].shape)).astype(np.float32)
        extra_j, extra_t = (jnp.asarray(pref),), (torch.from_numpy(pref),)
    jl, _ = jax.jit(jfn)(jp, jnp.asarray(toks), *extra_j)
    tl, caches = tfn(tp, torch.from_numpy(toks), *extra_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert sorted(caches) == sorted(tout[1])


def _random_caches(jcfg, jm, B, S, rng):
    caches = jax.tree.map(np.asarray, jm.init_caches(B, S))
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5).astype(a.dtype), caches)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_decode_step_matches_the_reference(arch, tiny_shapes):
    jcfg, tcfg, jp, tp = _pair(arch)
    shape = get_shape("tiny_decode")
    B, S = shape.global_batch, shape.seq_len
    rng = np.random.RandomState(3)
    jc = _random_caches(jcfg, jbuild_model(jcfg), B, S, rng)
    tok = _tokens(rng, tcfg, (B,))
    lengths = rng.randint(1, S - 1, size=B).astype(np.int32)
    jfn, _, _, _ = jsteps.build_step(jcfg, "tiny_decode", _mesh())
    tfn, targs, _, _ = tsteps.build_step(tcfg, "tiny_decode", make_host_mesh(), device="cpu")
    caches = caches_from_jax_numpy(tcfg, jc, device="cpu")
    assert _layout(caches) == _layout(targs[2])
    jl, _ = jax.jit(jfn)(jp, jnp.asarray(tok), jc, jnp.asarray(lengths))
    tl, _ = tfn(tp, torch.from_numpy(tok), caches, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_multitenant_decode_step_matches_the_reference(arch, tiny_shapes):
    R = 2
    shape = get_shape("tiny_decode")
    B, S = shape.global_batch // R, shape.seq_len
    pairs = [_pair(arch, seed=t) for t in range(R)]
    jcfg, tcfg = pairs[0][0], pairs[0][1]
    jm = jbuild_model(jcfg)
    rng = np.random.RandomState(4)
    jcs = [_random_caches(jcfg, jm, B, S, rng) for _ in range(R)]
    tok = _tokens(rng, tcfg, (R, B))
    lengths = rng.randint(1, S - 1, size=(R, B)).astype(np.int32)
    jfn, jargs, _, _ = jsteps.build_step(jcfg, "tiny_decode", _mesh(), tenants=R)
    tfn, targs, _, _ = tsteps.build_step(tcfg, "tiny_decode", make_host_mesh(), tenants=R,
                                         device="cpu")
    jparams = jax.tree.map(lambda *a: np.stack(a), *[p[2] for p in pairs])
    jcaches = jax.tree.map(lambda *a: np.stack(a), *jcs)
    tparams = tree_map(lambda *t: torch.stack(t), *[p[3] for p in pairs])
    per = [caches_from_jax_numpy(tcfg, c, device="cpu") for c in jcs]
    tcaches = tree_map(lambda *t: torch.stack(t), *per)
    assert _layout(tparams) == _layout(targs[0]) and _layout(tcaches) == _layout(targs[2])
    jl, _ = jax.jit(jfn)(jparams, jnp.asarray(tok), jcaches, jnp.asarray(lengths))
    tl, _ = tfn(tparams, torch.from_numpy(tok), tcaches, torch.from_numpy(lengths))
    assert tl.shape == (R, B, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def _grads_close(a, b):
    return all(np.allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-5) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_microbatch_equivalence(arch):
    """The port's mirror of ``tests/test_launch.py``'s: k-microbatched
    accumulated gradients equal full-batch gradients (loss rtol 1e-5,
    gradients rtol 1e-4, atol 1e-5), and leaving half the batch out fails
    that check."""
    _, cfg, _, params = _pair(arch)
    model = build_model(cfg, device="cpu", remat="none")
    rng = np.random.RandomState(5)
    B, S, k = 4, 16, 2
    toks = torch.from_numpy(_tokens(rng, cfg, (B, S)))
    labels = torch.roll(toks, -1, dims=1)
    full_loss, full = tsteps.loss_and_grads(model, params, toks, labels)
    mb_loss, mb = tsteps.loss_and_grads(model, params, toks, labels, microbatch=k)
    np.testing.assert_allclose(float(mb_loss), float(full_loss), rtol=1e-5)
    for a, b in zip(mb, full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    half_loss, half = tsteps.loss_and_grads(model, params, toks[:B // 2], labels[:B // 2])
    assert not _grads_close(half, full)
    assert all(not p.requires_grad for p in tree_leaves(params))


def test_input_specs_and_eligibility_match_the_reference():
    for arch in ("granite-3-8b", "paligemma-3b", "rwkv6-1.6b"):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            want = jsteps.input_specs(jget_config(arch), jget_shape(name))
            got = tsteps.input_specs(get_config(arch), get_shape(name))
            assert sorted(got) == sorted(want)
            for key, w in want.items():
                assert tuple(got[key].shape) == w.shape and got[key].device.type == "meta"
                assert str(got[key].dtype).replace("torch.", "") == str(w.dtype)
    for arch in ("rwkv6-1.6b", "qwen2-7b", "gemma3-27b", "zamba2-7b", "stablelm-1.6b"):
        for name in ("train_4k", "long_500k"):
            assert tsteps.eligible(get_config(arch), name) == \
                jsteps.eligible(jget_config(arch), name)


def test_abstract_args_allocate_nothing_and_specs_pair_with_them():
    cfg = get_config("stablelm-1.6b")
    for name, tenants in (("train_4k", 1), ("prefill_32k", 1), ("decode_32k", 1),
                          ("decode_32k", 4)):
        _, args, in_specs, out_specs = tsteps.build_step(
            cfg, name, make_host_mesh(), tenants=tenants, device="meta")
        leaves = [t for t in tree_leaves(list(args)) if isinstance(t, torch.Tensor)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
        from repro_torch.distributed.sharding import spec_leaves

        assert len(spec_leaves(list(args))) == len(spec_leaves(list(in_specs)))

"""The port's training substrate against the JAX package's: the optimizer,
the schedule, the synthetic data stream, the checkpoint file and the train
step. Inputs are numpy, fed to both packages.

Tolerances: ``lr_schedule``, the grad norm and the lr within 1e-6
relative of the reference, and ``adamw_update``'s params and moments over
5 steps within 1e-6 of each leaf's largest magnitude (both do float32
arithmetic, but the global norm is a float32 sum whose order XLA and
PyTorch choose differently: one ulp in it moves every clipped gradient by
one ulp, which a moment that cancels over the steps shows as a larger
relative change of a near-zero element); data
batches and checkpoint files byte-equal; one train step from the same
converted params within the forward_train tolerances of
``test_torch_train_models.py`` (loss 1e-5 relative; params 2e-4 of the
leaf's largest reference magnitude, plus a quarter of one step's lr: Adam
divides the first moment by the root of the second, and where a gradient
element is near eps (1e-8) that quotient turns float32 reordering into a
visible share of the step; a wrong update moves elements by whole steps).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.training import SyntheticTokenStream as JStream  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro.training.optimizer import adamw_update as jadamw_update  # noqa: E402
from repro.training.optimizer import lr_schedule as jlr_schedule  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax_numpy, params_to_jax_numpy  # noqa: E402
from repro_torch.training import SyntheticTokenStream, make_train_step, train  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    AdamWState,
    adamw_init,
    adamw_update,
    lr_schedule,
)

OPT_RTOL = 1e-6


# ------------------------------------------------------------------ optimizer
class TestOptimizer:
    """The reference's four optimizer tests, mirrored on the port."""

    def test_adamw_decreases_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        opt = adamw_init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, opt, _ = adamw_update(grads, opt, params, torch.tensor(0.05),
                                          weight_decay=0.0)
        np.testing.assert_allclose(params["w"].numpy(), [0.0, 0.0], atol=1e-2)

    def test_grad_clipping(self):
        params = {"w": torch.zeros(3)}
        opt = adamw_init(params)
        _, _, m = adamw_update({"w": torch.full((3,), 1e6)}, opt, params, torch.tensor(0.1),
                               grad_clip=1.0)
        assert float(m["grad_norm"]) > 1e5  # reported raw

    def test_weight_decay_pulls_to_zero(self):
        params = {"w": torch.tensor([10.0])}
        opt = adamw_init(params)
        for _ in range(100):
            params, opt, _ = adamw_update({"w": torch.zeros(1)}, opt, params, torch.tensor(0.1),
                                          weight_decay=0.5)
        assert abs(float(params["w"][0])) < 1.0

    def test_lr_schedule_shape(self):
        lrs = [float(lr_schedule(torch.tensor(s), 1e-3, 10, 100)) for s in range(101)]
        assert lrs[0] == 0.0
        assert lrs[10] == pytest.approx(1e-3, rel=1e-3)
        assert lrs[100] == pytest.approx(1e-4, rel=1e-2)  # min_ratio * base
        assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # monotone decay


def test_lr_schedule_matches_reference():
    for warmup, total in ((10, 100), (0, 50), (5, 5), (100, 1000)):
        for s in list(range(0, 120, 7)) + [total, total + 3]:
            want = float(jlr_schedule(jnp.asarray(s, jnp.int32), 3e-4, warmup, total))
            got = float(lr_schedule(torch.tensor(s, dtype=torch.int32), 3e-4, warmup, total))
            assert got == pytest.approx(want, rel=OPT_RTOL, abs=1e-12), (warmup, total, s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_over_five_steps(dtype):
    """The same f32 (or bf16) tree and gradients through 5 updates, the
    schedule feeding the lr, a clip that binds on some steps: params,
    moments, step, grad norm and lr equal the reference's."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}, "e": [(4,), (1, 3)]}

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    init = {"a": draw((3, 5), 1), "b": {"c": draw((7,), 1), "d": draw((2, 2, 2), 1)},
            "e": [draw((4,), 1), draw((1, 3), 1)]}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), init)
    tp = jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), init)
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    for step in range(5):
        grads = jax.tree.map(lambda s: draw(s, 0.5 if step % 2 else 3.0), shapes,
                             is_leaf=lambda x: isinstance(x, tuple))
        jlr = jlr_schedule(jopt.step, 1e-2, 2, 5)
        tlr = lr_schedule(topt.step, 1e-2, 2, 5)
        jp, jopt, jm = jadamw_update(jax.tree.map(jnp.asarray, grads), jopt, jp, jlr)
        tp, topt, tm = adamw_update(jax.tree.map(torch.from_numpy, grads), topt, tp, tlr)
        assert int(topt.step) == int(jopt.step) == step + 1
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=OPT_RTOL)
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        for g, w in zip(jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), got)),
                        jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), want))):
            np.testing.assert_allclose(g, w, rtol=0, atol=OPT_RTOL * float(np.abs(w).max()))


def test_adamw_updates_in_place():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    leaf = p["w"]
    opt = adamw_init(p)
    assert isinstance(opt, AdamWState) and opt.mu["w"].dtype == torch.float32
    out, opt2, _ = adamw_update({"w": torch.ones(4)}, opt, p, torch.tensor(0.1))
    assert out["w"] is leaf and leaf.dtype == torch.bfloat16
    assert opt2.mu["w"] is opt.mu["w"] and float(opt2.mu["w"][0]) > 0


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (1, 3), (42, 100)])
def test_data_batches_equal_reference(seed, step):
    kw = dict(vocab_size=97, seq_len=33, batch_size=3, seed=seed)
    t1, l1 = SyntheticTokenStream(**kw).batch(step)
    t2, l2 = JStream(**kw).batch(step)
    assert t1.dtype == t2.dtype and t1.tobytes() == t2.tobytes()
    assert l1.tobytes() == l2.tobytes()


def test_data_deterministic_and_shifted():
    ds = SyntheticTokenStream(vocab_size=100, seq_len=16, batch_size=4, seed=1)
    t1, l1 = ds.batch(7)
    t2, _ = ds.batch(7)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(t1[:, 1:], l1[:, :-1])
    it = iter(ds)
    np.testing.assert_array_equal(next(it)[0], ds.batch(0)[0])


# ------------------------------------------------------------------ checkpoint
def _ref_tree():
    return {"a": jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
            "b": {"c": jnp.asarray([1.5, -2.5], jnp.float32)},
            "s": jnp.asarray(3, jnp.int32)}


def _port_tree():
    # another insertion order: the file follows sorted keys, as jax.tree.flatten does
    return {"s": torch.tensor(3, dtype=torch.int32),
            "b": {"c": torch.tensor([1.5, -2.5])},
            "a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}


@pytest.mark.parametrize("step", [42, None, 0, 255, 70000, -7, -300])
def test_checkpoint_file_is_byte_equal_to_reference(tmp_path, step):
    jpath, tpath = os.path.join(tmp_path, "j.msgpack"), os.path.join(tmp_path, "t.msgpack")
    jckpt.save_checkpoint(jpath, _ref_tree(), step=step)
    ckpt.save_checkpoint(tpath, _port_tree(), step=step)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_checkpoint_wide_headers_byte_equal(tmp_path):
    """More than 15 leaves and leaves over 255 and 65535 bytes: the array16,
    bin16 and bin32 headers."""
    shapes = [(3,), (70,), (20000,)] * 6
    jtree = {f"k{i:02d}": jnp.full(s, i, jnp.float32) for i, s in enumerate(shapes)}
    ttree = {f"k{i:02d}": torch.full(s, float(i)) for i, s in enumerate(shapes)}
    jpath, tpath = os.path.join(tmp_path, "j"), os.path.join(tmp_path, "t")
    jckpt.save_checkpoint(jpath, jtree, step=1)
    ckpt.save_checkpoint(tpath, ttree, step=1)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_checkpoint_restores_across_packages(tmp_path):
    jpath, tpath = os.path.join(tmp_path, "j"), os.path.join(tmp_path, "t")
    jckpt.save_checkpoint(jpath, _ref_tree(), step=9)
    ckpt.save_checkpoint(tpath, _port_tree(), step=11)
    out = ckpt.restore_checkpoint(jpath, _port_tree())
    assert out["step"] == 9 and list(out["tree"]) == ["s", "b", "a"]
    for k, ref in _port_tree().items():
        got = out["tree"][k] if k != "b" else out["tree"]["b"]["c"]
        ref = ref if k != "b" else ref["c"]
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    back = jckpt.restore_checkpoint(tpath, _ref_tree())
    assert back["step"] == 11
    for a, b in zip(jax.tree.leaves(back["tree"]), jax.tree.leaves(_ref_tree())):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_checkpoint_roundtrip_of_an_optimizer_state(tmp_path):
    params = {"w": torch.randn(4, 3).to(torch.bfloat16), "b": [torch.randn(3)]}
    opt = adamw_init(params)
    adamw_update({"w": torch.ones(4, 3), "b": [torch.ones(3)]}, opt, params, torch.tensor(0.1))
    tree = {"params": params, "opt": opt}
    path = os.path.join(tmp_path, "ck.msgpack")
    ckpt.save_checkpoint(path, tree, step=3)
    out = ckpt.restore_checkpoint(path, tree)
    assert isinstance(out["tree"]["opt"], AdamWState)
    for a, b in zip(ckpt.flatten(out["tree"]), ckpt.flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_structure_mismatch_raises(tmp_path):
    path = os.path.join(tmp_path, "ck.msgpack")
    ckpt.save_checkpoint(path, {"a": torch.zeros(3)}, step=0)
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2)})


# ------------------------------------------------------------------ train step
def test_one_train_step_equals_reference():
    """``make_train_step`` steps from converted params: loss, grad norm
    and the updated params equal the reference's jitted step's."""
    arch = "stablelm-1.6b"
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks, labels = SyntheticTokenStream(tcfg.vocab_size, 16, 2, seed=3).batch(0)
    kw = dict(base_lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jmake_train_step(jm, **kw))
    jopt = jadamw_init(jp)
    for _ in range(2):  # the schedule's lr is 0 at step 0, so take two steps
        jp, jopt, jmet = jstep(jp, jopt, jnp.asarray(toks), jnp.asarray(labels))
    tstep = make_train_step(tm, **kw)
    topt = adamw_init(tp)
    for _ in range(2):
        tp, topt, tmet = tstep(tp, topt, torch.from_numpy(toks).long(),
                               torch.from_numpy(labels).long())
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-5), key
    got = params_to_jax_numpy(tcfg, tp)
    lr = float(jmet["lr"])
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * float(np.abs(w).max()) + 0.25 * lr)


def test_train_logs_in_the_reference_format_and_checkpoints(tmp_path):
    cfg = dataclasses.replace(smoke_variant(get_config("rwkv6-1.6b")), dtype="float32")
    m = build_model(cfg, device="cpu")
    data = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=0)
    logs = []
    path = os.path.join(tmp_path, "ck.msgpack")
    state = train(m, data, steps=3, log_every=2, base_lr=1e-3, warmup_steps=1,
                  checkpoint_path=path, checkpoint_every=2, log_fn=logs.append)
    assert [line.split()[1] for line in logs] == ["0", "2"]
    for line in logs:
        float(line.split("loss")[1].split()[0])
        assert "grad_norm" in line and line.endswith("s")
    assert state.step == 3 and int(state.opt.step) == 3
    out = ckpt.restore_checkpoint(path, {"params": state.params, "opt": state.opt})
    assert out["step"] == 2
    for a, b in zip(ckpt.flatten(out["tree"]), ckpt.flatten({"params": state.params,
                                                             "opt": state.opt})):
        assert torch.equal(a, b)


@pytest.mark.slow
def test_loss_decreases_end_to_end(tmp_path):
    """The reference's end-to-end test, mirrored (and marked slow, as it is)."""
    cfg = dataclasses.replace(smoke_variant(get_config("stablelm-1.6b")), dtype="float32")
    m = build_model(cfg, device="cpu")
    data = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4, seed=0)
    logs = []
    train(m, data, steps=25, log_every=5, base_lr=1e-3, warmup_steps=5,
          checkpoint_path=os.path.join(tmp_path, "ck.msgpack"), checkpoint_every=20,
          log_fn=logs.append)
    first = float(logs[0].split("loss")[1].split()[0])
    last = float(logs[-1].split("loss")[1].split()[0])
    assert last < first - 0.5, (first, last)
    assert os.path.exists(os.path.join(tmp_path, "ck.msgpack"))

"""The captured train step (``repro_torch.training.graphs``) on the CPU.

CUDA graphs exist only on the card, where ``chip_smoke.py`` (phase 10e)
holds graphed train steps against eager ones at full width. Here: the rule
that picks graphs or eager for ``train()`` and ``launch/train.py``; the
program's order (one eager warm-up, one capture that runs nothing, then
replays), its launch counts and its staged batches, through a stand-in for
the card's two calls (``CpuTrainShare``); a graph-route program in lockstep
with an eager one over smoke models, the step counter and lr advancing at
every replay, and the variant that does not copy its counter back caught;
and ``train()`` on the graph route equal to ``train()`` eager.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import SyntheticTokenStream, make_train_step, train  # noqa: E402
from repro_torch.training import graphs  # noqa: E402
from repro_torch.training.optimizer import AdamWState, adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

CPU = torch.device("cpu")
B, S = 2, 8


class FakeGraph:
    def __init__(self, replay):
        self.replay = replay


class CpuTrainShare:
    """``TrainShare`` without a card. The warm-up runs the step. A capture
    runs it and puts the program's params, moments and step counter back as
    they were (a capture on the card runs nothing), and returns a graph
    whose replay runs the step again over the same static buffers into the
    same static metrics, its Python-side counts taken back out (a replay on
    the card runs no Python; the program counts the captured launches)."""

    def __init__(self, device=CPU, fail=False):
        self.fail = fail
        self.warm_ups = 0

    def warm_up(self, step, tokens, labels):
        self.warm_ups += 1
        return step(tokens, labels)

    def capture(self, step, tokens, labels):
        state = tree_leaves(step.params) + tree_leaves(step.opt)
        saved = [t.detach().clone() for t in state]
        out = step(tokens, labels)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

        def replay():
            with ops.capturing():
                new = step(tokens, labels)
            for k, v in out.items():
                v.copy_(new[k])
        return FakeGraph(replay), out, 0


class FrozenCounter(graphs.TrainStep):
    """The trap: a step that keeps the new step counter as a new tensor and
    never writes it into the persistent one."""

    def advance(self, opt):
        pass


@pytest.fixture
def counters():
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    ops.reset_counters()
    yield ops.COUNTERS
    for k, c in ops.COUNTERS.items():
        c.reset()
        c.add(saved[k])


def smoke_model(arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    return cfg, build_model(cfg, device="cpu")


def seeded_state(model, seed=0):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    params = model.init(gen)
    return params, adamw_init(params)


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_graphed_program_off_the_card_raises(device):
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.train_program(lambda *a: None, {}, None, (B, S), torch.device(device), True)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("graphs_arg", [None, False])
def test_off_the_card_the_program_runs_eagerly(device, graphs_arg):
    opt = AdamWState(torch.zeros((), dtype=torch.int32, device=device), {}, {})
    prog = graphs.train_program(lambda *a: None, {}, opt, (B, S), torch.device(device),
                                graphs_arg)
    assert prog.graphs is None and prog.stats()["graphed"] is False


def test_train_asking_for_graphs_on_the_cpu_raises():
    cfg, m = smoke_model("stablelm-1.6b")
    data = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=0)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        train(m, data, steps=1, graphs=True, log_fn=lambda line: None)


def test_the_launcher_maps_its_graphs_flag(capsys):
    from repro_torch.launch import train as launch_train

    assert launch_train.GRAPHS == {"auto": None, "on": True, "off": False}
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        launch_train.main(["--device", "cpu", "--graphs", "on", "--steps", "1", "--batch", "1",
                           "--seq", "8"])
    capsys.readouterr()
    for flag in ("off", "auto"):
        launch_train.main(["--device", "cpu", "--graphs", flag, "--steps", "2", "--batch", "1",
                           "--seq", "8"])
        out = capsys.readouterr().out.splitlines()
        assert out[0] == "training stablelm-1.6b-smoke on cpu" and out[-1] == "done"
        assert [line.split()[1] for line in out[1:-1]] == ["0", "1"]


# ------------------------------------------------- a stand-in for the card
def toy(seen):
    """A step with the counts of one layer of K4 (forward twice, backward
    once) and one plain call, that adds the batch to its param and records
    the buffers and values it was handed."""

    def step_fn(params, opt, tokens, labels):
        fa, bwd = ops.COUNTERS["flash_attention"], ops.COUNTERS["flash_attention_bwd"]
        fa.launched("wgmma")
        fa.launched("wgmma")
        bwd.launched("wgmma")
        ops.COUNTERS["wkv6_scan"].plain_calls += 1
        seen.append((tokens.data_ptr(), labels.data_ptr(), tokens.tolist(), labels.tolist()))
        with torch.no_grad():
            params["w"].add_((tokens - labels).sum().float())
        step = opt.step + 1
        return params, AdamWState(step, opt.mu, opt.nu), {
            "loss": params["w"].detach().sum(), "lr": step.float() * 0.5}
    return step_fn


def toy_program(seen, share):
    params = {"w": torch.zeros(3)}
    opt = AdamWState(torch.zeros((), dtype=torch.int32), {"w": torch.zeros(3)},
                     {"w": torch.zeros(3)})
    return graphs.TrainProgram(graphs.TrainStep(toy(seen), params, opt), (B, S), CPU, share)


def test_order_counts_and_staged_batches(counters):
    seen = []
    share = CpuTrainShare()
    prog = toy_program(seen, share)
    rng = np.random.default_rng(0)
    total = 0
    for i in range(6):
        tok, lab = rng.integers(0, 50, (B, S)), rng.integers(0, 50, (B, S))
        total += int((tok - lab).sum())
        got = prog.run(tok, lab)
        # every step read the program's static buffers, holding this batch
        assert seen[-1] == (prog.tokens.data_ptr(), prog.labels.data_ptr(), tok.tolist(),
                            lab.tolist())
        assert float(got["loss"]) == 3 * total and float(got["lr"]) == 0.5 * (i + 1)
        assert int(prog.opt.step) == i + 1 and prog.params["w"].tolist() == [total] * 3
        fa = counters["flash_attention"]
        if i == 0:  # the eager warm-up
            assert (prog.eager_passes, prog.captures, prog.replays, share.warm_ups) == (1, 0, 0, 1)
            assert (fa.launches, counters["flash_attention_bwd"].launches) == (2, 1)
        if i == 1:  # the capture counted nothing, its replay what the graph launches
            assert (prog.eager_passes, prog.captures, prog.replays) == (1, 1, 1)
            assert prog.launches["flash_attention"].variants == {"wgmma": 2}
            assert prog.launches["wkv6_scan"].plain_calls == 1
            static = got
        if i > 1:  # a replay refills the graph's static metrics
            assert got is static
        assert fa.variants == {"wgmma": 2 * (i + 1)}
        assert counters["flash_attention_bwd"].variants == {"wgmma": i + 1}
        assert counters["wkv6_scan"].plain_calls == i + 1
    assert prog.stats() == {"graphed": True, "steps": 6, "eager_passes": 1, "captures": 1,
                            "replays": 5, "capture_s": prog.capture_s, "pool_bytes": 0}


def test_a_failed_capture_raises_and_runs_nothing_eagerly(counters):
    seen = []
    prog = toy_program(seen, CpuTrainShare(fail=True))
    batch = np.ones((B, S), dtype=np.int64), np.zeros((B, S), dtype=np.int64)
    prog.run(*batch)
    with pytest.raises(RuntimeError, match="capturing"):
        prog.run(*batch)
    assert (prog.eager_passes, prog.captures, prog.replays) == (1, 0, 0)
    assert int(prog.opt.step) == 1 and prog.params["w"].tolist() == [B * S] * 3
    assert counters["flash_attention"].launches == 2


def test_a_dropped_program_is_freed_at_once():
    """No reference cycle keeps a program (its graph, pool and state) alive
    after its last reference goes: ``train()`` drops its program on return."""
    import gc
    import weakref

    gc.disable()
    try:
        prog = toy_program([], CpuTrainShare())
        for _ in range(3):
            prog.run(np.zeros((B, S)), np.zeros((B, S)))
        assert prog.graph is not None
        gone = weakref.ref(prog)
        del prog
        assert gone() is None
    finally:
        gc.enable()


def test_a_batch_of_another_shape_raises():
    prog = toy_program([], None)
    with pytest.raises(ValueError, match="this program's batch is"):
        prog.run(np.zeros((1, S)), np.zeros((1, S)))


# ------------------------------------- graphed against eager, smoke models
def lockstep(arch, cls, steps=6):
    """An eager program and a graph-route one whose step is a ``cls``
    (``CpuTrainShare``)
    from the same params over the same batches; per step (loss, grad_norm,
    lr) of each, and both programs."""
    cfg, m = smoke_model(arch)
    step_fn = make_train_step(m, base_lr=1e-2, warmup_steps=3, total_steps=steps)
    eager = graphs.TrainProgram(graphs.TrainStep(step_fn, *seeded_state(m)), (B, S), CPU)
    graph = graphs.TrainProgram(cls(step_fn, *seeded_state(m)), (B, S), CPU, CpuTrainShare())
    data = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=1)
    rows = []
    for _, (tok, lab) in zip(range(steps), data):
        rows.append([tuple(float(m[k]) for k in ("loss", "grad_norm", "lr"))
                     for m in (eager.run(tok, lab), graph.run(tok, lab))])
    return rows, eager, graph


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_graph_route_steps_equal_eager(arch):
    rows, eager, graph = lockstep(arch, graphs.TrainStep)
    assert (graph.eager_passes, graph.captures, graph.replays) == (1, 1, 5)
    for e, g in rows:
        assert e == g
    lrs = [e[2] for e, _ in rows]
    assert len(set(lrs)) == len(lrs)  # the lr moves every step: the counter advanced
    assert int(eager.opt.step) == int(graph.opt.step) == len(rows)
    for a, b in zip(tree_leaves(eager.params) + tree_leaves(eager.opt),
                    tree_leaves(graph.params) + tree_leaves(graph.opt)):
        assert torch.equal(a, b)


def test_a_counter_that_is_not_written_back_is_caught():
    rows, eager, graph = lockstep("stablelm-1.6b", FrozenCounter)
    assert rows[0][0] == rows[0][1]  # the first step starts from the same state
    assert any(e[2] != g[2] for e, g in rows[1:])  # then the lr freezes
    assert int(graph.opt.step) == 0 != int(eager.opt.step)


# ------------------------------------------------ train() on the graph route
def test_train_on_the_graph_route_equals_eager_train(tmp_path, monkeypatch):
    cfg, m = smoke_model("rwkv6-1.6b")
    runs, made = {}, []
    make = graphs.train_program
    monkeypatch.setattr(graphs, "train_program",
                        lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    for route in ("eager", "graph"):
        if route == "graph":
            monkeypatch.setattr(graphs, "use_graphs", lambda device, graphs=None: True)
            monkeypatch.setattr(graphs, "TrainShare", CpuTrainShare)
        data = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S, batch_size=B, seed=0)
        logs = []
        path = os.path.join(tmp_path, f"{route}.msgpack")
        state = train(m, data, steps=5, log_every=1, base_lr=1e-3, warmup_steps=2,
                      checkpoint_path=path, checkpoint_every=2, log_fn=logs.append)
        runs[route] = ([line.rsplit(None, 1)[0] for line in logs], open(path, "rb").read(),
                       made[-1].stats(), state)
    (elog, eck, estats, est), (glog, gck, gstats, gst) = runs["eager"], runs["graph"]
    assert len(elog) == 5 and glog == elog and gck == eck
    assert (estats["graphed"], estats["eager_passes"], estats["replays"]) == (False, 5, 0)
    assert (gstats["graphed"], gstats["eager_passes"], gstats["captures"],
            gstats["replays"]) == (True, 1, 1, 4)
    assert int(gst.opt.step) == 5 and gst.step == 5
    assert not any(p.requires_grad for p in tree_leaves(gst.params))

"""``chip_smoke.py``'s phase 10 (training) rehearsed on the CPU.

``torch.cuda`` is stubbed; K4's and K5's forward and backward wrappers
count a launch of their variant and run their plain versions; the ops take
the autograd route they take on the card (the ``torch.autograd.Function``
whose forward and backward are those wrappers) instead of the CPU's plain
route, and the AdamW wrappers count a launch a pack and run the plain
update; stablelm-1.6b and rwkv6-1.6b are their bf16 smoke variants and the
phase's shapes are shrunk. So the phase's control flow and checks run here:
the backward kernels against both yardsticks, the kernel path against the
plain path in float32 and bf16, ``train()`` with its launch, loss and
checkpoint checks, the graphed train step against the eager one with its two
controls (10e; the card's two graph calls replaced by
``test_torch_train_graphs.CpuTrainShare``, the route rule made to pick graphs
on the CPU), and the rows and records it prints. The card's numbers come only
from the card.
"""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]


class _Event:
    def __init__(self, **_):
        pass

    def record(self):
        pass

    def elapsed_time(self, _other):
        return 1.0


@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke`` with the card stubbed and phase 10 shrunk."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    import repro_torch.config
    from repro_torch.config import smoke_variant
    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6_scan as wk

    from repro_torch.training import graphs as tg
    from test_torch_train_graphs import CpuTrainShare

    for name in ("synchronize", "_sleep", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated", "max_memory_reserved",
                 "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    get = repro_torch.config.get_config
    monkeypatch.setattr(repro_torch.config, "get_config", lambda arch: dataclasses.replace(
        smoke_variant(get(arch)), dtype="bfloat16"))

    def flash(q, k, v, *, causal=True, window=0, scale=None, logit_softcap=0.0, q_offset=None,
              lse=None):
        fa.counter.launched(fa.variant(q.dtype, q.shape[-1]))
        if lse is not None:
            assert fa.variant(q.dtype, q.shape[-1]) == "wgmma"
            lse.copy_(ref.attention_lse(q, k, causal=causal, window=window, scale=scale,
                                        q_offset=q_offset))
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                             q_offset=q_offset)

    def flash_bwd(q, k, v, o, do, *, lse=None, causal=True, window=0, scale=None, kernel=None):
        kind = kernel or fa.bwd_variant(q.dtype, q.shape[-1])
        assert (lse is not None) == (kind == "wgmma")
        fa.bwd_counter.launched(kind)
        return ref.attention_bwd(q, k, v, o, do, causal=causal, window=window, scale=scale)

    def scan(r, k, v, w, u, init_state=None, final_state=None, *, kernel=None, ckpt=None):
        wk.counter.launched(kernel or wk.variant(r.dtype, r.shape[-2]))
        if ckpt is not None:
            N, V = r.shape[-1], v.shape[-1]
            ckpt.zero_()[..., :N, :V] = ref.wkv6_chunk_states(k, v, w)
        return ref.wkv6_scan(r, k, v, w, u, init_state)

    def scan_bwd(r, k, v, w, u, do, *, ckpt=None, kernel=None):
        kind = kernel or wk.bwd_variant(r.dtype, r.shape[-2])
        assert (ckpt is not None) == (kind == "cluster")
        wk.bwd_counter.launched(kind)
        return ref.wkv6_scan_bwd(r, k, v, w, u, do)

    def adamw_norm(grads):  # one launch a pack, as the card's wrapper counts
        for _ in aw.plan([g.numel() for g in grads], [g.dtype for g in grads]).packs:
            aw.norm_counter.launched(aw.VARIANT)
        return ref.adamw_norm(grads)

    def adamw_update(params, grads, mus, nus, scale, bc1, bc2, lr, **hyper):
        for _ in aw.plan([p.numel() for p in params], [p.dtype for p in params]).packs:
            aw.counter.launched(aw.VARIANT)
        ref.adamw_update(params, grads, mus, nus, scale, bc1, bc2, lr, **hyper)

    def flash_op(q, k, v, *, causal=True, window=0, scale=None, logit_softcap=0.0,
                 q_offset=None):  # ops.flash_attention's route for a CUDA tensor
        if ops._grad_needed(q, k, v):
            fa.check_bwd(q, k, q_offset=q_offset)
            return ops._FlashAttention.apply(q, k, v, causal, window, scale)
        return fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                  q_offset=q_offset)

    def scan_op(r, k, v, w, u, init_state=None, final_state=None):  # ops.wkv6_scan's, likewise
        if ops._grad_needed(r, k, v, w, u):
            wk.check_bwd(r, v, init_state, final_state)
            return ops._WKV6Scan.apply(r, k, v, w, u)
        return wk.wkv6_scan(r, k, v, w, u, init_state, final_state)

    for mod, name, fn in ((fa, "flash_attention", flash), (fa, "flash_attention_bwd", flash_bwd),
                          (wk, "wkv6_scan", scan), (wk, "wkv6_scan_bwd", scan_bwd),
                          (aw, "norm", adamw_norm), (aw, "update", adamw_update),
                          (ops, "flash_attention", flash_op), (ops, "wkv6_scan", scan_op),
                          (ops, "adamw_norm", lambda grads: aw.norm(grads)),
                          (ops, "adamw_update", lambda *a, **k: aw.update(*a, **k))):
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(chip_smoke, "FLASH_BWD_CASES", ((1, 4, 4, 40, 64, 0),
                                                        (1, 4, 1, 30, 32, 5)))
    monkeypatch.setattr(chip_smoke, "WKV_BWD_CASES", ((1, 2, 20, 16, -3.0, 1.0),
                                                      (1, 2, 17, 16, 1.0, 1.0)))
    monkeypatch.setattr(chip_smoke, "TRAIN_ARCHS", (("stablelm-1.6b", 2, 16, "flash_attention"),
                                                    ("rwkv6-1.6b", 2, 16, "wkv6_scan")))
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 6)
    monkeypatch.setattr(chip_smoke, "TRAIN_LR", 1e-2)
    monkeypatch.setattr(chip_smoke, "TRAIN_WARMUP", 1)
    monkeypatch.setattr(chip_smoke, "TRAIN_CUT_BATCH", 1)
    monkeypatch.setattr(chip_smoke, "TRAIN_CUT_SEQ", 16)
    # 10e and train(): the graph route on the CPU, through the stand-in share
    monkeypatch.setattr(tg, "use_graphs", lambda device, graphs=None: graphs is not False)
    monkeypatch.setattr(tg, "TrainShare", CpuTrainShare)
    monkeypatch.setattr(chip_smoke, "step_kernels", lambda fn: (fn(), (0, 0.0))[1])
    monkeypatch.setattr(chip_smoke, "TRAIN_GRAPH_REPORT", {})
    for name, n in (("GRAPH_TRAIN_STEPS", 4), ("GRAPH_TRAIN_TIMED", 2),
                    ("GRAPH_TRAIN_REPLAYS", 2), ("GRAPH_CONTROL_STEPS", 2)):
        monkeypatch.setattr(chip_smoke, name, n)
    return chip_smoke, ops


def test_phase_10_runs_its_checks_on_the_cpu(smoke):
    chip_smoke, ops = smoke
    rows, records = chip_smoke.phase_train(ops, torch.device("cpu"), 0)
    json.dumps({"train": records, "kernels": rows})
    assert [r["name"] for r in rows] == ["flash_attention_bwd", "wkv6_scan_bwd"] + [
        "adamw_norm", "adamw_update"] * 2
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert all(keys <= set(r) for r in rows)
    assert [(r["variant"], r["prior"]) for r in rows[:2]] == [("wgmma", "cuda_core"),
                                                              ("cluster", "chunked")]
    for rec, row in zip([records[0]] * 2 + [records[1]] * 2, rows[2:]):  # the AdamW kernels
        assert row["launches_by_variant"] == {"multi_tensor": rec["steps"]} == {
            "multi_tensor": row["launches"]} and row["library_ms"] is None
        assert row["shape"].startswith(rec["arch"])
    for rec, row, op in zip(records, rows, ("flash_attention", "wkv6_scan")):
        assert rec["launches"][op + "_bwd"] == row["launches_by_variant"] == {
            row["variant"]: row["launches"]}
        assert row["launches"] == rec["layers"] * rec["steps"]
        assert sum(rec["launches"][op].values()) == 2 * rec["layers"] * rec["steps"]
        assert rec["losses"][-1] < rec["losses"][0] and len(rec["losses"]) == 6
        prog = rec["program"]
        assert (prog["graphed"], prog["eager_passes"], prog["captures"], prog["replays"]) == (
            True, 1, 1, 5)
    assert rows[1]["library_ms"] is None
    report = chip_smoke.TRAIN_GRAPH_REPORT
    json.dumps({"train_graphs": report})
    assert sorted(report) == ["rwkv6-1.6b", "stablelm-1.6b"]
    for arch, op, fwd, bwd in (("stablelm-1.6b", "flash_attention", "wgmma", "wgmma"),
                               ("rwkv6-1.6b", "wkv6_scan", "chunked", "cluster")):
        row = report[arch]
        assert (row["bitwise_steps"], row["state_leaves_differ"]) == (4, 0)
        assert row["launches_per_replay"] == {op: {fwd: 4}, op + "_bwd": {bwd: 2},
                                              "adamw_norm": {"multi_tensor": 1},
                                              "adamw_update": {"multi_tensor": 1}}
        assert row["controls"]["unstaged_batch"]["bitwise_steps"] < 2
        assert row["controls"]["frozen_step_counter"]["bitwise_steps"] < 2


def test_phase_10e_fails_when_a_replay_leaves_its_metrics_stale(smoke, monkeypatch):
    """A graph whose replays do not reach its static outputs fails 10e's
    lockstep check."""
    chip_smoke, ops = smoke
    from repro_torch.training import graphs as tg
    from test_torch_train_graphs import CpuTrainShare

    class StaleShare(CpuTrainShare):
        def capture(self, step, tokens, labels):
            graph, out, reserved = super().capture(step, tokens, labels)
            graph.replay = lambda: None
            return graph, out, reserved
    monkeypatch.setattr(tg, "TrainShare", StaleShare)
    with pytest.raises(chip_smoke.PhaseFailed, match="differs from eager"):
        chip_smoke.graph_train_check(ops, "rwkv6-1.6b", 1, 16, "wkv6_scan",
                                     torch.device("cpu"), 0)


def test_phase_10_fails_when_a_backward_kernel_is_wrong(smoke, monkeypatch):
    chip_smoke, ops = smoke
    from repro_torch.kernels import flash_attention as fa

    wrong = fa.flash_attention_bwd

    def bad_bwd(*args, **kw):
        dq, dk, dv = wrong(*args, **kw)
        return dq, dk * 1.01, dv  # a 1% error in dK
    monkeypatch.setattr(fa, "flash_attention_bwd", bad_bwd)
    with pytest.raises(chip_smoke.PhaseFailed, match="flash_attention_bwd"):
        chip_smoke.phase_train(ops, torch.device("cpu"), 0)


def test_phase_10_fails_when_training_takes_the_plain_path(smoke, monkeypatch):
    chip_smoke, ops = smoke
    monkeypatch.setattr(ops, "wkv6_scan", ops.wkv6_scan_plain)
    monkeypatch.setattr(chip_smoke, "TRAIN_ARCHS", chip_smoke.TRAIN_ARCHS[1:])
    monkeypatch.setattr(chip_smoke, "phase_bwd_kernels", lambda ops, dev, seed: [{}])
    with pytest.raises(chip_smoke.PhaseFailed, match="wkv6_scan"):
        chip_smoke.phase_train(ops, torch.device("cpu"), 0)

"""The port's example scripts (``repro_torch.examples``) on the CPU.

The simulator scripts (``quickstart``, ``policy_sweep``, ``fleet_routing``)
print reports equal to the reference scripts' under ``examples/`` (loaded
by path, their event counts shrunk by their own constants or through their
spec loader), with the reference's cards put in the port's registry and
the port's scripts pointed at them, as the control plane's parity tests
do. The card scripts (``spacetime_ablation``, ``multi_tenant_serving``,
``train_small``) run with ``--device cpu`` at tiny sizes, print the
reference's line formats, and raise with no card unless asked for the
CPU; ``multi_tenant_serving``'s greedy tokens equal the reference
engine's from converted weights, ``train_small``'s loss falls.
"""

import dataclasses
import importlib.util
import os
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

import jax  # noqa: E402

import repro.launch.roofline as jroof  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke_variant  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.examples import (  # noqa: E402
    fleet_routing,
    multi_tenant_serving,
    policy_sweep,
    quickstart,
    spacetime_ablation,
    train_small,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.models.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.sim import fleet as tfleet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EVENTS = 1500


def reference_script(name):
    """``examples/<name>.py`` as a module of its own (the file unchanged)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_hw(name) -> troof.HardwareSpec:
    return troof.HardwareSpec(**dataclasses.asdict(jroof.resolve_spec(name)))


@pytest.fixture
def reference_cards(monkeypatch):
    """The reference's cards in the port's registry under their names, and
    its base card as the fleet's speed-factor base."""
    monkeypatch.chdir(ROOT)
    for name in ("v5e", "v5e_half"):
        monkeypatch.setitem(troof.HARDWARE_SPECS, name, port_hw(name))
    monkeypatch.setattr(tfleet, "BASE_SPEC", port_hw("v5e"))


def printed(capsys, fn):
    fn()
    return capsys.readouterr().out.splitlines()


# ------------------------------------------------------- simulator scripts
def test_quickstart_prints_the_reference_report(reference_cards, monkeypatch, capsys):
    ref = reference_script("quickstart")
    load = ref.SystemSpec.load

    class Shrunk:  # the reference's spec loader, its event count shrunk
        @staticmethod
        def load(path):
            return load(path).replace(**{"workload.events": EVENTS})
    monkeypatch.setattr(ref, "SystemSpec", Shrunk)
    monkeypatch.setattr(quickstart, "HARDWARE_SETS", {})  # the file's own card
    monkeypatch.setattr(quickstart, "EVENTS", EVENTS)
    want = printed(capsys, ref.main)
    got = printed(capsys, quickstart.main)
    cut = [i for i, line in enumerate(want) if line.startswith("next:")][0]
    assert got[:cut] == want[:cut]
    assert got[1].split(", ")[1].startswith(f"{EVENTS} ")
    assert got[cut].startswith("next: python -m repro_torch check")
    assert quickstart.SPEC == ref.SPEC == str(ROOT / "examples" / "specs" / "paper_mix.json")


def test_policy_sweep_prints_the_reference_report(reference_cards, monkeypatch, capsys):
    ref = reference_script("policy_sweep")
    monkeypatch.setattr(ref, "EVENTS", EVENTS)
    monkeypatch.setattr(policy_sweep, "EVENTS", EVENTS)
    monkeypatch.setattr(policy_sweep, "HARDWARE", "v5e")
    want = printed(capsys, ref.main)
    got = printed(capsys, policy_sweep.main)
    assert len(want) == 2 * (3 + 8) and got == want


def test_fleet_routing_prints_the_reference_report(reference_cards, monkeypatch, capsys):
    ref = reference_script("fleet_routing")
    monkeypatch.setattr(ref, "EVENTS", EVENTS)
    monkeypatch.setattr(fleet_routing, "EVENTS", EVENTS)
    monkeypatch.setattr(fleet_routing, "HARDWARE", "v5e")
    monkeypatch.setattr(fleet_routing, "FLEET_SPECS", ["v5e", "v5e_half"])
    want = printed(capsys, ref.main)
    got = printed(capsys, fleet_routing.main)
    assert got == want and "=== mixed v5e + v5e_half fleet" in "\n".join(got)


def test_the_simulator_scripts_name_the_port_cards():
    assert quickstart.HARDWARE_SETS == {"cost_model.hardware": "h100"}
    assert (policy_sweep.HARDWARE, fleet_routing.HARDWARE) == ("h100", "h100")
    assert fleet_routing.FLEET_SPECS == ["h100", "h100_half"]
    assert fleet_routing.HETERO_SPEC == str(ROOT / "examples" / "specs" / "hetero_fleet.json")


# ----------------------------------------------------------- card scripts
@pytest.mark.parametrize("mod,argv", [
    (spacetime_ablation, []),
    (multi_tenant_serving, []),
    (train_small, ["--steps", "1", "--layers", "1", "--d-model", "64"]),
])
def test_card_scripts_raise_without_a_card(mod, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="none is available"):
        mod.main(argv)


@pytest.fixture
def counters():
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    ops.reset_counters()
    yield ops.COUNTERS
    for k, c in ops.COUNTERS.items():
        c.reset()
        c.add(saved[k])


def test_spacetime_ablation_on_the_cpu(monkeypatch, capsys, counters):
    monkeypatch.setattr(spacetime_ablation, "EVENTS", 15)
    monkeypatch.setattr(spacetime_ablation, "TENANTS", 4)
    rows = spacetime_ablation.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"{'window_ms':>10s} {'bucketing':>10s} {'p50 ms':>8s} {'p95 ms':>8s} "
                      f"{'dispatches':>11s} {'hit rate':>9s}")
    assert [(w, b) for w, b, _, _ in rows] == [(w, b) for w in (0.0, 0.002, 0.02)
                                              for b in ("pow2", "exact")]
    for line in out[1:]:
        assert re.fullmatch(r" +\d+\.\d +(pow2|exact) +\d+\.\d\d +\d+\.\d\d +\d+ +\d\.\d\d", line)
    # every dispatch ran the plain version of K1 on the CPU
    assert counters["batched_gemm"].launches == 0
    assert counters["batched_gemm"].plain_calls >= sum(r[3]["dispatches"] for r in rows) > 0


def _tokens(engine):
    return sorted((r.tenant_id, tuple(int(t) for t in r.prompt), tuple(int(t) for t in r.generated))
                  for r in engine.finished)


def test_multi_tenant_serving_tokens_equal_the_reference(monkeypatch, capsys):
    argv = ["-R", "2", "--requests-per-tenant", "2", "--max-new-tokens", "5"]
    ref = reference_script("multi_tenant_serving")
    made = []

    class Watched(ref.MultiTenantEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(ref, "MultiTenantEngine", Watched)
    monkeypatch.setattr(sys, "argv", ["multi_tenant_serving.py"] + argv)
    want = printed(capsys, ref.main)
    # the port's tenants: the reference's weights, converted
    jcfg = dataclasses.replace(jsmoke_variant(jget_config("stablelm-1.6b")), dtype="float32")
    jm = jbuild_model(jcfg)
    key = jax.random.PRNGKey(0)
    jparams = [jax.tree.map(np.asarray, jm.init(jax.random.fold_in(key, t))) for t in range(2)]
    monkeypatch.setattr(multi_tenant_serving, "tenant_params", lambda model, n: [
        params_from_jax_numpy(model.cfg, p, device="cpu") for p in jparams])
    engine = multi_tenant_serving.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _tokens(engine) == _tokens(made[0])
    assert len(engine.finished) == 4 and all(len(r.generated) == 5 for r in engine.finished)
    assert got[0] == want[0] == "arch=stablelm-1.6b (reduced: 2L d=256) R=2 mode=space_time"
    assert re.fullmatch(r"served 4 requests / \d+ tokens in \d+\.\ds \(\d+\.\d tok/s\)", got[2])
    assert re.fullmatch(r"p50 step latency \d+\.\d ms   p95 \d+\.\d ms   inter-tenant spread "
                        r"\d+\.\d%", got[3])
    for g, w in zip(got[4:], want[4:]):  # the first three requests: same prompts, same tokens
        assert g.split(": ", 1)[1] == w.split(": ", 1)[1]
    assert len(got) == len(want) == 7


def test_train_small_loss_falls(tmp_path, monkeypatch, capsys):
    argv = ["--steps", "12", "--layers", "1", "--d-model", "64", "--batch", "2", "--seq", "16",
            "--lr", "1e-2", "--checkpoint", str(tmp_path / "port.msgpack")]
    state = train_small.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    ref = reference_script("train_small")
    monkeypatch.setattr(sys, "argv", ["train_small.py"] + argv[:-1] + [str(tmp_path / "ref")])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]  # the same config, sizes and parameter count
    losses = [float(line.split("loss")[1].split()[0]) for line in got[1:-1]]
    assert [line.split()[1] for line in got[1:-1]] == [line.split()[1] for line in want[1:-1]]
    assert len(losses) == 12 and losses[-1] < losses[0]
    assert got[-1] == f"done at step 12; checkpoint at {tmp_path / 'port.msgpack'}"
    assert state.step == 12 and (tmp_path / "port.msgpack").stat().st_size > 0


def test_train_small_checkpoints_to_a_file_of_its_own():
    path = train_small.default_checkpoint()
    assert os.path.dirname(path) == tempfile.gettempdir() and str(os.getpid()) in path

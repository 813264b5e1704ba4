"""The port's front door (``repro_torch.api``, ``python -m repro_torch``)
against the JAX package's ``repro.api``.

Both packages load the committed specs under ``examples/specs/`` and run
them in one process. The reference's cards enter the port's registry under
their own names for these tests only (``reference_cards``, as
``test_torch_sim.port_hw`` builds them), so the same file names the same
card in both: specs, ``RunReport`` JSON, ``to_bench_json`` bytes and the
``check`` text must then be equal. Without that injection the port's
registry names only H100 parts, and a committed file runs through the
hardware-name rule (``--set cost_model.hardware=h100``). Live runs are
held to decisions on virtual clocks and to invariants on the wall clock.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

from test_torch_sim import assert_same_decisions, assert_same_text, port_hw  # noqa: E402

from repro.api import build as jbuild  # noqa: E402
from repro.api import cli as jcli  # noqa: E402
from repro.api.spec import ServeSpec as JServeSpec  # noqa: E402
from repro.api.spec import SystemSpec as JSpec  # noqa: E402
from repro.core.clock import VirtualClock as JVirtualClock  # noqa: E402
from repro.serving import fleet as jlive  # noqa: E402
from repro.sim.costmodel import CalibratedCostModel as JCalibrated  # noqa: E402
from repro.sim.metrics import to_bench_json as j_bench_json  # noqa: E402

from repro_torch.api import build as tbuild  # noqa: E402
from repro_torch.api import cli as tcli  # noqa: E402
from repro_torch.api.report import RunReport  # noqa: E402
from repro_torch.api.spec import ServeSpec, SystemSpec, set_dotted  # noqa: E402
from repro_torch.core.clock import VirtualClock  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.serving import fleet as tlive  # noqa: E402
from repro_torch.sim import fleet as tfleet  # noqa: E402
from repro_torch.sim.costmodel import CalibratedCostModel  # noqa: E402
from repro_torch.sim.metrics import to_bench_json  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPEC_DIR = ROOT / "examples" / "specs"
SIM_SPECS = ("paper_mix", "hetero_fleet", "deadline_fleet", "traced_fleet", "replay_smoke",
             "partitioned_fleet")
MAX_EVENTS = 1500
H100_SETS = {"cost_model.hardware": "h100"}
H100_FLEET_SETS = {"cost_model.hardware": "h100", "fleet.specs": ["h100", "h100_half"]}


def spec_path(name: str) -> str:
    return str(SPEC_DIR / f"{name}.json")


def h100_sets(name: str):
    """The hardware overrides that run a committed file on the port's card."""
    return H100_FLEET_SETS if name == "hetero_fleet" else H100_SETS


@pytest.fixture
def reference_cards(monkeypatch):
    """The reference's cards in the port's registry under their names, its
    base card as the fleet's speed-factor base, and the repo root as the
    working directory (replay paths are relative to it)."""
    monkeypatch.chdir(ROOT)
    for name in ("v5e", "v5e_half"):
        monkeypatch.setitem(troof.HARDWARE_SPECS, name, port_hw(name))
    monkeypatch.setattr(tfleet, "BASE_SPEC", port_hw("v5e"))


def both(name: str, **dotted):
    """(reference spec, port spec) of a committed file, cut to MAX_EVENTS."""
    jspec = JSpec.load(spec_path(name))
    dotted.setdefault("workload.events", min(MAX_EVENTS, jspec.workload.events))
    return jspec.replace(**dotted), SystemSpec.load(spec_path(name), dotted)


def run_cli(main, argv, capsys):
    """(exit code, stdout, stderr) of one CLI call in this process."""
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("name", SIM_SPECS)
def test_committed_specs_load_as_the_reference(name, reference_cards):
    jspec, tspec = JSpec.load(spec_path(name)), SystemSpec.load(spec_path(name))
    assert tspec.to_dict() == jspec.to_dict()
    assert SystemSpec.from_dict(tspec.to_dict()) == tspec
    assert tspec.to_json() == jspec.to_json()


def test_the_serve_spec_loads_as_the_reference_but_for_its_default_card():
    """serve_smoke names no card: the port's default is "h100", the
    reference's its own."""
    jdoc = JServeSpec.load(spec_path("serve_smoke")).to_dict()
    tdoc = ServeSpec.load(spec_path("serve_smoke")).to_dict()
    assert tdoc["system"]["cost_model"].pop("hardware") == "h100"
    assert jdoc["system"]["cost_model"].pop("hardware") == "v5e"
    assert tdoc == jdoc


@pytest.mark.parametrize("name", SIM_SPECS)
def test_run_reports_and_bench_bytes_equal_the_reference(name, reference_cards):
    """``RunReport`` JSON (spec echo, metrics, scheduler counters, telemetry
    where the recorder is on) and the BENCH export, byte for byte."""
    jspec, tspec = both(name)
    assert_same_text(tspec.build().run().to_json(), jspec.build().run().to_json())
    assert_same_text(to_bench_json(name, {"run": tspec.build().run_metrics()}),
                     j_bench_json(name, {"run": jspec.build().run_metrics()}))


@pytest.mark.parametrize("name", SIM_SPECS)
def test_check_prints_what_the_reference_prints(name, reference_cards, capsys):
    argv = ["check", "--spec", spec_path(name)]
    jrc, jout, _ = run_cli(jcli.main, argv, capsys)
    trc, tout, _ = run_cli(tcli.main, argv, capsys)
    assert trc == jrc == 0
    assert tout == jout


def test_specs_lists_the_reference_names_but_the_h100_cards(capsys):
    jrc, jout, _ = run_cli(jcli.main, ["specs", "--json"], capsys)
    trc, tout, _ = run_cli(tcli.main, ["specs", "--json"], capsys)
    jdoc, tdoc = json.loads(jout), json.loads(tout)
    assert trc == jrc == 0
    assert sorted(tdoc.pop("hardware")) == ["h100", "h100_half", "h100_quarter"]
    jdoc.pop("hardware")
    assert tdoc == jdoc
    _, text, _ = run_cli(tcli.main, ["specs"], capsys)
    assert "h100_half" in text and "v5e" not in text


def test_python_m_repro_torch_runs_with_jax_absent():
    """``python -m repro_torch specs`` in a fresh interpreter where any
    import of jax (or of the reference package) fails."""
    code = ("import sys, runpy\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['repro_torch', 'specs']\n"
            "runpy.run_module('repro_torch', run_name='__main__', alter_sys=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "h100_quarter" in out.stdout


# --------------------------------------------------- the hardware-name rule
@pytest.mark.parametrize("name", [n for n in SIM_SPECS])
def test_a_reference_card_name_raises_naming_h100(name, capsys):
    """Unedited, a committed file's "v5e" is refused by the port's registry
    with the names-listing error; the overrides run it on the H100."""
    with pytest.raises(ValueError, match="h100"):
        SystemSpec.load(spec_path(name))
    rc, _, err = run_cli(tcli.main, ["check", "--spec", spec_path(name)], capsys)
    assert rc == 2 and "'v5e'" in err and "h100_half" in err
    sets = [f"--set={k}={json.dumps(v)}" for k, v in h100_sets(name).items()]
    rc, out, _ = run_cli(tcli.main, ["check", "--spec", spec_path(name)] + sets, capsys)
    assert rc == 0 and "on h100" in out


OVERRIDES = [
    {"workload.events": 100, "workload.seed": 3},
    {"scheduler.batching_window_s": 0.001, "router.policy": "round_robin"},
    {"cost_model.compile_us": 50.0, "observability.enabled": True},
    {"partition.policy": "explicit", "partition.shares": [0.5, 0.5]},
    {"fleet.autoscale.max_replicas": 3},
    {"fleet": {"replicas": 3}},
]


@pytest.mark.parametrize("name", SIM_SPECS)
@pytest.mark.parametrize("overrides", OVERRIDES, ids=str)
def test_the_pre_load_merge_equals_load_then_replace(name, overrides, reference_cards):
    """For a file that loads as it is, merging the overrides into its JSON
    first gives the spec that loading and then ``replace`` gives, in the
    port and in the reference; where the result is invalid, both refuse."""
    path = spec_path(name)
    try:
        want = JSpec.load(path).replace(**overrides).to_dict()
    except ValueError:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            SystemSpec.load(path, overrides)
        return
    assert SystemSpec.load(path, overrides).to_dict() == want
    assert SystemSpec.load(path).replace(**overrides).to_dict() == want


def test_a_nested_section_at_the_top_raises_in_both():
    """``autoscale`` lives under ``fleet``: the reference refuses it when
    it builds the spec, the port when it walks the path."""
    for replace in (JSpec().replace, SystemSpec().replace):
        with pytest.raises(ValueError, match="autoscale"):
            replace(**{"autoscale.policy": "backlog"})


@pytest.mark.parametrize("path", ["workload.nope", "nope.x", "workload.events.x", "mode.x"])
def test_a_bad_override_path_raises_as_the_reference(path):
    with pytest.raises(ValueError) as jerr:
        JSpec().replace(**{path: 1})
    with pytest.raises(ValueError) as terr:
        SystemSpec().replace(**{path: 1})
    assert str(terr.value) == str(jerr.value)
    doc = json.loads(JSpec().to_json())
    with pytest.raises(ValueError) as merr:
        set_dotted(doc, {path: 1})
    assert str(merr.value) == str(jerr.value)


def test_a_partial_file_takes_overrides_of_fields_it_leaves_out(tmp_path):
    """``replay_smoke`` spells out four cost-model fields and no scheduler:
    the merge sets fields the file leaves out, and builds a null section
    from its defaults, as ``replace`` does."""
    overrides = {"cost_model.hardware": "h100", "cost_model.prior_strength": 2.0,
                 "scheduler.max_superkernel_size": 16}
    spec = SystemSpec.load(spec_path("replay_smoke"), overrides)
    assert spec.cost_model.prior_strength == 2.0
    assert spec.scheduler.max_superkernel_size == 16
    assert spec.scheduler.batching_window_s == 0.002


# -------------------------------------------------------------- live runs
LIVE = {"mode": "live", "workload.events": 400, "workload.rate_hz": 2000.0,
        "fleet.replicas": 2, "router.policy": "least_cost",
        "scheduler.admission_policy": "feasibility", "scheduler.oversubscription": 1.25,
        "observability.enabled": True}


def virtual_fleets(monkeypatch):
    """Both packages' ``LiveFleet`` on virtual clocks (the parity twin of
    the fleet simulator), as their ``LiveRun``s build them."""
    for mod, clock in ((jlive, JVirtualClock), (tlive, VirtualClock)):
        base = mod.LiveFleet

        class Virtual(base):
            def __init__(self, *args, **kw):
                super().__init__(*args, clock_factory=clock, **kw)

        monkeypatch.setattr(mod, "LiveFleet", Virtual)


@pytest.mark.parametrize("arch", ["fake", "null"])
def test_live_runs_on_virtual_clocks_decide_as_the_reference(arch, reference_cards,
                                                             monkeypatch):
    """``LiveRun`` with the model-free engines: the same routing choices
    and prices, admission reason codes and metrics bytes."""
    virtual_fleets(monkeypatch)
    jspec = JSpec().replace(**LIVE, **{"workload.arch": arch})
    tspec = SystemSpec().replace(**LIVE, **{"workload.arch": arch, "cost_model.hardware": "v5e"})
    assert tspec.to_dict() == jspec.to_dict()
    jrun, trun = jbuild.LiveRun(jspec), tbuild.LiveRun(tspec)
    jm, tm = jrun.run_metrics(), trun.run_metrics()
    assert_same_text(to_bench_json("live", {"run": tm}), j_bench_json("live", {"run": jm}))
    assert_same_decisions(jrun.last_recorder, trun.last_recorder)
    assert sum(tm.routed_counts) > 0 and trun.engine_name == arch


def _tokens_by_request(monkeypatch):
    """Record what every real engine replica answers: (tenant, prompt) ->
    tokens, appended per run."""
    seen = []
    execute = tlive.EngineReplica.execute

    def recording(self, batch):
        outs = execute(self, batch)
        for w, toks in zip(batch, outs):
            seen.append(((int(w.tenant_id), tuple(w.payload)), tuple(toks)))
        return outs

    monkeypatch.setattr(tlive.EngineReplica, "execute", recording)
    return seen


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_a_real_architecture_serves_on_the_cpu(arch, tmp_path, monkeypatch):
    """Two replicas of the smoke variant in float32 on the wall clock, with
    a fleet calibration file: every request answered with its tokens,
    inside the vocabulary, equal on a second run, the report passes the
    CLI's live check, the fitted tables are saved, and the second run
    loads them."""
    seen = _tokens_by_request(monkeypatch)
    table = tmp_path / "fleet_calibration.json"
    spec = SystemSpec().replace(**{
        "mode": "live", "workload.arch": arch, "workload.events": 8,
        "workload.rate_hz": 100.0, "workload.tenants": 2, "workload.prompt_tokens": 6,
        "workload.max_new_tokens": 4, "fleet.replicas": 2, "router.policy": "least_cost",
        "cost_model.fleet_calibration_path": str(table)})
    runs = []
    for i in range(2):
        if i == 1:
            warm = tbuild.build_fleet_calibration(spec.cost_model)
            assert any(warm.for_replica(r).table for r in range(2))
        n = len(seen)
        report = tbuild.LiveRun(spec, device="cpu").run()
        assert tcli._check_live_report(report, spec) == []
        assert report.metrics["engine"] == "torch" and report.metrics["arch"] == arch
        assert table.exists()
        runs.append(dict(seen[n:]))
    assert runs[0] == runs[1] and len(runs[0]) == 8
    vocab = 1024
    assert all(len(t) == 4 and all(0 <= x < vocab for x in t) for t in runs[0].values())
    assert RunReport.from_dict(report.to_dict()).to_json() == report.to_json()


def test_with_no_card_a_real_architecture_and_calibrate_raise(monkeypatch):
    """No fallback to the CPU: without a card, the entry points that run
    kernels raise unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    live = SystemSpec().replace(**{"mode": "live", "workload.arch": "stablelm-1.6b",
                                   "workload.events": 2})
    with pytest.raises(RuntimeError, match="CUDA card"):
        tbuild.LiveRun(live).run()
    sim = SystemSpec().replace(**{"workload.events": 4})
    with pytest.raises(RuntimeError, match="CUDA card"):
        tcli.calibrate(sim)
    # the model-free live engines need no card
    fake = live.replace(**{"workload.arch": "fake"})
    assert tbuild.LiveRun(fake).run().metrics["engine"] == "fake"


# -------------------------------------------------------------- calibrate
def test_calibrate_on_the_cpu_feeds_a_calibrated_sim(tmp_path, capsys):
    """``calibrate``'s body on the CPU (the dispatches run K1's plain
    version): a table of measured (bucket, R) keys that the port's and the
    reference's calibrated cost models load, and that a calibrated sim
    replays."""
    spec = SystemSpec.load(spec_path("paper_mix"), dict(H100_SETS, **{"workload.events": 40}))
    ops.reset_counters()
    model, submitted = tcli.calibrate(spec, device="cpu")
    assert submitted == 40 and len(model.table) > 0
    assert ops.COUNTERS["batched_gemm"].plain_calls > 0
    assert all(c.launches == 0 for c in ops.COUNTERS.values())
    out = str(tmp_path / "costs.json")
    model.save(out)
    assert CalibratedCostModel.load(out).table == model.table
    assert len(JCalibrated.load(out).table) == len(model.table)
    rc, text, _ = run_cli(tcli.main, [
        "simulate", "--spec", spec_path("paper_mix"), "--events", "300", "--check",
        "--set", "cost_model.hardware=h100", "--set", "cost_model.kind=calibrated",
        "--set", f"cost_model.calibration_path={out}"], capsys)
    assert rc == 0 and "byte-identical: True" in text


def test_calibrate_refuses_a_mix_without_kernels():
    spec = SystemSpec().replace(**{"workload.mix": "serving", "workload.events": 4})
    with pytest.raises(SystemExit, match="kernel mix"):
        tcli.calibrate(spec, device="cpu")


# --------------------------------------------------------- report surface
def test_report_and_sweep_subcommands_run_on_the_h100(tmp_path, capsys):
    """``simulate --out``, ``report`` and ``sweep --dry-run`` on a committed
    file with the hardware override; ``trace --check`` is byte-stable."""
    out = str(tmp_path / "report.json")
    sets = ["--set", "cost_model.hardware=h100"]
    path = spec_path("traced_fleet")
    rc, _, _ = run_cli(tcli.main, ["simulate", "--spec", path, "--events", "400",
                                   "--out", out] + sets, capsys)
    assert rc == 0
    rc, text, _ = run_cli(tcli.main, ["report", out, "--timeline"], capsys)
    assert rc == 0 and "timeline:" in text and "scheduler counters:" in text
    assert RunReport.load(out).spec["cost_model"]["hardware"] == "h100"
    rc, text, _ = run_cli(tcli.main, [
        "trace", "--spec", path, "--events", "400", "--out", str(tmp_path / "t.json"),
        "--check"] + sets, capsys)
    assert rc == 0 and "byte-identical: True" in text
    rc, text, _ = run_cli(tcli.main, [
        "sweep", "--spec", spec_path("paper_mix"), "--dry-run",
        "--axis", "cost_model.strategy=time_only,space_time"] + sets, capsys)
    assert rc == 0 and "2 cells" in text


def test_live_check_flags_broken_accounting():
    """The live ``--check`` invariants catch a report whose routed and
    rejected requests do not add up to the events offered."""
    spec = SystemSpec().replace(**{"mode": "live", "workload.arch": "fake",
                                   "workload.events": 10, "fleet.replicas": 2})
    report = tbuild.LiveRun(spec).run()
    assert tcli._check_live_report(report, spec) == []
    doc = report.to_dict()
    doc["metrics"]["routed_counts"] = [1, 1]
    problems = tcli._check_live_report(RunReport.from_dict(doc), spec)
    assert problems and "request accounting" in problems[0]
    assert np.isfinite(report.metrics["wall_s"])

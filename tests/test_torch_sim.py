"""The port's simulator and fleet simulator against a fresh run of the JAX
package's, byte for byte.

The committed specs under ``examples/specs/`` are read with the JAX
package's ``repro.api.spec``; the reference run is built by
``repro.api.build`` and the port's by the port's own ``repro_torch.api``
from the same spec JSON (``port_run`` below). Hardware enters the port
only as ``HardwareSpec(**asdict(reference_spec))``, under the reference's
names in the port's registry for the duration of a run, and the fleet's
speed-factor base is set to the reference's, so both price the same card.
Each run is capped at 3,000 events.
"""

import contextlib
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

from repro.api.spec import SystemSpec  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.obs.recorder import FlightRecorder as JRecorder  # noqa: E402
from repro.partition import PartitionPlan as JPlan, PartitionShare as JShare  # noqa: E402
from repro.sim import fleet as jfleet  # noqa: E402
from repro.sim import traces as jtraces  # noqa: E402
from repro.sim.costmodel import RooflineCostModel as JRoofline  # noqa: E402
from repro.sim.metrics import to_bench_json as j_bench_json  # noqa: E402

from repro_torch.api.spec import SystemSpec as TSystemSpec  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.partition import PartitionPlan, PartitionShare  # noqa: E402
from repro_torch.sim import costmodel as tcost  # noqa: E402
from repro_torch.sim import fleet as tfleet  # noqa: E402
from repro_torch.sim import traces as ttraces  # noqa: E402
from repro_torch.sim.metrics import to_bench_json  # noqa: E402
from repro_torch.sim.router import ROUTERS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SPECS = ("paper_mix", "hetero_fleet", "deadline_fleet", "traced_fleet", "replay_smoke")
MAX_EVENTS = 3000


# ------------------------------------------------------------ the port's run
def port_hw(hw) -> troof.HardwareSpec:
    """The reference's spec (a name or a record) as the port's record."""
    return troof.HardwareSpec(**dataclasses.asdict(jroof.resolve_spec(hw)))


@contextlib.contextmanager
def reference_cards():
    """The reference's cards in the port's registry under their own names,
    for the duration of the block."""
    saved = dict(troof.HARDWARE_SPECS)
    troof.HARDWARE_SPECS.update({name: port_hw(name) for name in ("v5e", "v5e_half")})
    try:
        yield
    finally:
        troof.HARDWARE_SPECS.clear()
        troof.HARDWARE_SPECS.update(saved)


def port_run(spec: SystemSpec):
    """What ``spec.build().run_metrics()`` computes, through the port's
    ``repro_torch.api`` from the same spec JSON: ``(metrics, the run's
    recorder or None)``."""
    with reference_cards():
        ex = TSystemSpec.from_dict(spec.to_dict()).build()
        return ex.run_metrics(), ex.last_recorder


def assert_same_text(first: str, *others: str) -> None:
    """Equal texts, or a failure that shows where they first differ (the
    texts run to megabytes, too long for pytest's own diff)."""
    for other in others:
        if other != first:
            i = next((k for k, (a, b) in enumerate(zip(first, other)) if a != b),
                     min(len(first), len(other)))
            raise AssertionError(f"texts differ at char {i} (lengths {len(first)}, {len(other)}): "
                                 f"{first[max(0, i - 80):i + 80]!r} != {other[max(0, i - 80):i + 80]!r}")


def load_spec(name: str, **dotted) -> SystemSpec:
    spec = SystemSpec.load(str(ROOT / "examples" / "specs" / f"{name}.json"))
    dotted.setdefault("workload.events", min(MAX_EVENTS, spec.workload.events))
    return spec.replace(**dotted)


def reference_run(spec: SystemSpec):
    """A fresh run of the JAX package: ``(metrics, recorder or None)``."""
    ex = spec.build()
    return ex.run_metrics(), ex.last_recorder


@pytest.fixture(autouse=True)
def reference_base(monkeypatch):
    """Replay-trace paths are relative to the repo root, and speed factors
    divide by the reference's base card, so both fleets weigh cards alike."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(tfleet, "BASE_SPEC", port_hw("v5e"))


def assert_same_decisions(jrec, trec):
    """Route choices and prices, admission flags and reason codes, and
    preemptions, per replica, in order."""
    assert list(trec._rt_chosen) == list(jrec._rt_chosen)
    assert list(trec._rt_price) == list(jrec._rt_price)
    assert sorted(trec.shards) == sorted(jrec.shards)
    for rid, js in jrec.shards.items():
        ts = trec.shards[rid]
        assert list(ts._arr_reason) == list(js._arr_reason)
        assert list(ts._arr_admitted) == list(js._arr_admitted)
        assert ts.n_dispatches == js.n_dispatches
        assert ts.n_preemptions == js.n_preemptions
    assert trec.scale_events == jrec.scale_events
    assert trec.partition_events == jrec.partition_events


def assert_parity(spec: SystemSpec):
    jm, _ = reference_run(spec)
    tm, _ = port_run(spec)
    assert_same_text(to_bench_json("parity", {"run": tm}), j_bench_json("parity", {"run": jm}))
    # the same run with recorders on: the decisions behind the bytes
    on = spec.replace(**{"observability.enabled": True})
    jm_on, jrec = reference_run(on)
    tm_on, trec = port_run(on)
    assert_same_text(tm_on.to_json(), jm_on.to_json(), jm.to_json())
    assert_same_decisions(jrec, trec)
    return jm, tm


# ------------------------------------------------------------------- specs
# deadline_fleet with a wide window and no deadline lead: items wait long
# enough for EDF preemption to fire
PREEMPTING = {"scheduler.batching_window_s": 0.02, "scheduler.deadline_lead_fraction": 0.0}
CASES = [(name, {}) for name in SPECS] + [("deadline_fleet", PREEMPTING)]


@pytest.mark.parametrize("name,overrides", CASES,
                         ids=list(SPECS) + ["deadline_fleet-preempting"])
def test_committed_spec_bytes_equal_the_reference(name, overrides):
    jm, tm = assert_parity(load_spec(name, **overrides))
    assert tm.to_dict()["summary"]["completed"] > 0
    if hasattr(jm, "scale_events"):
        assert tm.scale_events == jm.scale_events
        assert tm.routed_counts.tolist() == jm.routed_counts.tolist()
        assert tm.preemptions == jm.preemptions


def test_the_specs_exercise_what_they_claim():
    """The spec list reaches autoscaling, preemption and rejections, so the
    decision checks above compare something."""
    hetero, _ = reference_run(load_spec("hetero_fleet"))
    assert hetero.scale_ups > 0
    deadline, _ = reference_run(load_spec("deadline_fleet"))
    assert deadline.merged.rejected > 0
    preempting, _ = reference_run(load_spec("deadline_fleet", **PREEMPTING))
    assert preempting.preemptions > 0


@pytest.mark.parametrize("strategy", tcost.STRATEGIES)
def test_every_strategy_equals_the_reference(strategy):
    assert tcost.STRATEGIES == ("time_only", "space_only", "space_time", "exclusive")
    assert_parity(load_spec("paper_mix", **{"cost_model.strategy": strategy}))
    assert_parity(load_spec("deadline_fleet", **{"cost_model.strategy": strategy}))


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_every_router_equals_the_reference(router):
    assert sorted(ROUTERS) == ["affinity", "jsq", "least_cost", "round_robin"]
    assert_parity(load_spec("hetero_fleet", **{"router.policy": router}))


def test_explicit_two_slice_partition_equals_the_reference():
    """Two co-located slices of one card (no planner), tenants dealt by
    parity, one of them with its own batching window."""
    mix_j = jtraces.paper_sgemm_mix(6)
    mix_t = ttraces.paper_sgemm_mix(6)
    groups = [("p0", 0.625, (0, 2, 4), None), ("p1", 0.375, (1, 3, 5), 0.002)]
    jplan = JPlan(groups=tuple(JShare(n, s, t, w) for n, s, t, w in groups))
    tplan = PartitionPlan(groups=tuple(PartitionShare(n, s, t, w) for n, s, t, w in groups))
    assert tplan.to_json() == jplan.to_json()
    hw = jroof.resolve_spec("v5e")
    rate = 1.1 * 2 * jfleet.estimate_capacity_hz(mix_j, JRoofline(spec=hw))
    jrec, trec = JRecorder(), FlightRecorder()
    jm = jfleet.FleetSimulator(
        replicas=2, router="jsq", partition=jplan, partition_hardware=hw, recorder=jrec,
    ).run(jtraces.make_trace("mmpp", mix_j, rate, MAX_EVENTS, seed=11))
    tm = tfleet.FleetSimulator(
        replicas=2, router="jsq", partition=tplan, partition_hardware=port_hw(hw),
        recorder=trec,
    ).run(ttraces.make_trace("mmpp", mix_t, rate, MAX_EVENTS, seed=11))
    assert_same_text(to_bench_json("partition", {"run": tm}),
                     j_bench_json("partition", {"run": jm}))
    assert tm.replica_specs == jm.replica_specs == ["tpu_v5e@p0:0.625", "tpu_v5e@p1:0.375"] * 2
    assert_same_decisions(jrec, trec)


def test_speed_factors_and_partition_hardware_follow_the_base_spec(monkeypatch):
    """Replicas' speed factors divide by the module's base spec (the
    reference's under the fixture, the H100 by default), and a partitioned
    fleet given no hardware carves the base spec."""
    j = jfleet.FleetSimulator(replicas=2, specs=["v5e", "v5e_half"])
    t = tfleet.FleetSimulator(replicas=2, specs=[port_hw("v5e"), port_hw("v5e_half")])
    assert [p.speed_factor for p in t.pumps] == [p.speed_factor for p in j.pumps] == [1.0, 0.5]
    monkeypatch.setattr(tfleet, "BASE_SPEC", troof.H100)
    t = tfleet.FleetSimulator(replicas=1, specs=["h100_half", "h100"])
    assert [p.speed_factor for p in t.pumps] == [0.5]
    plan = PartitionPlan(groups=(PartitionShare("a", 0.5, (0,)),))
    assert tfleet.FleetSimulator(replicas=1, partition=plan).partition_hardware is troof.H100


# ------------------------------------------------------------- workers = 2
SHARDED = {"workload.events": MAX_EVENTS, "workload.seed": 13, "workload.mix": "fleet",
           "workload.tenants": 12, "fleet.replicas": 4, "fleet.workers": 2,
           "router.policy": "round_robin", "cost_model.compile_us": 100.0,
           "observability.enabled": True}

_SHARDED_CHILD = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_sim as T
from repro_torch.obs.trace_export import export_chrome_trace
from repro_torch.sim.metrics import to_bench_json
T.tfleet.BASE_SPEC = T.port_hw("v5e")
m, rec = T.port_run(T.SystemSpec().replace(**T.SHARDED))
sys.stdout.write(to_bench_json("sharded", {{"run": m}}) + "\\n=====\\n" + export_chrome_trace(rec))
"""


def run_with_timeout(code: str, timeout_s: float) -> str:
    """Run ``code`` in a fresh interpreter in its own process group, and
    kill the whole group (forked shard workers too) if it outlives
    ``timeout_s``: a hung worker fails the test instead of holding the
    suite."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the sharded run did not finish within {timeout_s} s")
    assert proc.returncode == 0, err
    return out


def test_two_workers_equal_one_worker_and_the_reference():
    """``workers=2`` forks shard workers from a process that has torch
    imported; it runs in a child under a 120 s timeout of its own."""
    from repro.obs.trace_export import export_chrome_trace as j_export

    from repro_torch.obs.trace_export import export_chrome_trace

    out = run_with_timeout(_SHARDED_CHILD.format(tests=str(ROOT / "tests")), 120.0)
    sharded_json, sharded_trace = out.split("\n=====\n")
    solo = SystemSpec().replace(**dict(SHARDED, **{"fleet.workers": 1}))
    tm, rec = port_run(solo)
    jm, jrec = reference_run(solo)
    assert_same_text(sharded_json, to_bench_json("sharded", {"run": tm}),
                     j_bench_json("sharded", {"run": jm}))
    assert_same_text(sharded_trace, export_chrome_trace(rec), j_export(jrec))


# ------------------------------------------------------------ HardwareSpec
def test_the_registry_names_only_h100_parts():
    assert sorted(troof.HARDWARE_SPECS) == ["h100", "h100_half", "h100_quarter"]
    assert troof.HardwareSpec().name == "h100"
    assert troof.resolve_spec("h100") is troof.H100 == troof.HardwareSpec()
    assert tcost.RooflineCostModel().spec == troof.H100
    assert tfleet.H100 is troof.H100
    assert [f.name for f in dataclasses.fields(troof.HardwareSpec)] == \
        [f.name for f in dataclasses.fields(jroof.HardwareSpec)]
    for name, factor in (("h100_half", 0.5), ("h100_quarter", 0.25)):
        spec = troof.HARDWARE_SPECS[name]
        assert spec == troof.H100.scaled(factor, name=name)
    with pytest.raises(ValueError, match="h100_half"):
        troof.resolve_spec("v5e")


@pytest.mark.parametrize("name", sorted(jroof.HARDWARE_SPECS))
@pytest.mark.parametrize("op,arg", [("scaled", 0.5), ("scaled", 3.0), ("sliced", 0.25),
                                    ("sliced", 1.0)])
def test_scaled_and_sliced_behave_as_the_reference(name, op, arg):
    want = getattr(jroof.resolve_spec(name), op)(arg)
    got = getattr(port_hw(name), op)(arg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.pipe_fill_s() == want.pipe_fill_s()
    assert got.t_compute(1e12) == want.t_compute(1e12)
    assert got.t_memory(1e9) == want.t_memory(1e9)
    assert got.t_collective(1e9) == want.t_collective(1e9)


@pytest.mark.parametrize("op,arg", [("scaled", 0.0), ("sliced", 0.0), ("sliced", 1.5)])
def test_bad_factors_raise_as_the_reference(op, arg):
    with pytest.raises(ValueError):
        getattr(jroof.HardwareSpec(), op)(arg)
    with pytest.raises(ValueError):
        getattr(troof.HardwareSpec(), op)(arg)

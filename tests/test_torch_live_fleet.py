"""The port's live fleet (``repro_torch.serving.fleet``) against the
simulator and against the JAX package's live fleet.

One pump/router core serves both executors, so a ``LiveFleet`` on virtual
clocks with the no-result ``NullEngine`` is a byte-exact twin of the
port's ``FleetSimulator`` and of the reference's ``LiveFleet``: same
routing decisions, same admission reason codes, same metrics bytes.
``FakeEngine`` tokens equal the reference's, and a fleet of two real
engines (stablelm-1.6b smoke variant, float32, weights carried across by
``models.convert``) gives the JAX fleet's greedy tokens exactly, the f32
rule of ``test_torch_serving.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")

from test_torch_sim import assert_same_text  # noqa: E402

from repro.config import ScheduleConfig as JSchedule  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.core.clock import VirtualClock as JVirtualClock  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.obs.recorder import FlightRecorder as JRecorder  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceRequest as JRequest  # noqa: E402
from repro.serving import MultiTenantEngine as JEngine  # noqa: E402
from repro.serving import fleet as jlive  # noqa: E402
from repro.sim import costmodel as jcost  # noqa: E402
from repro.sim import traces as jtraces  # noqa: E402

from repro_torch.config import ScheduleConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.core.clock import VirtualClock  # noqa: E402
from repro_torch.core.pump import drain_fleet_tail  # noqa: E402
from repro_torch.launch.roofline import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine  # noqa: E402
from repro_torch.serving.fleet import (  # noqa: E402
    EngineReplica,
    FakeEngine,
    LiveFleet,
    LiveWorkload,
    NullEngine,
)
from repro_torch.sim import costmodel as tcost  # noqa: E402
from repro_torch.sim import fleet as tfleet  # noqa: E402
from repro_torch.sim import traces as ttraces  # noqa: E402
from repro_torch.sim.fleet import _arrival_stream  # noqa: E402

SCHED = dict(batching_window_s=0.0005, max_superkernel_size=32)
FEASIBLE = dict(SCHED, admission_policy="feasibility", oversubscription=1.25)
V5E = HardwareSpec(**dataclasses.asdict(jcost.resolve_spec("v5e")))
J_BASE = jcost.RooflineCostModel(strategy="space_time")
T_BASE = tcost.RooflineCostModel(spec=V5E, strategy="space_time")
OFFERED_HZ = 0.85 * 3 * jcost.estimate_capacity_hz(jtraces.fleet_sgemm_mix(12), J_BASE)


@pytest.fixture(autouse=True)
def reference_base(monkeypatch):
    monkeypatch.setattr(tfleet, "BASE_SPEC", V5E)


def traces(events=2000, seed=0, rate=OFFERED_HZ, process="mmpp"):
    """The same seeded trace from each package's generators."""
    return (jtraces.make_trace(process, jtraces.fleet_sgemm_mix(12), rate, events, seed=seed),
            ttraces.make_trace(process, ttraces.fleet_sgemm_mix(12), rate, events, seed=seed))


def fleets(router, engine=(jlive.NullEngine, NullEngine), schedule=SCHED, recorders=(None, None),
           **kw):
    """(reference LiveFleet, port LiveFleet) on virtual clocks."""
    j = jlive.LiveFleet(replicas=3, engine_factory=engine[0], router=router,
                        schedule=JSchedule(**schedule), cost_model=J_BASE, compile_s=1e-3,
                        recorder=recorders[0], clock_factory=JVirtualClock, **kw)
    t = LiveFleet(replicas=3, engine_factory=engine[1], router=router,
                  schedule=ScheduleConfig(**schedule), cost_model=T_BASE, compile_s=1e-3,
                  recorder=recorders[1], clock_factory=VirtualClock, **kw)
    return j, t


def port_sim(router, schedule=SCHED, recorder=None, **kw):
    return tfleet.FleetSimulator(replicas=3, router=router, schedule=ScheduleConfig(**schedule),
                                 cost_model=T_BASE, compile_s=1e-3, recorder=recorder, **kw)


# -------------------------------------------------------------- sim <-> live
@pytest.mark.parametrize("router", ["round_robin", "jsq", "least_cost", "affinity"])
def test_null_engine_fleet_bytes_equal_the_simulator_and_the_reference(router):
    jt, tt = traces()
    j, t = fleets(router)
    m_ref = j.run(jt)
    m_live = t.run(tt)
    m_sim = port_sim(router).run(tt)
    assert_same_text(m_live.to_json(), m_sim.to_json(), m_ref.to_json())
    assert t.routed_counts == j.routed_counts


@pytest.mark.parametrize("schedule", [SCHED, FEASIBLE], ids=["cap", "feasibility"])
def test_route_choices_and_admission_codes_equal_the_reference(schedule):
    """Under 3x pressure feasibility admission mixes admit, oversubscribed
    and infeasible codes; the sequences match per replica, in order."""
    jt, tt = traces(seed=1, rate=3 * OFFERED_HZ)
    jrec, trec, srec = JRecorder(), FlightRecorder(), FlightRecorder()
    j, t = fleets("least_cost", schedule=schedule, recorders=(jrec, trec))
    j.run(jt)
    t.run(tt)
    port_sim("least_cost", schedule=schedule, recorder=srec).run(tt)
    assert trec.n_routes == jrec.n_routes == 2000
    for rec in (trec, srec):
        assert list(rec._rt_chosen) == list(jrec._rt_chosen)
        assert list(rec._rt_price) == list(jrec._rt_price)
        for rid in range(3):
            assert list(rec.shards[rid]._arr_reason) == list(jrec.shards[rid]._arr_reason)
            assert list(rec.shards[rid]._arr_admitted) == list(jrec.shards[rid]._arr_admitted)
    reasons = {r for rid in range(3) for r in jrec.shards[rid]._arr_reason}
    if schedule is FEASIBLE:
        assert len(reasons) > 1


def test_calibrated_fleet_equals_the_reference():
    """A FleetCalibrator under the live fleet: same fitted tables, and
    routing through them makes the same choices."""
    jt, tt = traces(events=1500, seed=4)
    jcal = jcost.FleetCalibrator(prior=J_BASE)
    tcal = tcost.FleetCalibrator(prior=T_BASE)
    j = jlive.LiveFleet(replicas=2, engine_factory=jlive.NullEngine, router="least_cost",
                        schedule=JSchedule(**SCHED), cost_model=J_BASE, compile_s=1e-3,
                        calibration=jcal, clock_factory=JVirtualClock)
    t = LiveFleet(replicas=2, engine_factory=NullEngine, router="least_cost",
                  schedule=ScheduleConfig(**SCHED), cost_model=T_BASE, compile_s=1e-3,
                  calibration=tcal, clock_factory=VirtualClock)
    assert_same_text(t.run(tt).to_json(), j.run(jt).to_json())
    assert_same_text(tcal.to_json(), jcal.to_json())
    assert tcal.observations > 0


# ------------------------------------------------------------- fake engine
def submit_all(fleet, trace, payload_fn):
    """Every arrival through ``submit_one``; returns the workloads."""
    ws = []
    for t_s, spec, cost in _arrival_stream(trace):
        w, _, _, _ = fleet.submit_one(spec, cost, payload=payload_fn(spec), t_s=t_s)
        ws.append(w)
    drain_fleet_tail(fleet.pumps, fleet._drain_until)
    return ws


def test_fake_engine_responses_equal_the_reference():
    jt, tt = traces(events=300, seed=2)
    rng_j, rng_t = np.random.RandomState(5), np.random.RandomState(5)
    j, t = fleets("least_cost", engine=(jlive.FakeEngine, FakeEngine))
    jw = submit_all(j, jt, lambda s: rng_j.randint(1, 32000, size=4).tolist())
    tw = submit_all(t, tt, lambda s: rng_t.randint(1, 32000, size=4).tolist())
    assert [w.result for w in tw] == [w.result for w in jw]
    assert all(len(w.result) == 8 and all(0 <= x < 32000 for x in w.result) for w in tw)
    assert [w.completion_time for w in tw] == [w.completion_time for w in jw]


def test_fake_engine_tokens_are_a_function_of_tenant_and_payload():
    class W:
        tenant_id, payload = 5, [7, 8, 9]

    got = FakeEngine(0).execute([W])
    assert got == FakeEngine(1).execute([W]) == jlive.FakeEngine(0).execute([W])
    assert FakeEngine(0, max_new_tokens=3, vocab=50).execute([W]) == \
        jlive.FakeEngine(0, max_new_tokens=3, vocab=50).execute([W])


def test_wall_clock_fake_fleet_completes_every_arrival():
    _, tt = traces(events=300, seed=2)
    fleet = LiveFleet(replicas=2, engine_factory=FakeEngine, schedule=ScheduleConfig(**SCHED),
                      cost_model=T_BASE)
    m = fleet.run(tt, payload_fn=lambda s: [s.tenant_id])
    assert m.merged.completed == 300 and sum(fleet.routed_counts) == 300
    assert m.router == "least_cost"


def test_live_workload_matches_the_reference_fields():
    assert LiveWorkload.__slots__ == jlive.LiveWorkload.__slots__
    assert EngineReplica.name == "torch" and NullEngine.name == "null"


# ------------------------------------------------------------ real engines
R, SLOTS, CACHE_LEN, PROMPT_LEN, NEW, REQUESTS = 3, 2, 32, 6, 4, 12


@pytest.fixture(scope="module")
def stablelm():
    jcfg = jsmoke(jget_config("stablelm-1.6b"))
    cfg = smoke_variant(get_config("stablelm-1.6b"))
    jm = jbuild_model(jcfg)
    key = jax.random.PRNGKey(0)
    jparams = [jm.init(jax.random.fold_in(key, t)) for t in range(R)]
    tparams = [params_from_jax_numpy(cfg, jax.tree.map(np.asarray, p), device="cpu")
               for p in jparams]
    return cfg, jm, jparams, build_model(cfg, device="cpu"), tparams


def real_fleets(stablelm, mode="space_time"):
    cfg, jm, jparams, tm, tparams = stablelm
    mix = [dict(tenant_id=t, name=f"t{t}/request", bucket=("request", PROMPT_LEN),
                cost=float(PROMPT_LEN), flops=2.0 * 1.6e9 * (PROMPT_LEN + NEW), bytes=3.3e9,
                slo_s=0.5, kind="request") for t in range(R)]
    jmix = [jtraces.TenantSpec(**m) for m in mix]
    tmix = [ttraces.TenantSpec(**m) for m in mix]
    sched = dict(batching_window_s=0.002, max_superkernel_size=R * SLOTS)

    def jfactory(i):
        return jlive.EngineReplica(JEngine(jm, jparams, JEngineConfig(
            num_tenants=R, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode, seed=i)),
            replica_id=i, max_new_tokens=NEW)

    def tfactory(i):
        return EngineReplica(MultiTenantEngine(tm, tparams, EngineConfig(
            num_tenants=R, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode, seed=i)),
            replica_id=i, max_new_tokens=NEW)

    jrec, trec = JRecorder(), FlightRecorder()
    j = jlive.LiveFleet(replicas=2, engine_factory=jfactory, router="least_cost",
                        schedule=JSchedule(**sched), cost_model=jcost.RooflineCostModel(),
                        recorder=jrec, clock_factory=JVirtualClock)
    t = LiveFleet(replicas=2, engine_factory=tfactory, router="least_cost",
                  schedule=ScheduleConfig(**sched), cost_model=tcost.RooflineCostModel(spec=V5E),
                  recorder=trec, clock_factory=VirtualClock)
    trace_j = jtraces.PoissonTrace(jmix, 400.0, REQUESTS, seed=3)
    trace_t = ttraces.PoissonTrace(tmix, 400.0, REQUESTS, seed=3)
    return (j, trace_j, jrec), (t, trace_t, trec), cfg.vocab_size


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
def test_real_engine_fleet_tokens_equal_the_jax_fleet(stablelm, mode):
    (j, jt, jrec), (t, tt, trec), vocab = real_fleets(stablelm, mode)
    rng_j, rng_t = np.random.RandomState(9), np.random.RandomState(9)
    jw = submit_all(j, jt, lambda s: rng_j.randint(1, vocab, size=PROMPT_LEN).tolist())
    with torch.no_grad():
        tw = submit_all(t, tt, lambda s: rng_t.randint(1, vocab, size=PROMPT_LEN).tolist())
    assert len(tw) == REQUESTS
    assert [w.result for w in tw] == [w.result for w in jw]
    assert all(len(w.result) == NEW and all(0 <= x < vocab for x in w.result) for w in tw)
    assert list(trec._rt_chosen) == list(jrec._rt_chosen)
    assert t.routed_counts == j.routed_counts
    # both replicas served, and every generated token came off the engines
    assert all(p.scheduler.stats.dispatches > 0 for p in t.pumps)
    assert sum(len(e.engine.finished) for e in t.engines) == REQUESTS


# ------------------------------------------------------------ engine hook
def test_engine_submit_records_one_arrival_as_the_reference(stablelm):
    cfg, jm, jparams, tm, tparams = stablelm
    jeng = JEngine(jm, jparams, JEngineConfig(num_tenants=R, slots_per_tenant=SLOTS,
                                              cache_len=CACHE_LEN))
    teng = MultiTenantEngine(tm, tparams, EngineConfig(num_tenants=R, slots_per_tenant=SLOTS,
                                                       cache_len=CACHE_LEN))
    assert teng.recorder is None
    jrec, trec = JRecorder(), FlightRecorder()
    jeng.recorder, teng.recorder = jrec.shard(0), trec.shard(0)
    prompt = [5, 6, 7, 8, 9]
    jeng.submit(JRequest(tenant_id=2, prompt=prompt, max_new_tokens=2), now=1.25)
    teng.submit(InferenceRequest(tenant_id=2, prompt=prompt, max_new_tokens=2), now=1.25)
    shard = trec.shards[0]
    assert shard.n_arrivals == 1
    assert shard._bucket_labels == ["request/5"]
    assert list(shard._arr_tenant) == [2] and list(shard._arr_admitted) == [1]
    assert shard.payload() == jrec.shards[0].payload()

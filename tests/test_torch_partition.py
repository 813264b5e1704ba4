"""The port's knee curves and partition planner against the JAX package's.

``repro_torch.partition.{knee,planner}`` mirror the reference line for
line; both are pure functions of (mix, hardware, config, table), so the
port must give the same curves, knees and plans, byte for byte in the
plan JSON. Hardware enters the port as the reference's record
(``port_hw``); the mixes are the reference's own planner tests' and the
committed ``partitioned_fleet`` spec's.
"""

import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

from test_torch_sim import port_hw  # noqa: E402

from repro.api.build import build_partition as j_build_partition  # noqa: E402
from repro.api.spec import SystemSpec as JSpec  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.partition import knee as jknee  # noqa: E402
from repro.partition import planner as jplanner  # noqa: E402
from repro.sim import costmodel as jcost  # noqa: E402
from repro.sim import traces as jtraces  # noqa: E402

from repro_torch.api.build import build_partition  # noqa: E402
from repro_torch.api.spec import SystemSpec  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.partition import knee, planner  # noqa: E402
from repro_torch.partition import (  # noqa: E402
    DEFAULT_SHARE_GRID,
    PlannerConfig,
    knee_share,
    plan_partitions,
    share_pricer,
    throughput_curve,
)
from repro_torch.sim import costmodel as tcost  # noqa: E402
from repro_torch.sim import traces as ttraces  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
V5E = jroof.resolve_spec("v5e")


def mixes(name):
    """(reference mix, port mix) of one of the planner's mixes."""
    return {
        "sgemm6": (jtraces.paper_sgemm_mix(6), ttraces.paper_sgemm_mix(6)),
        "sgemm8": (jtraces.paper_sgemm_mix(8), ttraces.paper_sgemm_mix(8)),
        "fleet12": (jtraces.fleet_sgemm_mix(12), ttraces.fleet_sgemm_mix(12)),
        "serving6": (jtraces.prefill_decode_mix(6), ttraces.prefill_decode_mix(6)),
    }[name]


MIXES = ("sgemm6", "sgemm8", "fleet12", "serving6")
PLANNED = ("sgemm6", "sgemm8", "fleet12")  # a serving tenant spans two buckets: no plan


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("r", [1, 4, 32])
def test_throughput_curves_and_knees_equal_the_reference(name, r):
    jmix, tmix = mixes(name)
    jprice, tprice = jknee.share_pricer(V5E), share_pricer(port_hw(V5E))
    for jw, tw in zip(jmix, tmix):
        jc = jknee.throughput_curve(jw, r, jprice)
        tc = throughput_curve(tw, r, tprice)
        assert tc == jc
        for frac in (0.5, 0.9, 1.0):
            for floor in (0.0, 0.25):
                assert knee_share(tc, frac, floor) == jknee.knee_share(jc, frac, floor)
        assert knee.pareto_shares(tc, (0.5, 0.8, 0.95)) == \
            jknee.pareto_shares(jc, (0.5, 0.8, 0.95))
        assert knee.knee_for(tw, r, tprice) == jknee.knee_for(jw, r, jprice)


def test_calibrated_pricer_equals_the_reference():
    """A measured table, written by the reference and read by the port,
    prices every share as the reference's does."""
    jmix, tmix = mixes("sgemm6")
    jtable = jcost.CalibratedCostModel(prior=jcost.RooflineCostModel(spec=V5E))
    for i, w in enumerate(jmix):
        for n in (1, 2, 4):
            jtable.observe([w] * n, 1e-4 * (i + 1) * n ** 0.5)
    ttable = tcost.CalibratedCostModel.from_json(
        jtable.to_json(), prior=tcost.RooflineCostModel(spec=port_hw(V5E)))
    jprice = jknee.share_pricer(V5E, calibrated=jtable)
    tprice = share_pricer(port_hw(V5E), calibrated=ttable)
    for jw, tw in zip(jmix, tmix):
        for s in DEFAULT_SHARE_GRID:
            for n in (1, 3, 4):
                assert tprice([tw] * n, s) == jprice([jw] * n, s)


PLANNER_CASES = {
    "default": {},
    "squeeze": dict(min_share=0.5, share_grid=(0.5, 0.75, 1.0)),
    "tight-knee": dict(knee_fraction=0.99, slack_fraction=0.25, merge_size=8),
    "time_only": dict(strategy="time_only", base_window_s=0.001),
}


@pytest.mark.parametrize("name", PLANNED)
@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_plans_equal_the_reference(name, case):
    """The reference planner tests' mixes and configurations (the default,
    the oversubscribed squeeze), plus a tight knee and time_only pricing:
    the plan JSON byte for byte, and the observed-R re-plan."""
    jmix, tmix = mixes(name)
    kw = PLANNER_CASES[case]
    jplan = jplanner.plan_partitions(jmix, V5E, jplanner.PlannerConfig(**kw))
    tplan = plan_partitions(tmix, port_hw(V5E), PlannerConfig(**kw))
    assert tplan.to_json() == jplan.to_json()
    assert tplan.total_share <= 1.0 + 1e-9
    observed = {g.name: 1 + i for i, g in enumerate(jplan.groups)}
    assert plan_partitions(tmix, port_hw(V5E), PlannerConfig(**kw),
                           r_override=observed).to_json() == \
        jplanner.plan_partitions(jmix, V5E, jplanner.PlannerConfig(**kw),
                                 r_override=observed).to_json()


@pytest.mark.parametrize("name", MIXES)
def test_groups_and_representative_r_equal_the_reference(name):
    jmix, tmix = mixes(name)
    jg, tg = jplanner.group_tenants(jmix), planner.group_tenants(tmix)
    assert [n for n, _ in tg] == [n for n, _ in jg]
    assert [[s.tenant_id for s in m] for _, m in tg] == [[s.tenant_id for s in m] for _, m in jg]
    total = sum(s.weight for s in jmix)
    for (_, jm), (_, tm) in zip(jg, tg):
        for merge in (1, 8, 32, 64):
            assert planner.representative_r(tm, total, merge) == \
                jplanner.representative_r(jm, total, merge)


@pytest.mark.parametrize("kw", [dict(share_grid=()), dict(share_grid=(0.5, 0.25)),
                                dict(share_grid=(0.0, 1.0)), dict(knee_fraction=0.0),
                                dict(min_share=1.5), dict(base_window_s=-1.0),
                                dict(slack_fraction=2.0), dict(merge_size=0)], ids=str)
def test_planner_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError) as jerr:
        jplanner.PlannerConfig(**kw)
    with pytest.raises(ValueError) as terr:
        PlannerConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def _hw_as_reference(monkeypatch):
    """The reference's cards under their names in the port's registry."""
    for name in ("v5e", "v5e_half"):
        monkeypatch.setitem(troof.HARDWARE_SPECS, name, port_hw(name))


@pytest.mark.parametrize("overrides", [
    {},
    {"scheduler.max_superkernel_size": 8},
    {"partition.knee_fraction": 0.99, "partition.min_share": 0.125},
    {"partition.policy": "explicit", "partition.shares": [0.5, 0.25, 0.25]},
], ids=str)
def test_the_partitioned_fleet_plan_equals_the_reference(overrides, monkeypatch):
    """``build_partition`` on the committed ``partitioned_fleet`` spec (its
    knee plan, and variants): the resolved plan, and the replanner's plan
    for an observed R."""
    _hw_as_reference(monkeypatch)
    path = str(ROOT / "examples" / "specs" / "partitioned_fleet.json")
    jspec = JSpec.load(path).replace(**overrides)
    tspec = SystemSpec.load(path, overrides)
    assert tspec.to_dict() == jspec.to_dict()
    from repro.api.build import build_mix as j_build_mix

    from repro_torch.api.build import build_mix

    jplan, jre = j_build_partition(jspec, j_build_mix(jspec.workload))
    tplan, tre = build_partition(tspec, build_mix(tspec.workload))
    assert tplan.to_json() == jplan.to_json()
    assert (tre is None) == (jre is None)
    if jre is not None:
        observed = {g.name: 2 for g in jplan.groups}
        assert tre(observed).to_json() == jre(observed).to_json()


def test_the_h100_plan_of_the_partitioned_fleet():
    """Run on the port's own card (the hardware override), the knee plan
    still gives one slice per SGEMM shape, shares within one card."""
    path = str(ROOT / "examples" / "specs" / "partitioned_fleet.json")
    spec = SystemSpec.load(path, {"cost_model.hardware": "h100"})
    from repro_torch.api.build import build_mix

    plan, replanner = build_partition(spec, build_mix(spec.workload))
    assert [g.name for g in plan.groups] == ["rnn_matvec", "resnet18_conv2_2", "square_256"]
    assert plan.total_share <= 1.0 + 1e-9 and replanner is not None
    assert sorted(t for g in plan.groups for t in g.tenants) == list(range(6))
    assert dataclasses.asdict(troof.resolve_spec(spec.cost_model.hardware)) == \
        dataclasses.asdict(troof.H100)

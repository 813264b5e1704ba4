"""The port's scheduler against the JAX package's, decision for decision.

One seeded stream of ``Workload`` arrivals with no-op executors, on a
``VirtualClock`` priced by one cost function, goes through both packages'
``DynamicSpaceTimeScheduler``. Under every batching policy (fixed,
slo_adaptive, EDF with feasibility admission and preemption) both must
admit, batch and dispatch identically: the same dispatch sequence, the
same ``SchedulerStats`` and the same ``monitor.summary()``, exactly.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.config as jconfig  # noqa: E402
import repro.core.clock as jclock  # noqa: E402
import repro.core.queue as jqueue  # noqa: E402
import repro.core.scheduler as jsched  # noqa: E402
import repro.core.workload as jworkload  # noqa: E402

import repro_torch.config as tconfig  # noqa: E402
import repro_torch.core.clock as tclock  # noqa: E402
import repro_torch.core.queue as tqueue  # noqa: E402
import repro_torch.core.scheduler as tsched  # noqa: E402
import repro_torch.core.workload as tworkload  # noqa: E402

SCHEDULES = {
    "fixed": dict(batching_window_s=0.002, max_superkernel_size=6),
    "slo_adaptive": dict(batching_policy="slo_adaptive", batching_window_s=0.003,
                         min_batching_window_s=0.0002, max_superkernel_size=8),
    "edf_feasibility_preempt": dict(
        batching_policy="edf", batching_window_s=0.004, deadline_lead_fraction=0.05,
        admission_policy="feasibility", oversubscription=1.2, preemption=True,
        preemption_budget_s=0.01,
        max_superkernel_size=8),
    "cap": dict(batching_window_s=0.001, max_pending_per_tenant=3, max_superkernel_size=4),
}


def cost_model(batch):
    """Seconds a merged dispatch takes: fixed launch cost + per item."""
    return 2e-4 + 5e-5 * sum(float(w.cost) for w in batch)


def _stream(seed, n=400):
    rng = np.random.RandomState(seed)
    t = np.cumsum(rng.exponential(2.5e-4, size=n))
    tenants = rng.randint(0, 5, size=n)
    buckets = rng.randint(0, 3, size=n)
    costs = rng.randint(1, 4, size=n)
    slos = rng.choice([0.003, 0.008, 0.02], size=n)
    return list(zip(t.tolist(), tenants.tolist(), buckets.tolist(), costs.tolist(), slos.tolist()))


def _run(pkg, schedule_kwargs, stream):
    config, clock_mod, sched_mod, workload_mod = pkg
    clock = clock_mod.VirtualClock()
    sched = sched_mod.DynamicSpaceTimeScheduler(
        config.ScheduleConfig(**schedule_kwargs), clock=clock, cost_model=cost_model)
    dispatches = []

    def execute(batch):
        dispatches.append((clock.now(), [w.payload for w in batch]))
        return None

    admitted = []
    i = 0
    tick = 1e-4
    now = 0.0
    while i < len(stream) or len(sched.queue):
        now += tick
        clock.advance_to(now)
        while i < len(stream) and stream[i][0] <= clock.now():
            t, tenant, bucket, cost, slo = stream[i]
            ok = sched.submit(workload_mod.Workload(
                tenant_id=tenant, bucket=("b", bucket), cost=float(cost), slo_s=slo,
                execute=execute, payload=i, kind=f"k{bucket}"))
            admitted.append((ok, sched.admit_reason))
            i += 1
        sched.pump()
        if now > stream[-1][0] + 1.0:
            sched.flush()
    return dispatches, admitted, dataclasses.asdict(sched.stats), sched.monitor.summary(), \
        sched.monitor.summary_for("k0"), sched.report()


JAX_PKG = (jconfig, jclock, jsched, jworkload)
PORT_PKG = (tconfig, tclock, tsched, tworkload)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_identical_decisions(name):
    stream = _stream(seed=sorted(SCHEDULES).index(name))
    want = _run(JAX_PKG, SCHEDULES[name], stream)
    got = _run(PORT_PKG, SCHEDULES[name], stream)
    w_disp, w_adm, w_stats, w_sum, w_k0, w_rep = want
    g_disp, g_adm, g_stats, g_sum, g_k0, g_rep = got
    assert len(g_disp) > 10
    assert g_disp == w_disp
    assert g_adm == w_adm
    assert g_stats == w_stats
    assert g_sum == w_sum and g_k0 == w_k0
    assert g_rep == w_rep


def test_policies_really_differ():
    """The parity above is not vacuous: the policies make different
    decisions on the same stream, and EDF's admission/preemption fire."""
    stream = _stream(seed=0)
    runs = {name: _run(PORT_PKG, kw, stream) for name, kw in SCHEDULES.items()}
    sizes = {name: [len(b) for _, b in r[0]] for name, r in runs.items()}
    assert len({tuple(s) for s in sizes.values()}) == len(SCHEDULES)
    edf_stats = runs["edf_feasibility_preempt"][2]
    assert edf_stats["preemptions"] > 0
    assert edf_stats["oversubscribed"] + edf_stats["deadline_rejected"] > 0
    assert runs["cap"][2]["rejected"] > 0


def test_bare_gemm_items_dispatch_through_the_superkernel_cache():
    sched = tsched.DynamicSpaceTimeScheduler(tconfig.ScheduleConfig(batching_window_s=0.0))
    rng = np.random.RandomState(0)
    problems = [tqueue.GemmProblem(tenant_id=t,
                                   x=torch.from_numpy(rng.randn(8, 16).astype(np.float32)),
                                   w=torch.from_numpy(rng.randn(16, 4).astype(np.float32)))
                for t in range(3)]
    for p in problems:
        assert sched.submit(p)
    done = sched.flush()
    assert done == problems and sched.stats.dispatches == 1
    for p in problems:
        torch.testing.assert_close(p.result, p.x @ p.w)
        assert p.completion_time is not None
    stats = sched.cache.stats
    assert (stats.misses, stats.executions, stats.problems_executed, stats.padded_problems) \
        == (1, 1, 3, 1)  # R = 3 padded to the pow2 bucket 4
    assert sched.report()["cache_hit_rate"] == 0.0


def test_schedule_config_validation_matches():
    for bad in (dict(batching_window_s=-1.0), dict(preemption=True),
                dict(batching_policy="edf", allow_ragged_merge=True),
                dict(admission_policy="nope"), dict(max_superkernel_size=0)):
        with pytest.raises(ValueError):
            jconfig.ScheduleConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.ScheduleConfig(**bad)


def test_shape_bucket_keys_match():
    """GEMM buckets key the same shapes and dtype names in both packages."""
    for (m, k, n), (jdt, tdt) in [((4, 8, 16), (jnp.float32, torch.float32)),
                                  ((3, 5, 7), (jnp.bfloat16, torch.bfloat16))]:
        want = jqueue.ShapeBucket.for_gemm(jnp.zeros((m, k), jdt), jnp.zeros((k, n), jdt))
        got = tqueue.ShapeBucket.for_gemm(torch.zeros((m, k), dtype=tdt),
                                          torch.zeros((k, n), dtype=tdt))
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert hash(got) == hash(want)

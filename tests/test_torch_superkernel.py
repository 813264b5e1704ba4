"""The port's GEMM super-kernel path against the JAX package's.

The same numpy problems go through both packages' ``SuperKernelCache``,
``DynamicSpaceTimeScheduler`` (bare ``GemmProblem``s on a ``VirtualClock``
priced by one cost function) and the four strategies. Decisions and
accounting must agree exactly; outputs within float32 tolerance.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core

import repro.config as jconfig  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.core.strategies as jstrat  # noqa: E402
from repro.configs.paper_sgemm import PAPER_GEMM_SHAPES  # noqa: E402

import repro_torch.config as tconfig  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.strategies as tstrat  # noqa: E402

# float32 products of the same inputs, summed in another order
RTOL, ATOL = 1e-5, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.numpy()), np.asarray(want), rtol=RTOL, atol=ATOL)


class _Pkg:
    def __init__(self, config, core, to_array):
        self.config, self.core, self.array = config, core, to_array

    def problem(self, tenant, x, w):
        return self.core.GemmProblem(tenant_id=tenant, x=self.array(x), w=self.array(w))


JAX = _Pkg(jconfig, jcore, jnp.asarray)
PORT = _Pkg(tconfig, tcore, torch.from_numpy)


def _mats(rng, shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("bucketing", ["pow2", "exact"])
def test_cache_outputs_stats_and_buckets_match(bucketing):
    rng = np.random.default_rng(0)
    sched = dict(r_bucketing=bucketing)
    caches = {p: p.core.SuperKernelCache(p.config.ScheduleConfig(**sched)) for p in (JAX, PORT)}
    for r in (3, 4, 1, 5, 8, 3, 6):
        ops = [(t, *_mats(rng, [(16, 32), (32, 24)])) for t in range(r)]
        outs = {p: caches[p].execute([p.problem(t, x, w) for t, x, w in ops])
                for p in (JAX, PORT)}
        assert len(outs[PORT]) == r
        for got, want in zip(outs[PORT], outs[JAX]):
            _close(got, want)
        bucket = PORT.problem(0, ops[0][1], ops[0][2]).bucket
        jbucket = JAX.problem(0, ops[0][1], ops[0][2]).bucket
        assert dataclasses.astuple(bucket) == dataclasses.astuple(jbucket)
        assert caches[PORT].get(bucket, r)[1] == caches[JAX].get(jbucket, r)[1]

    xs, ws = _mats(rng, [(5, 16, 32), (5, 32, 24)])
    for p in (JAX, PORT):
        b = p.core.ShapeBucket("gemm", 16, 32, 24, "float32")
        outs[p] = caches[p].execute_stacked(b, p.array(xs), p.array(ws), 5)
    assert tuple(outs[PORT].shape) == (5, 16, 24)
    _close(outs[PORT], outs[JAX])

    problems = [(t, *_mats(rng, [(m, 32), (32, 24)])) for t, m in enumerate([32, 100, 7, 256, 1])]
    for p in (JAX, PORT):
        outs[p] = caches[p].execute_ragged([p.problem(t, x, w) for t, x, w in problems])
    for (t, x, w), got, want in zip(problems, outs[PORT], outs[JAX]):
        assert tuple(got.shape) == (x.shape[0], 24)
        _close(got, want)
        _close(got, x @ w)
    assert dataclasses.asdict(caches[PORT].stats) == dataclasses.asdict(caches[JAX].stats)
    assert caches[PORT].stats.hit_rate == caches[JAX].stats.hit_rate
    assert caches[PORT].stats.padded_problems > 0 or bucketing == "exact"


@pytest.mark.parametrize("bucketing", ["pow2", "exact"])
def test_ragged_layout_is_the_one_execute_ragged_keys_on(bucketing):
    """``ragged_layout`` gives the padded rows and group count of the JAX
    cache's ``grouped`` key for the same problems, and the row layout of
    the JAX ``make_group_layout``, tail blocks given to group 0."""
    from repro.kernels.grouped_gemm import make_group_layout

    rng = np.random.default_rng(1)
    sizes = [32, 100, 7, 256, 1]
    cache = jcore.SuperKernelCache(jconfig.ScheduleConfig(r_bucketing=bucketing))
    cache.execute_ragged([JAX.problem(t, *_mats(rng, [(m, 32), (32, 24)]))
                          for t, m in enumerate(sizes)])
    (key, g_bucket), = cache._cache
    port = tcore.SuperKernelCache(tconfig.ScheduleConfig(r_bucketing=bucketing))
    offsets, t_bucket, bg, g = port.ragged_layout(sizes)
    assert (t_bucket, g) == (key.M, g_bucket)
    want_offsets, want_bg, _ = make_group_layout(np.asarray(sizes), bm=128)
    assert np.array_equal(offsets, want_offsets)
    assert bg.dtype == np.int32 and len(bg) == t_bucket // 128
    assert np.array_equal(bg[: len(want_bg)], want_bg) and not bg[len(want_bg):].any()


# three buckets: two share (K, N) and differ in M, so the ragged merge joins them
BUCKETS = [(16, 32, 24), (40, 32, 24), (8, 16, 8)]


def _gemm_stream(seed, n=200, tenants=8):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(2e-4, size=n))
    who = rng.integers(0, tenants, size=n)
    which = rng.integers(0, len(BUCKETS), size=n)
    slos = rng.choice([0.004, 0.01, 0.03], size=n)
    weights = {(tid, K, N): rng.standard_normal((K, N)).astype(np.float32)
               for tid in range(tenants) for _, K, N in BUCKETS}
    stream = []
    for i in range(n):
        M, K, N = BUCKETS[which[i]]
        x = rng.standard_normal((M, K)).astype(np.float32)
        stream.append((float(t[i]), int(who[i]), x, weights[(int(who[i]), K, N)], float(slos[i])))
    return stream


def _cost(batch):
    """Seconds a merged dispatch takes: fixed launch cost + per flop."""
    return 1e-4 + 2e-10 * sum(float(p.cost) for p in batch)


def _drive(pkg, schedule_kwargs, stream):
    clock = pkg.core.VirtualClock()
    dispatches = []
    index = {}
    sched = pkg.core.DynamicSpaceTimeScheduler(
        pkg.config.ScheduleConfig(**schedule_kwargs), clock=clock, cost_model=_cost,
        on_dispatch=lambda batch, dt, rid: dispatches.append(
            [(p.tenant_id, index[id(p)]) for p in batch]))
    problems = []
    i, now = 0, 0.0
    while i < len(stream) or len(sched.queue):
        now += 1e-3  # coarse pumps: several buckets of a family ripen together
        clock.advance_to(now)
        while i < len(stream) and stream[i][0] <= clock.now():
            _, tenant, x, w, slo = stream[i]
            p = pkg.problem(tenant, x, w)
            p.slo_s = slo
            index[id(p)] = i
            problems.append(p)
            sched.submit(p)
            i += 1
        sched.pump()
        if now > stream[-1][0] + 1.0:
            sched.flush()
    return (dispatches, dataclasses.asdict(sched.stats), sched.monitor.summary(),
            sched.report(), dataclasses.asdict(sched.cache.stats), problems)


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
def test_scheduler_gemm_stream_matches_jax(ragged):
    kw = dict(batching_window_s=0.002, max_superkernel_size=8, allow_ragged_merge=ragged)
    stream = _gemm_stream(seed=int(ragged))
    want = _drive(JAX, kw, stream)
    got = _drive(PORT, kw, stream)
    assert len(got[0]) > 20
    assert got[0] == want[0]          # dispatch sequence: tenants and problem indices
    assert got[1] == want[1]          # SchedulerStats
    assert got[2] == want[2]          # monitor.summary()
    assert got[3] == want[3]          # report(), cache_hit_rate included
    assert got[4] == want[4]          # CacheStats
    assert "cache_hit_rate" in got[3] and got[3]["cache_hit_rate"] > 0.5
    for p, q in zip(got[5], want[5]):
        assert p.completion_time == q.completion_time
        _close(p.result, q.result)
    sizes = {len(b) for b in got[0]}
    assert max(sizes) > 1  # the stream really merges
    if ragged:  # and the ragged run really mixes row counts in one dispatch
        assert any(len({stream[idx][2].shape[0] for _, idx in b}) > 1 for b in got[0])


@pytest.mark.parametrize("name", ["time_only", "space_only", "space_time", "exclusive"])
def test_strategies_match_jax(name):
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    rng = np.random.default_rng(4)
    ops = [(t, *_mats(rng, [(g.M, g.K), (g.K, g.N)])) for t in range(4)]
    if name == "exclusive":  # one tenant: shared weights
        ops = [(0, x, ops[0][2]) for _, x, _ in ops]

    def make(pkg, strat_mod):
        cls = {"time_only": strat_mod.TimeOnly, "space_only": strat_mod.SpaceOnly,
               "exclusive": strat_mod.Exclusive}.get(name)
        if cls is not None:
            return cls()
        return strat_mod.SpaceTime(pkg.core.SuperKernelCache(
            pkg.config.ScheduleConfig(r_bucketing="exact")))

    results = {}
    for pkg, mod in ((JAX, jstrat), (PORT, tstrat)):
        s = make(pkg, mod)
        assert s.name == name
        s.prepare([pkg.problem(t, x, w) for t, x, w in ops])
        outs, secs = s.run()
        assert secs > 0
        results[pkg] = outs
    assert len(results[PORT]) == 4
    for (t, x, w), got, want in zip(ops, results[PORT], results[JAX]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(got.numpy(), x @ w, rtol=1e-5, atol=1e-3)


def test_time_only_switch_overhead_sleeps_once_per_dispatch(monkeypatch):
    """``TimeOnly(switch_overhead_s=s)`` takes the reference's argument,
    sleeps ``s`` once after each synced dispatch, and gives the outputs of
    ``TimeOnly()``."""
    rng = np.random.default_rng(6)
    problems = [PORT.problem(t, *_mats(rng, [(8, 16), (16, 12)])) for t in range(3)]
    plain = tstrat.TimeOnly()
    assert plain.switch_overhead_s == 0.0
    plain.prepare(problems)
    want, _ = plain.run()
    slept = []
    monkeypatch.setattr(tstrat.time, "sleep", slept.append)
    s = tstrat.TimeOnly(switch_overhead_s=0.25)
    s.prepare(problems)
    got, _ = s.run()
    assert slept == [0.25] * len(problems)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    slept.clear()
    plain.run()
    assert slept == []
    jax_sig = jstrat.TimeOnly(switch_overhead_s=0.25).switch_overhead_s
    assert s.switch_overhead_s == jax_sig


def test_tenant_manager_matches_jax():
    rng = np.random.default_rng(5)
    params = {t: {"w": rng.standard_normal((4, 3)).astype(np.float32)} for t in range(4)}
    mgrs = {}
    for pkg, conv in ((JAX, jnp.asarray), (PORT, torch.from_numpy)):
        m = pkg.core.TenantManager()
        for t, p in params.items():
            m.register(t, {"w": conv(p["w"])})
        m.evict(2)
        m.stacked()
        m.readmit(2)
        m.evict(0)
        mgrs[pkg] = m
    for attr in ("active_ids", "stack_order"):
        assert getattr(mgrs[PORT], attr) == getattr(mgrs[JAX], attr)
    assert mgrs[PORT].memory_bytes() == mgrs[JAX].memory_bytes()
    np.testing.assert_array_equal(mgrs[PORT].stacked()["w"].numpy(),
                                  np.asarray(mgrs[JAX].stacked()["w"]))
    assert [s.evictions for s in mgrs[PORT]._slots.values()] == \
        [s.evictions for s in mgrs[JAX]._slots.values()]
    with pytest.raises(ValueError):
        mgrs[PORT].register(1, params[1])
    views = tcore.unstack_params(mgrs[PORT].stacked(), 3)
    assert all(v["w"].data_ptr() == mgrs[PORT].stacked()["w"][i].data_ptr()
               for i, v in enumerate(views))

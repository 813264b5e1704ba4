"""Spec -> executor assembly: the imperative half of the API.

These builders translate each declarative sub-spec into the subsystem
object it wraps — trace generators from ``WorkloadSpec``, cost models
from ``CostModelSpec``, ``ScheduleConfig`` from ``SchedulerSpec`` — and
the three executors (``SimRun`` / ``FleetRun`` / ``LiveRun``) drive the
solo simulator, the fleet simulator, and the live engine fleet behind
one ``run() -> RunReport`` surface.

Construction happens per ``run()`` call, not per executor: cost models
and routers are stateful (compile caches, EWMA tables, cursors), so each
run starts from a fresh assembly and the determinism contract (same spec
+ same seed => byte-identical metrics JSON) holds across repeated runs
of one executor object.

The benchmark sweeps are thin callers of this module: they build a base
``SystemSpec``, ``replace()`` per grid cell, and call ``run_metrics()``
for the raw ``SimMetrics``/``FleetMetrics`` their BENCH exports freeze.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional, Sequence

from repro_torch.api.report import RunReport
from repro_torch.api.spec import (
    CostModelSpec,
    SystemSpec,
    WorkloadSpec,
)
from repro_torch.config import ScheduleConfig
from repro_torch.launch.roofline import resolve_spec
from repro_torch.sim.costmodel import (
    CalibratedCostModel,
    ColdStartCostModel,
    FleetCalibrator,
    RooflineCostModel,
    estimate_capacity_hz,
)
from repro_torch.sim.fleet import FleetSimulator, fleet_capacity_hz
from repro_torch.sim.simulator import Simulator
from repro_torch.sim.traces import (
    CsvReplayTrace,
    TenantSpec,
    fleet_sgemm_mix,
    make_trace,
    paper_sgemm_mix,
    prefill_decode_mix,
)


# ------------------------------------------------------------ mix / trace
def build_mix(workload: WorkloadSpec) -> List[TenantSpec]:
    """Tenant mix named by ``WorkloadSpec.mix`` (repro_torch.sim.traces)."""
    if workload.mix == "sgemm":
        return paper_sgemm_mix(workload.tenants)
    if workload.mix == "fleet":
        return fleet_sgemm_mix(workload.tenants, zipf_a=workload.zipf_a)
    if workload.mix == "serving":
        return prefill_decode_mix(workload.tenants)
    if workload.mix == "single":
        return single_shape_mix(workload.tenants, workload.slo_s)
    raise ValueError(f"unknown mix {workload.mix!r}")  # unreachable post-init


def single_shape_mix(tenants: int, slo_s: float) -> List[TenantSpec]:
    """All tenants launch the paper's ResNet-18 conv2_2 SGEMM geometry
    under one SLO — the historical ``dynamic_trace`` setting."""
    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
    from repro_torch.core.queue import ShapeBucket

    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    bucket = ShapeBucket("gemm", g.M, g.K, g.N, "float32")
    return [
        TenantSpec(
            tenant_id=t, name=f"t{t}/{g.name}", bucket=bucket,
            cost=float(g.flops), flops=float(g.flops),
            bytes=float(4 * (g.M * g.K + g.K * g.N + g.M * g.N)),
            slo_s=slo_s, kind="kernel",
        )
        for t in range(tenants)
    ]


def resolve_rate_hz(spec: SystemSpec, mix: Sequence[TenantSpec]) -> float:
    """Absolute offered arrivals/s for the spec's workload.

    ``rate_hz`` passes through; ``rho`` is anchored to the configured
    fleet's aggregate space_time capacity — per-replica rooflines summed
    for heterogeneous fleets, N x the solo capacity otherwise, with an
    elastic fleet anchored at its autoscaler's maximum (the capacity it
    can grow into). That anchoring is what makes one rho mean the same
    pressure for any mix or fleet shape.
    """
    w = spec.workload
    if w.rate_hz is not None:
        return w.rate_hz
    cost = spec.cost_model
    n = spec.fleet.max_replicas
    # capacity is priced at one representative merged dispatch round, so
    # the merge width must be the scheduler's actual cap — anchoring a
    # wide-merge spec at the default width would understate what the
    # scheduler can reach
    merge = (spec.scheduler.max_superkernel_size if spec.scheduler
             else 32)
    if spec.fleet.specs is not None:
        cycled = [spec.fleet.specs[i % len(spec.fleet.specs)] for i in range(n)]
        return w.rho * fleet_capacity_hz(mix, cycled, merge_size=merge)
    return w.rho * n * estimate_capacity_hz(
        mix, RooflineCostModel(
            spec=resolve_spec(cost.hardware), strategy="space_time",
            small_kernel_efficiency=cost.small_kernel_efficiency),
        merge_size=merge)


def build_trace(spec: SystemSpec, mix: Sequence[TenantSpec]):
    """Seeded arrival trace for the spec's workload (re-iterable)."""
    w = spec.workload
    if w.process == "replay":
        return CsvReplayTrace(mix, w.csv_path)
    return make_trace(w.process, mix, resolve_rate_hz(spec, mix), w.events,
                      seed=w.seed)


# --------------------------------------------------------------- cost model
def build_cost_model(cost: CostModelSpec) -> Callable[[Sequence], float]:
    """Base (roofline or calibrated-over-roofline) pricing model.

    Cold-start wrapping (``compile_us``) is the executors' job — compile
    caches are per-replica state, so the fleet wraps one instance per
    replica while the solo simulator wraps exactly one.
    """
    prior = RooflineCostModel(
        spec=resolve_spec(cost.hardware), strategy=cost.strategy,
        small_kernel_efficiency=cost.small_kernel_efficiency)
    if cost.kind == "roofline":
        return prior
    try:
        # spec-level prior_strength > 0 wins; 0 (the default) defers to
        # whatever the saved table carries
        return CalibratedCostModel.load(
            cost.calibration_path, prior=prior,
            prior_strength=(cost.prior_strength
                            if cost.prior_strength > 0 else None))
    except FileNotFoundError:
        raise ValueError(
            f"calibration table not found: {cost.calibration_path!r} "
            f"(fit one with `python -m repro_torch calibrate --spec ... --out "
            f"{cost.calibration_path}` or a live dynamic_trace "
            f"--calibrate run)") from None


def build_fleet_calibration(cost: CostModelSpec) -> Optional[FleetCalibrator]:
    """Per-replica measured-cost tables when the spec asks for them.

    Returns None unless ``fleet_calibration_path`` is set. An existing
    table file is LOADED (fresh replicas start from persisted EWMAs
    instead of cold ones); otherwise a fresh ``FleetCalibrator`` starts
    from the roofline prior. Persisting the fitted tables back is the
    LIVE executor's job — sim runs never write, so the byte-identical
    rerun contract cannot depend on how many times a spec has run.
    """
    if cost.fleet_calibration_path is None:
        return None
    prior = RooflineCostModel(
        spec=resolve_spec(cost.hardware), strategy=cost.strategy,
        small_kernel_efficiency=cost.small_kernel_efficiency)
    if os.path.exists(cost.fleet_calibration_path):
        return FleetCalibrator.load(cost.fleet_calibration_path, prior=prior)
    return FleetCalibrator(prior=prior, ewma_alpha=cost.ewma_alpha)


def build_schedule(spec: SystemSpec) -> Optional[ScheduleConfig]:
    return spec.scheduler.to_schedule_config() if spec.scheduler else None


# ---------------------------------------------------------------- partition
def build_partition(spec: SystemSpec, mix: Sequence[TenantSpec]):
    """``(plan, replanner)`` for a partitioned spec, ``(None, None)``
    otherwise.

    ``policy="explicit"`` maps ``shares`` verbatim to slices named
    ``p0..pN`` with tenants dealt round-robin. ``policy="knee"`` runs the
    deterministic planner (``repro_torch.partition.planner``) over the mix —
    priced from the calibrated table when the spec's cost model is
    calibrated, the roofline otherwise. The returned ``replanner`` maps
    ``{group: observed_R} -> PartitionPlan`` and backs mid-run
    re-planning (``replan_interval_s > 0``).
    """
    p = spec.partition
    if p is None:
        return None, None
    from repro_torch.partition import (
        DEFAULT_SHARE_GRID,
        PartitionPlan,
        PartitionShare,
        PlannerConfig,
        plan_partitions,
    )

    cost = spec.cost_model
    if p.policy == "explicit":
        shares = p.shares
        g = len(shares)
        plan = PartitionPlan(groups=tuple(
            PartitionShare(
                name=f"p{i}", share=s,
                tenants=tuple(t for t in range(spec.workload.tenants)
                              if t % g == i))
            for i, s in enumerate(shares)))
        return plan, None

    schedule = build_schedule(spec) or ScheduleConfig()
    cfg = PlannerConfig(
        share_grid=p.share_grid or DEFAULT_SHARE_GRID,
        knee_fraction=p.knee_fraction,
        min_share=p.min_share,
        base_window_s=schedule.batching_window_s,
        slack_fraction=p.slack_fraction,
        merge_size=schedule.max_superkernel_size,
        strategy=cost.strategy,
        small_kernel_efficiency=cost.small_kernel_efficiency,
    )
    hardware = resolve_spec(cost.hardware)
    model = build_cost_model(cost)
    calibrated = model if isinstance(model, CalibratedCostModel) else None

    def replanner(r_override):
        return plan_partitions(mix, hardware, cfg, calibrated=calibrated,
                               r_override=r_override)

    return replanner(None), replanner


# ------------------------------------------------------------ observability
def build_recorder(spec: SystemSpec):
    """A fresh ``FlightRecorder`` when the spec enables observability,
    else None (the executors thread None through and every hot path pays
    one is-None test)."""
    obs = spec.observability
    if not obs.enabled:
        return None
    from repro_torch.obs.recorder import FlightRecorder

    return FlightRecorder(per_request=obs.per_request)


def scheduler_counters(m) -> dict:
    """``SchedulerStats`` surfaced as a diffable dict (the counters
    ``scheduler.report()`` buries inside the executor)."""
    return {
        "busy_time_s": float(m.busy_time_s),
        "completed": float(m.completed),
        "dispatches": float(m.dispatches),
        "evicted_tenants": float(m.evicted_tenants),
        "rejected": float(m.rejected),
        "ripe_nudges": float(m.ripe_nudges),
        "deadline_rejected": float(m.deadline_rejected),
        "oversubscribed": float(m.oversubscribed),
        "preemptions": float(m.preemptions),
        "total_cost": float(m.cost.sum()),
    }


def _augment_metrics(spec: SystemSpec, metrics_doc: dict, m,
                     recorder) -> dict:
    """Report-layer additions on top of the frozen metrics dict: the
    scheduler-counter section always, windowed telemetry + trace export
    when the recorder ran. The metrics dict itself (``to_dict()``) is
    untouched — recorder-off metrics JSON stays byte-identical to
    pre-recorder builds."""
    merged = getattr(m, "merged", m)
    counters = scheduler_counters(merged)
    per_rep = getattr(m, "per_replica", None)
    if per_rep is not None:
        counters["per_replica_ripe_nudges"] = [
            float(r.ripe_nudges) for r in per_rep]
    metrics_doc["scheduler"] = counters
    if recorder is not None:
        from repro_torch.obs.telemetry import windowed_series
        from repro_torch.obs.trace_export import export_chrome_trace

        obs = spec.observability
        metrics_doc["telemetry"] = windowed_series(recorder, obs.window_s)
        if obs.trace_path:
            with open(obs.trace_path, "w") as fh:
                fh.write(export_chrome_trace(recorder) + "\n")
    return metrics_doc


def fold_seed(seed: int, index: int) -> int:
    """The seed of stream ``index`` drawn from ``seed`` (a tenant's
    weights): distinct for every (seed, index) with index < 2**20."""
    return (int(seed) << 20) + int(index)


# ---------------------------------------------------------------- executors
class SimRun:
    """Solo executor: one replica of the real scheduler on a virtual
    clock (``repro_torch.sim.simulator.Simulator``)."""

    executor = "simulator"

    def __init__(self, spec: SystemSpec):
        self.spec = spec
        # the flight recorder of the most recent run_metrics() call —
        # the CLI trace surface exports from it after the run
        self.last_recorder = None

    def run_metrics(self):
        """Fresh assembly, one trace, raw ``SimMetrics``."""
        spec = self.spec
        mix = build_mix(spec.workload)
        trace = build_trace(spec, mix)
        model = build_cost_model(spec.cost_model)
        rec = build_recorder(spec)
        sim = Simulator(schedule=build_schedule(spec), cost_model=model,
                        recorder=rec)
        if spec.cost_model.compile_us > 0.0:
            # before sim.run(): the recorder attaches lazily there and
            # its dispatch tap must see the cold-start wrapper
            cold = ColdStartCostModel(
                model, compile_s=spec.cost_model.compile_us * 1e-6,
                clock=sim.clock)
            sim.pump.cost_model = cold
            sim.scheduler.cost_model = cold
        metrics = sim.run(trace)
        self.last_recorder = rec
        return metrics

    def run(self) -> RunReport:
        m = self.run_metrics()
        doc = _augment_metrics(self.spec, m.to_dict(), m,
                               self.last_recorder)
        return RunReport(executor=self.executor, mode=self.spec.mode,
                         spec=self.spec.to_dict(), metrics=doc)


class FleetRun:
    """Fleet executor: N replicas behind a router, optionally
    heterogeneous and elastic (``repro_torch.sim.fleet.FleetSimulator``)."""

    executor = "fleet"

    def __init__(self, spec: SystemSpec):
        self.spec = spec
        self.last_recorder = None

    def run_metrics(self):
        """Fresh fleet, one trace, raw ``FleetMetrics``."""
        spec = self.spec
        fleet, cost = spec.fleet, spec.cost_model
        mix = build_mix(spec.workload)
        trace = build_trace(spec, mix)
        rec = build_recorder(spec)
        plan, replanner = build_partition(spec, mix)
        sim = FleetSimulator(
            replicas=fleet.replicas,
            router=spec.router.policy,
            schedule=build_schedule(spec),
            cost_model=(None if (fleet.specs or plan is not None)
                        else build_cost_model(cost)),
            compile_s=cost.compile_us * 1e-6,
            specs=list(fleet.specs) if fleet.specs else None,
            strategy=cost.strategy,
            autoscaler=fleet.autoscale.build() if fleet.autoscale else None,
            calibration=build_fleet_calibration(cost),
            workers=fleet.workers,
            recorder=rec,
            partition=plan,
            partition_hardware=(resolve_spec(cost.hardware)
                                if plan is not None else None),
            small_kernel_efficiency=cost.small_kernel_efficiency,
            replanner=replanner,
            replan_interval_s=(spec.partition.replan_interval_s
                               if spec.partition else 0.0),
        )
        metrics = sim.run(trace)
        self.last_recorder = rec
        return metrics

    def run(self) -> RunReport:
        m = self.run_metrics()
        doc = _augment_metrics(self.spec, m.to_dict(), m,
                               self.last_recorder)
        return RunReport(executor=self.executor, mode=self.spec.mode,
                         spec=self.spec.to_dict(), metrics=doc)


class LiveRun:
    """Live executor: N real engines behind the simulator's routing layer
    (``repro_torch.serving.fleet.LiveFleet``) — the same pump/router/admission
    core the fleet simulator runs, on the wall clock, executing real work.

    ``workload.arch`` picks the engine. The pseudo-archs ``"fake"``
    (deterministic tokens) and ``"null"`` (no results — the sim-parity
    twin) need no model and run on any CPU; every other name builds one
    real ``MultiTenantEngine`` per replica over SHARED smoke-variant
    weights in float32, as the reference does (N replicas
    space-multiplexing one card is the paper's story told at the cluster
    layer). The engines run on ``device``: the CUDA card unless the caller
    asks for another (the tests pass "cpu"); with no card a real-arch run
    raises. Tenant t's weights are drawn from a ``torch.Generator`` seeded
    ``fold_seed(workload.seed, t)``, so they differ from the reference's
    ``jax.random`` draws of the same seed: a deliberate difference, as for
    non-greedy sampling. Model code loads at ``run()`` time, so spec
    validation and sim-only workflows never pay for it.

    Wall-clock latencies are real, so live reports are NOT covered by
    the byte-identical determinism contract — routing decisions,
    admission counters and (fake-engine) token streams are
    deterministic, latencies are not.
    """

    executor = "live"

    def __init__(self, spec: SystemSpec, device=None):
        self.spec = spec
        self.device = device
        self.last_recorder = None
        # the fleet of the most recent run_metrics() call — the serving
        # loop keeps it alive to submit requests against
        self.last_fleet = None
        self.engine_name = None
        self.wall_s = 0.0

    def build_engine_factory(self):
        """``(engine_factory, engine_name, vocab)`` for ``workload.arch``.

        Only the real-arch branch loads a model; "fake"/"null" stay pure
        python so the live fleet path runs anywhere.
        """
        w = self.spec.workload
        if w.arch == "null":
            from repro_torch.serving.fleet import NullEngine

            return NullEngine, "null", 32_000
        if w.arch == "fake":
            from repro_torch.serving.fleet import FakeEngine

            return (lambda i: FakeEngine(i, max_new_tokens=w.max_new_tokens),
                    "fake", 32_000)

        import dataclasses as _dc

        import torch

        from repro_torch.config import get_config, smoke_variant
        from repro_torch.models import build_model
        from repro_torch.serving import EngineConfig, MultiTenantEngine
        from repro_torch.serving.fleet import EngineReplica

        spec = self.spec
        cfg = _dc.replace(smoke_variant(get_config(w.arch)), dtype="float32")
        model = build_model(cfg, device=self.device)
        gens = []
        for t in range(w.tenants):
            gen = torch.Generator(device=model.device)
            gen.manual_seed(fold_seed(w.seed, t))
            gens.append(gen)
        stacked = model.init_stacked(gens)
        # the engine's contrast mode mirrors the cost-model strategy:
        # time_only gives each tenant its own bucket (sequential
        # dispatch), everything else rides the merged space-time path
        engine_mode = ("time_only" if spec.cost_model.strategy == "time_only"
                       else "space_time")
        schedule = build_schedule(spec)

        def factory(i: int) -> EngineReplica:
            engine = MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
                num_tenants=w.tenants,
                slots_per_tenant=2,
                cache_len=max(32, w.prompt_tokens + w.max_new_tokens + 8),
                mode=engine_mode,
                seed=w.seed + i,
                schedule=schedule,
            ))
            return EngineReplica(engine, replica_id=i,
                                 max_new_tokens=w.max_new_tokens)

        return factory, EngineReplica.name, cfg.vocab_size

    def build_fleet(self, recorder=None):
        """Assemble a fresh ``LiveFleet`` (engines included) for this
        spec — shared by ``run_metrics`` and the HTTP serving loop."""
        from repro_torch.serving.fleet import LiveFleet

        spec = self.spec
        fleet_spec, cost = spec.fleet, spec.cost_model
        factory, engine_name, vocab = self.build_engine_factory()
        self.engine_name = engine_name
        calibration = build_fleet_calibration(cost)
        fleet = LiveFleet(
            replicas=fleet_spec.replicas,
            engine_factory=factory,
            router=spec.router.policy,
            schedule=build_schedule(spec),
            cost_model=None if fleet_spec.specs else build_cost_model(cost),
            compile_s=cost.compile_us * 1e-6,
            specs=list(fleet_spec.specs) if fleet_spec.specs else None,
            strategy=cost.strategy,
            calibration=calibration,
            recorder=recorder,
        )
        return fleet, vocab

    def save_calibration(self, fleet) -> None:
        """Persist the fleet's fitted per-replica tables (live runs only
        — the next run, or a sim pricing the same path, starts warm)."""
        path = self.spec.cost_model.fleet_calibration_path
        if path and fleet.calibration is not None:
            fleet.calibration.save(path)

    def run_metrics(self):
        """Fresh fleet over real engines, one trace, raw ``FleetMetrics``."""
        import numpy as np

        spec = self.spec
        w = spec.workload
        mix = build_mix(w)
        trace = build_trace(spec, mix)
        rec = build_recorder(spec)
        fleet, vocab = self.build_fleet(recorder=rec)
        rng = np.random.RandomState(w.seed)

        def payload_fn(tspec):
            return rng.randint(1, vocab, size=w.prompt_tokens).tolist()

        t0 = time.perf_counter()
        metrics = fleet.run(trace, payload_fn=payload_fn)
        self.wall_s = time.perf_counter() - t0
        self.save_calibration(fleet)
        self.last_recorder = rec
        self.last_fleet = fleet
        return metrics

    def run(self) -> RunReport:
        m = self.run_metrics()
        doc = _augment_metrics(self.spec, m.to_dict(), m,
                               self.last_recorder)
        # live extras on top of the shared FleetMetrics schema
        doc["arch"] = self.spec.workload.arch
        doc["engine"] = self.engine_name
        doc["wall_s"] = self.wall_s
        return RunReport(executor=self.executor, mode=self.spec.mode,
                         spec=self.spec.to_dict(), metrics=doc)

"""Multi-replica fleet simulation: N real schedulers behind a router.

The replica-scaling half of the paper's story (Fig. 5 counts how many
replicas FIT; this answers what a fleet of them DOES under load): each
replica is a full ``ReplicaPump`` — the real ``DynamicSpaceTimeScheduler``
on its own ``VirtualClock`` with its own compile-cache cold-start state —
and a pluggable ``Router`` (``repro_torch.sim.router``) assigns every arrival
to one of them.

The fleet event loop merges per-replica ripeness instants into ONE global
timeline: between trace arrivals it repeatedly finds the replica with the
earliest next ripeness instant and pumps exactly that replica there, so
cross-replica event ordering is exact, not quantized per replica. Routing
decisions therefore observe every replica's true state as of the
arrival's trace time.

Cold starts are what couple routing to scheduling: each replica wraps its
base cost model in its own ``ColdStartCostModel``, so the first dispatch
of a (bucket, pow2-R) variant on a given replica pays a compile term —
spreading a tenant across the fleet multiplies compiles, pinning it
concentrates load. That is the JSQ-vs-affinity trade the routers measure.

Three fleet-scale axes beyond an identical-replica grid:

* **Heterogeneity** — ``specs`` gives each replica its own
  ``HardwareSpec`` (cycled: ``["h100", "h100_half"]`` alternates fast and
  half-speed cards), so each replica prices work through its OWN roofline
  and speed-aware routers (``least_cost``) see the difference. A
  load-oblivious router wastes the fast chips exactly as D-STACK predicts.
* **Elasticity** — an ``Autoscaler`` (``repro_torch.sim.autoscale``) is polled
  at fixed simulated-time ticks; scale-up spawns a FRESH replica (new id,
  EMPTY compile cache — the full cold-start bill — and an optional
  ``spinup_s`` before it takes work), scale-down retires the replica
  with the lowest drain cost (ties: the newest), which drains what it
  already owns but receives nothing new.
  Every decision lands in ``scale_events`` and the metrics JSON.
* **Per-replica calibration** — a ``FleetCalibrator`` taps every
  replica's ``on_dispatch`` (the scheduler forwards ``replica_id``) into
  per-replica ``CalibratedCostModel`` tables, and each replica routes
  through its own table (``ReplicaPump.route_model``): even with a wrong
  shared prior, routing converges toward each chip's measured costs.

Determinism: routers and autoscalers are pure functions of replica state,
replica state is driven by seeded traces and virtual clocks — one seed,
byte-identical fleet metrics JSON, scale events included; same contract
as the solo simulator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.config import ScheduleConfig
from repro_torch.core.clock import VirtualClock
from repro_torch.core.pump import drain_fleet_tail, drain_merged
from repro_torch.launch.roofline import H100, HardwareSpec
from repro_torch.sim.autoscale import (
    Autoscaler,
    ScaleEvent,
    make_autoscaler,
    pick_scale_down,
)
from repro_torch.sim.costmodel import (
    ColdStartCostModel,
    FleetCalibrator,
    RooflineCostModel,
    estimate_capacity_hz,
    resolve_spec,
)
from repro_torch.obs.recorder import route_price_vector
from repro_torch.partition.shares import PartitionPlan
from repro_torch.sim.metrics import FleetMetrics, MetricsAccumulator
from repro_torch.sim.router import Router, make_router
from repro_torch.sim.simulator import ReplicaPump, SimWorkload
from repro_torch.sim.traces import Arrival, Trace

# The spec every replica's speed factor is measured against, and the
# default partition hardware: one module-level spec, so simulated and live
# fleets measure speed against the same base.
BASE_SPEC: HardwareSpec = H100


def _arrival_stream(trace):
    """Flatten a trace to ``(t_s, spec, cost)`` triples, preferring the
    columnar chunk iterator: plain-float columns and an interned spec
    table instead of one ``Arrival`` namedtuple (plus numpy-scalar
    unboxing) per event. Values are bit-identical either way — the chunk
    contract — so the fleet loop's timeline does not depend on which
    path fed it."""
    iter_chunks = getattr(trace, "iter_chunks", None)
    if iter_chunks is None:
        yield from trace
        return
    for times, idx, costs, table in iter_chunks():
        for t, i, c in zip(times.tolist(), idx.tolist(), costs.tolist()):
            yield t, table[i], c


def calibration_tap(calibration: FleetCalibrator, model):
    """Dispatch tap that fits WARM costs: a cold dispatch's measured
    seconds include the one-off compile term, and folding that into
    the table would make a replica price a key HIGHER right after
    compiling it (inverting warm-cache affinity — the first
    observation per key is by construction the cold one). The
    cold-start wrapper knows which dispatches were cold, so the tap
    subtracts its compile term before the calibrator sees them.

    Shared by the fleet simulator and the live fleet: in the simulator
    ``seconds`` is the modeled dispatch cost; live it is REAL measured
    wall seconds (``t1 - t0`` around the actual kernel execution) — same
    tap, same tables, which is what makes live-calibrated tables loadable
    back into sim runs."""
    if not isinstance(model, ColdStartCostModel):
        return calibration.observe

    def tap(batch, seconds, replica_id):
        if model.dispatch_cold and model.dispatch_cold[-1]:
            seconds -= model.compile_s
        calibration.observe(batch, seconds, replica_id)

    return tap


def fleet_capacity_hz(
    mix: Sequence,
    specs: Sequence[Union[str, HardwareSpec]],
    strategy: str = "space_time",
    merge_size: int = 32,
) -> float:
    """Aggregate sustainable arrivals/s of a heterogeneous fleet: the sum
    of each replica's ``estimate_capacity_hz`` under its own spec — the
    anchor hetero sweeps use so a mixed fleet and its equal-aggregate
    homogeneous twin see the same offered load."""
    return sum(
        estimate_capacity_hz(
            mix, RooflineCostModel(spec=resolve_spec(s), strategy=strategy),
            merge_size=merge_size)
        for s in specs)


class FleetSimulator:
    """N replicas of the real scheduler behind a router, one timeline.

    Replica pricing, pick ONE of:

    * ``cost_model`` — a SHARED stateless base (roofline or calibrated)
      every replica wraps: the homogeneous fleet.
    * ``specs`` — per-replica hardware (``HardwareSpec`` instances or
      ``HARDWARE_SPECS`` names, cycled over the fleet); replica ``i``
      prices through ``RooflineCostModel(spec=specs[i % len], strategy)``:
      the heterogeneous fleet.

    When ``compile_s > 0`` each replica additionally wraps its base in
    its own ``ColdStartCostModel`` — per-replica warm caches
    (``compile_s=0`` turns cold-start modeling off).

    ``autoscaler`` (an ``Autoscaler`` or factory name) makes the fleet
    elastic: ``replicas`` then sets the INITIAL size and the policy's
    min/max bound the rest. ``calibration`` (a ``FleetCalibrator``) wires
    every replica's dispatch tap into per-replica measured-cost tables
    that routing then prices through.

    ``workers > 1`` shards the replica pumps across forked worker
    processes (``repro_torch.sim.shard``): byte-identical metrics to
    ``workers=1``, but restricted to configurations where replicas are
    provably independent — a fresh round-robin router, no autoscaler, no
    calibration, and a stable-window policy. ``run`` raises an
    actionable error otherwise.

    One-shot: state (routed counts, scale events, calibration tables)
    accumulates across ``run`` — build a fresh instance per trace, or use
    ``simulate_fleet``.
    """

    def __init__(
        self,
        replicas: int,
        router: Union[Router, str] = "jsq",
        schedule: Optional[ScheduleConfig] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        compile_s: float = 1e-3,
        start_s: float = 0.0,
        specs: Optional[Sequence[Union[str, HardwareSpec]]] = None,
        strategy: str = "space_time",
        autoscaler: Optional[Union[Autoscaler, str]] = None,
        calibration: Optional[FleetCalibrator] = None,
        workers: int = 1,
        recorder=None,
        partition: Optional[PartitionPlan] = None,
        partition_hardware: Optional[HardwareSpec] = None,
        small_kernel_efficiency: float = 0.45,
        replanner: Optional[Callable[[Optional[Dict[str, int]]],
                                     PartitionPlan]] = None,
        replan_interval_s: float = 0.0,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if specs is not None and cost_model is not None:
            raise ValueError(
                "pass per-replica specs OR a shared cost_model, not both")
        if specs is not None and not specs:
            raise ValueError("specs must be non-empty when given")
        if partition is not None:
            # co-located slice pumps share one chip's timeline: per-chip
            # state the shard merge / autoscaler / hetero specs cannot
            # reason about — same rules SystemSpec enforces at load time
            if workers > 1:
                raise ValueError(
                    "partition requires workers=1 (co-located slice pumps "
                    "share per-chip state the shard merge does not replay)")
            if autoscaler is not None:
                raise ValueError(
                    "partition cannot combine with an autoscaler: the plan "
                    "carves a fixed replica set; drop one")
            if specs is not None:
                raise ValueError(
                    "partition cannot combine with per-replica specs: "
                    "slices are carved from ONE base hardware "
                    "(partition_hardware)")
            if cost_model is not None:
                raise ValueError(
                    "partition builds each slice's own sliced-roofline "
                    "model; drop the shared cost_model")
        if replan_interval_s < 0.0:
            raise ValueError(
                f"replan_interval_s must be >= 0, got {replan_interval_s}")
        self.workers = int(workers)
        self.router = make_router(router) if isinstance(router, str) else router
        self.schedule = schedule
        self.start_s = float(start_s)
        self.compile_s = float(compile_s)
        self.strategy = strategy
        self.specs = [resolve_spec(s) for s in specs] if specs else None
        self._shared_base = cost_model
        self.autoscaler = (make_autoscaler(autoscaler)
                           if isinstance(autoscaler, str) else autoscaler)
        self.calibration = calibration
        # optional FlightRecorder (repro_torch.obs); set before the initial
        # spawn loop so every replica — initial or autoscaled — attaches
        self.recorder = recorder
        self.partition = partition
        self.partition_hardware = partition_hardware or BASE_SPEC
        self.small_kernel_efficiency = float(small_kernel_efficiency)
        self.replanner = replanner
        self.replan_interval_s = float(replan_interval_s)
        self.partition_events: List[Dict] = []
        # group index -> that group's slice pumps, one per physical chip
        self._group_pumps: List[List[ReplicaPump]] = (
            [[] for _ in partition.groups] if partition is not None else [])
        # replica_id -> the mutable RooflineCostModel a slice prices
        # through (re-planning swaps its .spec in place)
        self._partition_bases: Dict[int, RooflineCostModel] = {}

        self.pumps: List[ReplicaPump] = []       # every replica ever live
        self.active: List[ReplicaPump] = []      # currently routable
        self._retired: List[ReplicaPump] = []    # scaled down, may drain
        self.routed_counts: List[int] = []       # indexed by replica_id
        self.scale_events: List[ScaleEvent] = []
        self._fleet_acc = MetricsAccumulator()
        self._replica_accs: List[MetricsAccumulator] = []
        self._next_id = 0
        groups = len(partition.groups) if partition is not None else 1
        for _ in range(replicas * groups):
            self._spawn(self.start_s)
        if partition is not None:
            for g in partition.groups:
                self.partition_events.append({
                    "t_s": self.start_s, "action": "assign",
                    "group": g.name, "share": g.share,
                    "tenants": list(g.tenants), "window_s": g.window_s})

    # -------------------------------------------------------- replica pool
    def _slice_spec(self, group) -> HardwareSpec:
        hw = self.partition_hardware
        return hw.sliced(group.share,
                         name=f"{hw.name}@{group.name}:{group.share:g}")

    def _base_model(self, replica_id: int) -> Callable[[Sequence], float]:
        if self.partition is not None:
            group = self.partition.groups[
                replica_id % len(self.partition.groups)]
            base = RooflineCostModel(
                spec=self._slice_spec(group), strategy=self.strategy,
                small_kernel_efficiency=self.small_kernel_efficiency)
            self._partition_bases[replica_id] = base
            return base
        if self.specs is not None:
            return RooflineCostModel(
                spec=self.specs[replica_id % len(self.specs)],
                strategy=self.strategy)
        return self._shared_base or RooflineCostModel()

    def _spawn(self, t_s: float) -> ReplicaPump:
        """Bring up one replica whose clock starts at ``t_s`` — at init
        that is the fleet epoch; mid-run it is the scale-up instant (plus
        spin-up), and the fresh ``ColdStartCostModel`` means every variant
        recompiles on it: spinning up pays the full cold cache."""
        i = self._next_id
        self._next_id += 1
        base = self._base_model(i)
        clock = VirtualClock(t_s)
        model: Callable[[Sequence], float] = base
        if self.compile_s > 0.0:
            model = ColdStartCostModel(base, compile_s=self.compile_s,
                                       clock=clock)
        schedule = self.schedule
        if self.partition is not None:
            # the planner co-optimized a batching window per slice: a
            # slice with deadline slack batches wider, a tight one leaner
            group = self.partition.groups[i % len(self.partition.groups)]
            if group.window_s is not None:
                schedule = dataclasses.replace(
                    schedule or ScheduleConfig(),
                    batching_window_s=group.window_s)
        pump = ReplicaPump(schedule=schedule, cost_model=model,
                           clock=clock, replica_id=i)
        pump.track_inflight = True  # routers read occupancy in fleet time
        spec = getattr(base, "spec", None)
        if spec is not None:
            pump.spec_name = spec.name
            # relative chip speed: the weighted-affinity routing signal
            pump.speed_factor = spec.peak_flops / BASE_SPEC.peak_flops
        if self.calibration is not None:
            pump.scheduler.on_dispatch = self._calibration_tap(model)
            pump.route_model = self.calibration.for_replica(i)
        if self.recorder is not None:
            # after calibration wiring: the recorder tap composes over it
            pump.attach_recorder(self.recorder.shard(i))
        if self.partition is not None:
            self._group_pumps[i % len(self.partition.groups)].append(pump)
        acc = MetricsAccumulator()
        pump.accs = [self._fleet_acc, acc]
        self.pumps.append(pump)
        self.active.append(pump)
        self.routed_counts.append(0)
        self._replica_accs.append(acc)
        return pump

    def _calibration_tap(self, model):
        return calibration_tap(self.calibration, model)

    def _apply_autoscale(self, now: float) -> None:
        scaler = self.autoscaler
        target = scaler.decide(self.active, now)
        signal = float(getattr(scaler, "last_signal", 0.0))
        while len(self.active) < target:
            p = self._spawn(now + scaler.spinup_s)
            self.scale_events.append(ScaleEvent(
                t_s=now, action="up", replica_id=p.replica_id,
                active=len(self.active), signal=signal))
        while len(self.active) > max(target, 1):
            # retire the cheapest-to-drain replica (backlog seconds priced
            # via its own table); ties retire the newest, keeping the
            # longest-warmed caches alive — deterministic either way
            p = self.active.pop(pick_scale_down(self.active, now))
            self._retired.append(p)
            self.scale_events.append(ScaleEvent(
                t_s=now, action="down", replica_id=p.replica_id,
                active=len(self.active), signal=signal))

    def _apply_replan(self, now: float) -> None:
        """Re-run the planner from each slice's OBSERVED mean merged
        batch size and swap slice sizes in place.

        Only SHARES move: each affected pump's base ``RooflineCostModel``
        gets the new sliced spec (pricing, feasibility admission and
        routing all read it from there), while batching windows stay at
        their planned values — the pump's calendar queue is built around
        a fixed window. Group membership never changes (the planner is
        deterministic in the mix), so routing stays stable too.
        """
        plan = self.partition
        r_obs: Dict[str, int] = {}
        for gi, g in enumerate(plan.groups):
            stats = [p.scheduler.stats for p in self._group_pumps[gi]]
            dispatches = sum(s.dispatches for s in stats)
            if dispatches > 0:
                completed = sum(s.problems_completed for s in stats)
                r_obs[g.name] = max(1, round(completed / dispatches))
        new_plan = self.replanner(r_obs or None)
        applied = []
        for gi, (old, new) in enumerate(zip(plan.groups, new_plan.groups)):
            applied.append(dataclasses.replace(new, window_s=old.window_s))
            if abs(new.share - old.share) <= 1e-12:
                continue
            spec = self._slice_spec(new)
            for p in self._group_pumps[gi]:
                self._partition_bases[p.replica_id].spec = spec
                p.spec_name = spec.name
                p.speed_factor = spec.peak_flops / BASE_SPEC.peak_flops
            self.partition_events.append({
                "t_s": now, "action": "replan", "group": new.name,
                "share": new.share, "prev_share": old.share,
                "observed_r": r_obs.get(new.name, 0)})
        self.partition = PartitionPlan(groups=tuple(applied))

    # ------------------------------------------------------------ event loop
    def _drain_until(self, t_limit: float) -> None:
        """Merged global timeline (``repro_torch.core.pump.drain_merged``) over
        ALL replicas that can still ripen — a scaled-down replica no
        longer receives arrivals but still drains what it owns."""
        # a retired replica with a dry queue can never ripen again; skip
        # it so heavy autoscale cycling doesn't grow the per-event scan
        pumps = self.active
        if self._retired:
            pumps = pumps + [p for p in self._retired
                             if len(p.scheduler.queue)]
        drain_merged(pumps, t_limit)

    def run(self, trace: Union[Trace, Iterable[Arrival]]) -> FleetMetrics:
        if self.workers > 1:
            # deferred import: shard imports this module
            from repro_torch.sim.shard import run_sharded
            return run_sharded(self, trace)
        router, scaler = self.router, self.autoscaler
        rec = self.recorder
        t_start = self.start_s
        next_tick = t_start + scaler.interval_s if scaler is not None else None
        next_replan = None
        if (self.partition is not None and self.replanner is not None
                and self.replan_interval_s > 0.0):
            next_replan = t_start + self.replan_interval_s

        for t_s, spec, cost in _arrival_stream(trace):
            while next_tick is not None and t_s >= next_tick:
                self._drain_until(next_tick)
                self._apply_autoscale(next_tick)
                next_tick += scaler.interval_s
            while next_replan is not None and t_s >= next_replan:
                self._drain_until(next_replan)
                self._apply_replan(next_replan)
                next_replan += self.replan_interval_s
            self._drain_until(t_s)
            # a partitioned fleet routes WITHIN the tenant's slice group:
            # the candidates are that slice's pumps across chips, so the
            # router load-balances chips while the plan owns placement
            candidates = self.active
            if self.partition is not None:
                candidates = self._group_pumps[
                    self.partition.group_of(spec.tenant_id)]
            idx = router.route(spec, candidates, t_s)
            pump = candidates[idx]
            if rec is not None:
                # recompute the (idempotent) price vector the router just
                # read — recorded before submit so the decision context is
                # the pre-admission state it was actually made against
                rids, prices = route_price_vector(
                    router, spec, candidates, t_s)
                rec.record_route(t_s, spec.tenant_id, pump.replica_id,
                                 rids, prices)
            w = SimWorkload(spec, cost)
            w.est_s = pump.estimate_item_s(w)
            if pump.submit(w, t_s):
                self.routed_counts[pump.replica_id] += 1

        # tail: keep merging ripeness instants until every queue is dry,
        # then force-flush whatever the estimates could not ripen
        pumps = self.pumps
        drain_fleet_tail(pumps, self._drain_until)

        # fleet horizon: the makespan across replicas that actually
        # dispatched; every replica's utilization is reported against it
        # so the spread is meaningful. A spun-up replica that never took
        # work keeps its future-dated (spawn + spin-up) clock and must
        # not stretch the horizon — that would deflate every per-second
        # metric for work the fleet finished long before.
        horizon = max((p.clock.now() for p in pumps
                       if p.scheduler.stats.dispatches > 0),
                      default=t_start) - t_start
        if rec is not None:
            rec.router_name = self.router.name
            rec.record_scale_events(self.scale_events)
            if self.partition is not None:
                rec.record_partition_events(self.partition_events)
        partition_doc = None
        if self.partition is not None:
            partition_doc = {
                "plan": self.partition.to_dict(),
                "events": [dict(e) for e in self.partition_events],
                "groups_per_replica": len(self.partition.groups),
            }
        merged = self._freeze_merged(self._fleet_acc, horizon)
        per_replica = [p.freeze(acc, sim_duration_s=horizon)
                       for p, acc in zip(pumps, self._replica_accs)]
        cold_times, cold_flags = self._cold_series()
        return FleetMetrics(
            merged=merged,
            per_replica=per_replica,
            routed_counts=list(self.routed_counts),
            router=self.router.name,
            cold_times=cold_times,
            cold_flags=cold_flags,
            scale_events=self.scale_events,
            replica_specs=[p.spec_name for p in pumps],
            final_active=len(self.active),
            partition=partition_doc,
        )

    # ------------------------------------------------------------- internals
    def _freeze_merged(self, acc: MetricsAccumulator,
                       horizon: float):
        stats = [p.scheduler.stats for p in self.pumps]
        return acc.freeze(
            sim_duration_s=horizon,
            busy_time_s=sum(s.busy_time_s for s in stats),
            dispatches=sum(s.dispatches for s in stats),
            rejected=sum(s.rejected for s in stats),
            evicted_tenants=sum(len(p.scheduler.evicted) for p in self.pumps),
            ripe_nudges=sum(s.ripe_nudges for s in stats),
            deadline_rejected=sum(s.deadline_rejected for s in stats),
            oversubscribed=sum(s.oversubscribed for s in stats),
            preemptions=sum(s.preemptions for s in stats),
        )

    def _cold_series(self):
        """Concatenated (time, was_cold) dispatch series across replicas,
        sorted by time (stable, so equal instants keep replica order —
        deterministic)."""
        times: List[np.ndarray] = []
        flags: List[np.ndarray] = []
        for p in self.pumps:
            m = p.cost_model
            if isinstance(m, ColdStartCostModel):
                times.append(np.asarray(m.dispatch_times, np.float64))
                flags.append(np.asarray(m.dispatch_cold, np.int64))
        if not times:
            return np.zeros(0, np.float64), np.zeros(0, np.int64)
        t = np.concatenate(times)
        f = np.concatenate(flags)
        order = np.argsort(t, kind="stable")
        return t[order], f[order]


def simulate_fleet(
    trace: Union[Trace, Iterable[Arrival]],
    replicas: int,
    router: Union[Router, str] = "jsq",
    schedule: Optional[ScheduleConfig] = None,
    cost_model: Optional[Callable[[Sequence], float]] = None,
    compile_s: float = 1e-3,
    specs: Optional[Sequence[Union[str, HardwareSpec]]] = None,
    strategy: str = "space_time",
    autoscaler: Optional[Union[Autoscaler, str]] = None,
    calibration: Optional[FleetCalibrator] = None,
    workers: int = 1,
) -> FleetMetrics:
    """One-shot convenience wrapper: fresh fleet, one trace, metrics."""
    return FleetSimulator(
        replicas, router=router, schedule=schedule, cost_model=cost_model,
        compile_s=compile_s, specs=specs, strategy=strategy,
        autoscaler=autoscaler, calibration=calibration, workers=workers,
    ).run(trace)

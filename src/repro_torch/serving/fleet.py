"""Live fleet: N real engines behind the simulator's routing layer.

The serving half of the fleet story, on the SAME pump/router core the
simulator runs (``repro_torch.core.pump.PumpCore``): each replica is one
``PumpCore`` — the real ``DynamicSpaceTimeScheduler`` with the ripeness
calendar, feasibility admission, EDF drain and preemption — except its
clock is the WALL clock and its dispatched batches execute on a real
engine instead of a no-op. Routers (``repro_torch.sim.router``) are pure
functions of the pump signals (``queue_depth`` / ``backlog_s`` /
``estimate_item_s``), so round_robin / jsq / least_cost / affinity work
against real execution unchanged, and ``least_cost`` prices through
REAL measured dispatch seconds: the scheduler's ``on_dispatch`` tap
fires with ``t1 - t0`` around the actual kernel call (wall clocks make
``advance`` a no-op), feeding the same ``FleetCalibrator`` tables the
simulator fits from modeled costs.

Engine adapters, in decreasing realism:

* ``EngineReplica``  — one real ``MultiTenantEngine`` per replica;
  a dispatched cohort becomes ``InferenceRequest``s drained to
  completion, generated tokens on the host. N replicas sharing one card
  is the paper's space-multiplexing story told at the cluster layer.
* ``FakeEngine``     — deterministic token generation with no model:
  the parity suite exercises the full fleet path on any CPU.
* ``NullEngine``     — returns no results at all, exactly like the
  simulator's no-op kernels: with a ``VirtualClock`` factory this makes
  ``LiveFleet.run`` a bit-exact twin of ``FleetSimulator.run`` (the
  sim↔live parity contract — same routing decisions, same admission
  reason codes, same metrics bytes).

Determinism: with a virtual clock factory the fleet IS the simulator
(one shared core, no forked logic). On the wall clock, arrivals are
stamped with real time, so runs are *statistically* comparable but not
byte-stable: a live run is checked by its invariants, not its bytes.

This module never imports the engine: ``EngineReplica`` takes an
already-constructed one.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence, Union

from repro_torch.config import ScheduleConfig
from repro_torch.core.clock import Clock, WallClock
from repro_torch.core.pump import PumpCore, drain_fleet_tail, drain_merged
from repro_torch.launch.roofline import HardwareSpec
from repro_torch.obs.recorder import route_price_vector
from repro_torch.sim.costmodel import (
    ColdStartCostModel,
    FleetCalibrator,
    RooflineCostModel,
    resolve_spec,
)
from repro_torch.sim import fleet as sim_fleet
from repro_torch.sim.fleet import _arrival_stream, calibration_tap
from repro_torch.sim.metrics import FleetMetrics, MetricsAccumulator
from repro_torch.sim.router import Router, make_router
from repro_torch.sim.traces import Arrival, TenantSpec, Trace


class LiveWorkload:
    """Scheduler workload carrying a real payload and executor.

    Same protocol surface as the simulator's ``SimWorkload`` (the
    scheduler and pump read identical fields), plus the live extras:
    ``execute`` is bound per-instance to the routed replica's engine,
    ``payload`` carries the request body (e.g. prompt token ids),
    ``result`` receives this item's slice of the batch output, and
    ``done`` is an optional ``threading.Event`` the pump signals on
    completion — the HTTP front door blocks on it.
    """

    __slots__ = ("tenant_id", "bucket", "cost", "slo_s", "kind", "flops",
                 "bytes", "arrival_time", "completion_time", "est_s",
                 "execute", "payload", "result", "done")

    merge_family = None

    def __init__(self, spec, cost: float, execute=None, payload=None,
                 done=None):
        self.tenant_id = spec.tenant_id
        self.bucket = spec.bucket
        self.cost = cost
        self.slo_s = spec.slo_s
        self.kind = spec.kind
        self.flops = spec.flops
        self.bytes = spec.bytes
        self.arrival_time = 0.0
        self.completion_time = None
        self.est_s = 0.0
        self.execute = execute
        self.payload = payload
        self.result = None
        self.done = done


# ----------------------------------------------------------- engine adapters
class NullEngine:
    """No results at all — the exact live twin of the simulator's no-op
    kernels (``outs is None`` skips the scheduler's result zip), so a
    virtual-clocked ``LiveFleet`` reproduces ``FleetSimulator`` bytes."""

    name = "null"

    def __init__(self, replica_id: int = 0):
        self.replica_id = replica_id

    def execute(self, batch: List) -> None:
        return None


class FakeEngine:
    """Deterministic token generation without a model: each item's output is
    a pure function of its tenant and payload (splitmix64 over the prompt
    bytes), so tests can assert exact responses across replicas/routers."""

    name = "fake"

    def __init__(self, replica_id: int = 0, max_new_tokens: int = 8,
                 vocab: int = 32000):
        self.replica_id = replica_id
        self.max_new_tokens = int(max_new_tokens)
        self.vocab = int(vocab)

    @staticmethod
    def _mix(h: int) -> int:
        h = (h + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    def execute(self, batch: List) -> List[List[int]]:
        outs = []
        for w in batch:
            h = self._mix(int(w.tenant_id) + 1)
            for tok in (w.payload or ()):
                h = self._mix(h ^ int(tok))
            outs.append([(self._mix(h + k) % self.vocab)
                         for k in range(self.max_new_tokens)])
        return outs


class EngineReplica:
    """One real ``MultiTenantEngine`` as a fleet replica executor: a
    dispatched cohort becomes ``InferenceRequest``s submitted to the
    engine's own slot-based continuous batcher and drained to completion
    — the fleet's space-time scheduler decides WHEN and WHERE a cohort
    runs, the engine decides HOW it packs onto the card.

    ``execute`` returns only once the generated tokens are on the host
    (the engine's last step copies its sampled tokens off the card), so
    the scheduler's dispatch tap times the card's work, not the launch."""

    name = "torch"

    def __init__(self, engine, replica_id: int = 0, max_new_tokens: int = 8):
        self.engine = engine
        self.replica_id = replica_id
        self.max_new_tokens = int(max_new_tokens)

    def execute(self, batch: List) -> List[List[int]]:
        from repro_torch.serving.request import InferenceRequest

        engine = self.engine
        n_tenants = engine.cfg.num_tenants
        reqs = []
        for w in batch:
            payload = list(w.payload) if w.payload else [1]
            req = InferenceRequest(
                tenant_id=int(w.tenant_id) % n_tenants,
                prompt=payload,
                max_new_tokens=self.max_new_tokens,
                slo_s=float(w.slo_s) if w.slo_s else 0.1,
            )
            reqs.append(req)
            engine.submit(req)
        engine.run_until_drained()
        return [list(req.generated) for req in reqs]


def _signal_done(done: List) -> None:
    """Pump completion hook: resolve any per-request completion events."""
    for w in done:
        ev = getattr(w, "done", None)
        if ev is not None:
            ev.set()


class LiveFleet:
    """N engine-backed replicas of the real scheduler behind a router.

    The construction mirrors ``FleetSimulator`` knob for knob (shared
    ``cost_model`` XOR per-replica ``specs``; per-replica
    ``ColdStartCostModel`` wrap when ``compile_s > 0``; optional
    ``FleetCalibrator`` + flight recorder) so a live spec and its sim
    twin build the same pricing stack. Differences: replicas execute on
    real engines from ``engine_factory(replica_id)``, the clock is the
    wall by default (``clock_factory`` injects virtual time for the
    parity suite), and there is no autoscaler — live elasticity is a
    deployment concern (see the ROADMAP follow-on).
    """

    def __init__(
        self,
        replicas: int,
        engine_factory: Callable[[int], object],
        router: Union[Router, str] = "least_cost",
        schedule: Optional[ScheduleConfig] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        compile_s: float = 0.0,
        start_s: float = 0.0,
        specs: Optional[Sequence[Union[str, HardwareSpec]]] = None,
        strategy: str = "space_time",
        calibration: Optional[FleetCalibrator] = None,
        recorder=None,
        clock_factory: Optional[Callable[[float], Clock]] = None,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if specs is not None and cost_model is not None:
            raise ValueError(
                "pass per-replica specs OR a shared cost_model, not both")
        if specs is not None and not specs:
            raise ValueError("specs must be non-empty when given")
        self.router = make_router(router) if isinstance(router, str) else router
        self.schedule = schedule
        self.compile_s = float(compile_s)
        self.strategy = strategy
        self.specs = [resolve_spec(s) for s in specs] if specs else None
        self._shared_base = cost_model
        self.calibration = calibration
        self.recorder = recorder
        self.engine_factory = engine_factory
        self._clock_factory = clock_factory
        self.wall = clock_factory is None
        # wall mode: ONE shared clock — replicas live in the same real
        # time, so backlog_s's "clock ran ahead" residual is always zero
        # and the routing signal reduces to priced queue seconds
        self._wall_clock = WallClock() if self.wall else None
        self.start_s = (self._wall_clock.now() if self.wall
                        else float(start_s))

        self.pumps: List[PumpCore] = []
        self.active: List[PumpCore] = []
        self.engines: List = []
        self.routed_counts: List[int] = []
        self._fleet_acc = MetricsAccumulator()
        self._replica_accs: List[MetricsAccumulator] = []
        self._next_id = 0
        for _ in range(replicas):
            self._spawn(self.start_s)

    # -------------------------------------------------------- replica pool
    def _base_model(self, replica_id: int):
        if self.specs is not None:
            return RooflineCostModel(
                spec=self.specs[replica_id % len(self.specs)],
                strategy=self.strategy)
        return self._shared_base or RooflineCostModel()

    def _spawn(self, t_s: float) -> PumpCore:
        i = self._next_id
        self._next_id += 1
        base = self._base_model(i)
        clock = (self._wall_clock if self.wall
                 else self._clock_factory(t_s))
        model = base
        if self.compile_s > 0.0:
            model = ColdStartCostModel(base, compile_s=self.compile_s,
                                       clock=clock)
        pump = PumpCore(schedule=self.schedule, cost_model=model,
                        clock=clock, replica_id=i)
        pump.track_inflight = True  # routers read occupancy in fleet time
        pump.on_complete = _signal_done
        spec = getattr(base, "spec", None)
        if spec is not None:
            pump.spec_name = spec.name
            pump.speed_factor = spec.peak_flops / sim_fleet.BASE_SPEC.peak_flops
        if self.calibration is not None:
            pump.scheduler.on_dispatch = calibration_tap(
                self.calibration, model)
            pump.route_model = self.calibration.for_replica(i)
        if self.recorder is not None:
            # after calibration wiring: the recorder tap composes over it
            pump.attach_recorder(self.recorder.shard(i))
        self.engines.append(self.engine_factory(i))
        acc = MetricsAccumulator()
        pump.accs = [self._fleet_acc, acc]
        self.pumps.append(pump)
        self.active.append(pump)
        self.routed_counts.append(0)
        self._replica_accs.append(acc)
        return pump

    # ------------------------------------------------------------ event loop
    def now(self) -> float:
        return (self._wall_clock.now() if self.wall
                else max(p.clock.now() for p in self.pumps))

    def _drain_until(self, t_limit: float) -> None:
        drain_merged(self.active, t_limit)

    def submit_one(self, spec: TenantSpec, cost: float = 0.0,
                   payload=None, done=None,
                   t_s: Optional[float] = None):
        """Route and submit ONE arrival; the serving edge's unit of work.

        Returns ``(workload, replica_id, admitted, reason)`` — reason is
        the scheduler's admission code (0 admit, 1 oversubscribed,
        2 cap, 3 infeasible deadline).
        """
        if t_s is None:
            t_s = self._wall_clock.now() if self.wall else self.now()
        self._drain_until(t_s)
        idx = self.router.route(spec, self.active, t_s)
        pump = self.active[idx]
        if self.recorder is not None:
            # recompute the (idempotent) price vector the router just
            # read — recorded before submit so the decision context is
            # the pre-admission state it was actually made against
            rids, prices = route_price_vector(
                self.router, spec, self.active, t_s)
            self.recorder.record_route(t_s, spec.tenant_id, pump.replica_id,
                                       rids, prices)
        w = LiveWorkload(spec, cost,
                         execute=self.engines[pump.replica_id].execute,
                         payload=payload, done=done)
        w.est_s = pump.estimate_item_s(w)
        admitted = pump.submit(w, t_s)
        if admitted:
            self.routed_counts[pump.replica_id] += 1
        elif done is not None:
            done.set()  # rejected work never dispatches; unblock the caller
        return w, pump.replica_id, admitted, pump.scheduler.admit_reason

    def poll(self) -> int:
        """Pump every replica that has ripened by the current wall
        instant (the serving loop's heartbeat). Returns items completed.

        The clock read happens AFTER ``next_ripe_time``: that call clamps
        past instants to its own wall read, so comparing against an
        earlier timestamp would never fire (wall time is monotone) and
        ripened work would sit until the drain timeout force-flush."""
        n = 0
        for p in self.active:
            t = p.next_ripe_time()
            if t is not None and t <= self._wall_clock.now():
                n += len(p.pump_at(t))
        return n

    def next_ripe_time(self) -> Optional[float]:
        """Earliest instant any replica ripens (None = all queues dry)."""
        best = None
        for p in self.active:
            t = p.next_ripe_time()
            if t is not None and (best is None or t < best):
                best = t
        return best

    def run(self, trace: Union[Trace, Iterable[Arrival]],
            payload_fn: Optional[Callable[[TenantSpec], list]] = None
            ) -> FleetMetrics:
        """Replay a whole arrival trace through the fleet and freeze
        metrics.

        Virtual mode replays the trace's own timeline (the parity twin of
        ``FleetSimulator.run``); wall mode replays open-loop at full
        speed, stamping each arrival with REAL time — measuring what the
        fleet actually sustains rather than what the trace offered.
        """
        t_start = self.start_s
        for t_s, spec, cost in _arrival_stream(trace):
            if self.wall:
                t_s = self._wall_clock.now()
            payload = payload_fn(spec) if payload_fn is not None else None
            self.submit_one(spec, cost, payload=payload, t_s=t_s)
        if self.wall:
            self._drain_wall_tail()
        else:
            drain_fleet_tail(self.pumps, self._drain_until)
        return self.freeze(self.now() - t_start)

    def _drain_wall_tail(self, timeout_s: float = 30.0) -> None:
        """Wall-clock tail: sleep to each ripeness instant and pump, with
        a hard timeout after which the remainder is force-flushed (the
        slack-aware policies' shrinking windows always terminate, but a
        serving drain must bound its own exit)."""
        clock = self._wall_clock
        t_stop = clock.now() + timeout_s
        pumps = self.pumps
        while any(len(p.scheduler.queue) for p in pumps):
            if clock.now() >= t_stop:
                for p in pumps:
                    if len(p.scheduler.queue):
                        p._absorb(p.scheduler.flush())
                return
            t_next = self.next_ripe_time()
            if t_next is None:
                for p in pumps:
                    if len(p.scheduler.queue):
                        p._absorb(p.scheduler.flush())
                return
            now = clock.now()
            if t_next > now:
                time.sleep(min(t_next - now, 0.050))
            self.poll()

    # ------------------------------------------------------------- metrics
    def freeze(self, horizon_s: Optional[float] = None) -> FleetMetrics:
        """Freeze the fleet's accumulated metrics into ``FleetMetrics`` —
        same schema the fleet simulator emits, so live and sim reports
        diff cleanly."""
        pumps = self.pumps
        if horizon_s is None:
            dispatched = [p.clock.now() for p in pumps
                          if p.scheduler.stats.dispatches > 0]
            horizon_s = (max(dispatched) if dispatched
                         else self.start_s) - self.start_s
        stats = [p.scheduler.stats for p in pumps]
        merged = self._fleet_acc.freeze(
            sim_duration_s=horizon_s,
            busy_time_s=sum(s.busy_time_s for s in stats),
            dispatches=sum(s.dispatches for s in stats),
            rejected=sum(s.rejected for s in stats),
            evicted_tenants=sum(len(p.scheduler.evicted) for p in pumps),
            ripe_nudges=sum(s.ripe_nudges for s in stats),
            deadline_rejected=sum(s.deadline_rejected for s in stats),
            oversubscribed=sum(s.oversubscribed for s in stats),
            preemptions=sum(s.preemptions for s in stats),
        )
        per_replica = [p.freeze(acc, sim_duration_s=horizon_s)
                       for p, acc in zip(pumps, self._replica_accs)]
        if self.recorder is not None:
            self.recorder.router_name = self.router.name
        import numpy as np

        cold_t: List = []
        cold_f: List = []
        for p in pumps:
            m = p.cost_model
            if isinstance(m, ColdStartCostModel):
                cold_t.append(np.asarray(m.dispatch_times, np.float64))
                cold_f.append(np.asarray(m.dispatch_cold, np.int64))
        if cold_t:
            t = np.concatenate(cold_t)
            f = np.concatenate(cold_f)
            order = np.argsort(t, kind="stable")
            cold_times, cold_flags = t[order], f[order]
        else:
            cold_times = np.zeros(0, np.float64)
            cold_flags = np.zeros(0, np.int64)
        return FleetMetrics(
            merged=merged,
            per_replica=per_replica,
            routed_counts=list(self.routed_counts),
            router=self.router.name,
            cold_times=cold_times,
            cold_flags=cold_flags,
            scale_events=[],
            replica_specs=[p.spec_name for p in pumps],
            final_active=len(self.active),
        )

"""Discrete-event simulator over the real scheduling core.

NOT a model of the scheduler — the actual ``DynamicSpaceTimeScheduler``
(same queue, same batching policies, same admission control, same
straggler eviction) runs on a ``VirtualClock``, with a cost model pricing
each super-dispatch. Only the kernels are replaced: simulated workloads
carry a no-op executor, so a million-event policy sweep runs in seconds
on CPU with zero device work — and any policy conclusion transfers to the
live pump because it IS the live pump.

The event machinery lives in ``ReplicaPump`` (a ``VirtualClock`` binding
of ``repro_torch.core.pump.PumpCore``): one scheduler on one virtual clock plus
the ripeness-instant drain loop. The solo
``Simulator`` wraps exactly one pump; the fleet simulator
(``repro_torch.sim.fleet``) wraps N of them behind a router and merges their
ripeness instants into one global timeline — same pump, same event
semantics, so solo and fleet results are directly comparable.

Event ordering: between consecutive trace arrivals the loop advances the
virtual clock to each bucket's next ripeness instant and pumps there, so
batching-window dispatches happen at their exact modeled time rather than
being quantized to arrival times. Arrivals are stamped with their TRACE
time even when the (busy) virtual clock has run ahead — queueing delay
under overload is measured honestly.

Determinism: trace generation is seeded numpy, the clock is virtual, the
cost model is pure arithmetic — same seed in, byte-identical metrics JSON
out. That contract is what lets tests assert on simulated SLO orderings.

The drain machinery itself (ripeness calendar, EDF calendar, skip-pump
guard, routing signals) lives in the clock-agnostic ``PumpCore``
(``repro_torch.core.pump``) — shared verbatim with the live fleet
(``repro_torch.serving.fleet``), which runs it on a ``WallClock``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence

from repro_torch.config import ScheduleConfig
from repro_torch.core.clock import VirtualClock
from repro_torch.core.pump import PumpCore
from repro_torch.sim.costmodel import RooflineCostModel
from repro_torch.sim.metrics import MetricsAccumulator, SimMetrics
from repro_torch.sim.traces import Arrival, Trace

def _noop_execute(batch: List) -> None:
    # None signals "no per-item results" to the scheduler's dispatch loop,
    # which then skips the result-assignment zip entirely
    return None


class SimWorkload:
    """Minimal object satisfying the scheduler's Workload protocol.

    Deliberately not the ``Workload`` dataclass: a ``__slots__`` class with
    a no-op executor keeps per-event cost low enough for million-event
    traces (the dataclass's default-factory fields roughly double intake
    time at that scale). Fields that are never written per-instance
    (``merge_family``, ``result``, ``execute``) are class attributes — a
    few fewer stores on a constructor that runs once per simulated event.

    ``est_s`` is the router's estimated solo dispatch seconds for this
    item (0.0 outside fleet runs) — the pump subtracts it back out of its
    backlog estimate on completion.
    """

    __slots__ = ("tenant_id", "bucket", "cost", "slo_s", "kind", "flops",
                 "bytes", "arrival_time", "completion_time", "est_s")

    merge_family = None           # ragged merge is a live-kernel concern
    result = None
    execute = staticmethod(_noop_execute)

    def __init__(self, spec, cost: float):
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


class ReplicaPump(PumpCore):
    """One replica of the real scheduler on its own virtual clock, plus
    the ripeness-instant drain machinery — the unit both the solo
    ``Simulator`` and the fleet simulator are built from.

    A thin simulation binding of the clock-agnostic ``PumpCore``
    (``repro_torch.core.pump``): same calendar, same drain loop, same routing
    signals — this subclass only supplies the sim defaults (a
    ``VirtualClock`` starting at ``start_s`` and a roofline cost model).
    The live fleet (``repro_torch.serving.fleet``) runs the identical core on a
    ``WallClock``.
    """

    def __init__(
        self,
        schedule: Optional[ScheduleConfig] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        start_s: float = 0.0,
        clock: Optional[VirtualClock] = None,
        replica_id: Optional[int] = None,
    ):
        super().__init__(
            schedule=schedule,
            cost_model=cost_model or RooflineCostModel(),
            clock=clock if clock is not None else VirtualClock(start_s),
            replica_id=replica_id,
        )


class Simulator:
    """Drives the real scheduler over a trace on a virtual timeline."""

    def __init__(
        self,
        schedule: Optional[ScheduleConfig] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        start_s: float = 0.0,
        recorder=None,
    ):
        self.pump = ReplicaPump(schedule=schedule, cost_model=cost_model,
                                start_s=start_s)
        self.clock = self.pump.clock
        self.scheduler = self.pump.scheduler
        self._recorder = recorder

    def run(self, trace: Trace | Iterable[Arrival]) -> SimMetrics:
        pump = self.pump
        # attach lazily: callers may swap the cost model in
        # after construction, and the dispatch tap must capture the final
        # (cold-start-wrapped) model
        if self._recorder is not None and pump.recorder is None:
            pump.attach_recorder(self._recorder.shard(0))
        acc = MetricsAccumulator()
        pump.accs = [acc]
        t_start = pump.clock.now()

        # EDF stays on the per-event loop: its intake needs the real
        # scheduler.submit per event (feasibility pricing, min-update
        # calendar) — the chunked fast path's bypasses don't apply.
        if pump._use_calendar and pump._edf is None \
                and hasattr(trace, "iter_chunks"):
            self._run_chunked(trace)
        else:
            submit, drain_until = pump.submit, pump.drain_until
            for t_s, spec, cost in trace:
                drain_until(t_s)
                submit(SimWorkload(spec, cost), t_s)
        pump.drain_tail()

        return pump.freeze(acc, sim_duration_s=pump.clock.now() - t_start)

    def _run_chunked(self, trace: Trace) -> None:
        """Columnar intake: the same event sequence as the per-event loop
        (drain to each arrival, stamp, admit, pump) driven from numpy
        chunks with the per-event bookkeeping inlined.

        Two deviations from the naive loop, both unobservable:

        * the virtual clock is NOT advanced to arrivals that provably
          trigger no pump — the clock is only ever READ at pump instants
          and both paths advance to the same instants before pumping
          (``drain_tail`` entry re-syncs via one final ``advance_to``);
        * ``scheduler.submit`` is bypassed when no admission cap is set —
          its only effects then are the arrival stamp and the queue push,
          replicated here verbatim.
        """
        pump = self.pump
        clock = pump.clock
        sched = pump.scheduler
        queue = sched.queue
        drain_until = pump.drain_until
        sched_pump = sched.pump
        absorb = pump._absorb
        cal_note_push = pump._cal_note_push
        ripe_min = pump._ripe_min
        queue_push = queue.push
        inf = math.inf

        # any active admission control (pending cap OR feasibility pricing)
        # forces the real scheduler.submit path per event
        capped = (sched.schedule.max_pending_per_tenant is not None
                  or sched._feasibility)
        submit_slow = pump.submit
        # recorder hook hoisted out of the loop: recorder-off chunked
        # intake pays zero per-event cost for observability
        rec = pump.recorder
        rec_arr = rec.record_arrival if rec is not None else None

        cval = clock.now()            # tracks the real (virtual) clock
        m = ripe_min()
        if m is None:
            m = inf
        last_t = cval

        for times, idx, costs, table in trace.iter_chunks():
            # plain-Python lists iterate ~3x faster than numpy scalars,
            # and .tolist() round-trips float64 exactly
            ts = times.tolist()
            ws = [SimWorkload(table[i], c)
                  for i, c in zip(idx.tolist(), costs.tolist())]
            for k, t in enumerate(ts):
                if m < t and cval < t:
                    drain_until(t)
                    cval = clock.now()
                    m = ripe_min()
                    if m is None:
                        m = inf
                w = ws[k]
                if capped:
                    submit_slow(w, t)
                    cval = clock.now()
                    m = ripe_min()
                    if m is None:
                        m = inf
                    continue
                w.arrival_time = t
                depth = queue_push(w)
                if rec_arr is not None:
                    rec_arr(t, w.tenant_id, w.bucket, True)
                if depth >= pump._cap or depth == 1:
                    cal_note_push(w.bucket, t, depth)
                    v = pump._ripe_at[w.bucket]
                    if v < m:
                        m = v
                now_eff = cval if cval > t else t
                if m <= now_eff + (1e-9 + abs(now_eff) * 1e-12):
                    clock.advance_to(t)
                    done = sched_pump()
                    if done:
                        absorb(done)
                    cval = clock.now()
                    m = ripe_min()
                    if m is None:
                        m = inf
            if ts:
                last_t = ts[-1]

        # the per-event loop leaves the clock at max(last pump instant,
        # last arrival); drain_tail reads it — re-sync before returning
        clock.advance_to(last_t)


def simulate(
    trace: Trace | Iterable[Arrival],
    schedule: Optional[ScheduleConfig] = None,
    cost_model: Optional[Callable[[Sequence], float]] = None,
) -> SimMetrics:
    """One-shot convenience wrapper: fresh simulator, one trace, metrics."""
    return Simulator(schedule=schedule, cost_model=cost_model).run(trace)

"""Clock-agnostic replica pump: the drain machinery both executors share.

``PumpCore`` owns one ``DynamicSpaceTimeScheduler`` on an injected
``Clock`` plus the ripeness-instant drain loop — the unit the solo
simulator, the fleet simulator, and the live fleet are all built from.
The core never imports ``repro_torch.sim``: the simulator subclasses it with a
``VirtualClock`` and a roofline default (``repro_torch.sim.simulator
.ReplicaPump``), while the live fleet (``repro_torch.serving.fleet``) runs the
same class on a ``WallClock``, where ``advance_to`` is a no-op and the
calendar instants are compared against real elapsed time.

That single-core property is the point of the refactor: the ripeness
calendar, the EDF min-update calendar, the skip-pump ULP guard, the
routing signals (``queue_depth`` / ``backlog_s`` / ``estimate_item_s``)
and the recorder taps exist ONCE. A policy conclusion from the simulator
transfers to live serving because it literally is the same pump — only
the clock and the kernels differ.

Performance: ripeness is tracked two ways. Policies declaring
``stable_window`` (the fixed window) get a *calendar*: a lazy-deletion
heap of per-bucket ripeness instants maintained incrementally on submit
and dispatch, making ``next_ripe_time`` O(1) amortized instead of a scan
over every pending bucket per event. Time-dependent policies
(slo_adaptive) keep the legacy scan — their instants drift with the
clock, so cached instants would be stale the moment they were stored.
Both paths compute ripeness with the exact same float expression
(``max(now, oldest + window)``), so the dispatch timeline is
bit-identical between them.
"""

from __future__ import annotations

from collections import deque
from heapq import heappop, heappush
from typing import Callable, List, Optional, Sequence

from repro_torch.config import ScheduleConfig
from repro_torch.core.clock import Clock, WallClock
from repro_torch.core.scheduler import DynamicSpaceTimeScheduler

_NEG_INF = float("-inf")


class PumpCore:
    """One replica of the real scheduler on an injected clock, plus the
    ripeness-instant drain machinery.

    Metric sinks (``accs``) are duck-typed: anything with
    ``add_batch(done)`` — the simulator wires ``MetricsAccumulator``s in.
    ``on_complete`` is the live-serving hook: called with each absorbed
    completion batch so a server can resolve per-request futures without
    the sim paths paying more than one is-None test per dispatch.
    """

    # 1 nanosecond — larger than any float rounding error at realistic
    # trace horizons, negligible against microsecond dispatches
    _RIPE_EPS = 1e-9

    def __init__(
        self,
        schedule: Optional[ScheduleConfig] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        clock: Optional[Clock] = None,
        replica_id: Optional[int] = None,
    ):
        self.replica_id = replica_id
        self.clock = clock if clock is not None else WallClock()
        self.cost_model = cost_model
        self.scheduler = DynamicSpaceTimeScheduler(
            schedule or ScheduleConfig(),
            clock=self.clock,
            cost_model=self.cost_model,
            replica_id=replica_id,
        )
        # completions are consumed by the accumulators, not the monitor;
        # per-item history lists would leak a float per event
        self.scheduler.monitor.record_history = False
        # metric sinks every completion is recorded into (solo: one; fleet:
        # the replica's own + the fleet-wide accumulator)
        self.accs: List = []
        # live-serving hook: called with each absorbed completion batch
        self.on_complete: Optional[Callable[[List], None]] = None
        # fleet-only: hardware label for per-replica summaries (hetero
        # fleets), relative chip speed (weighted-affinity routing signal),
        # and an optional ROUTING-time pricing model (per-replica
        # calibrated table) — the true cost_model still drives the clock
        self.spec_name: Optional[str] = None
        self.speed_factor: float = 1.0
        self.route_model: Optional[Callable[[Sequence], float]] = None
        # router's running backlog estimate: Σ est_s of pending items
        self.pending_est_s = 0.0
        # fleet-only (set by the fleet executors): completion instants of
        # dispatched items, so queue_depth(now) can count work that is
        # modeled as done on this replica's (ahead) clock but still in
        # flight at the fleet's current instant. Off in solo runs — a
        # million-event trace must not accumulate a million floats.
        self.track_inflight = False
        self._inflight: deque = deque()
        # flight-recorder shard (repro_torch.obs); None = recording off, and the
        # hot paths pay exactly one is-None test per arrival
        self.recorder = None
        # ---- ripeness calendar (stable-window policies only) ----
        # _ripe_at maps bucket -> its current ripeness instant
        # (oldest_arrival + window; -inf for cap-full buckets, matching
        # the legacy scan's "full bucket is ripe NOW" via max(now, -inf)).
        # _heap holds (instant, seq, bucket) with lazy deletion: an entry
        # is live iff it equals _ripe_at[bucket]; stale entries are
        # skipped at peek time. seq breaks instant ties without ever
        # comparing bucket keys (buckets aren't orderable).
        policy = self.scheduler.policy
        # deadline-aware (EDF) policies fix each ITEM's ripeness instant at
        # arrival — same incremental calendar, but a push can LOWER a
        # bucket's instant (a tight-SLO item ripens before older relaxed
        # peers), so EDF gets its own note functions below.
        self._edf = policy if getattr(policy, "deadline_aware", False) else None
        self._use_calendar = (
            bool(getattr(policy, "stable_window", False)) or self._edf is not None
        )
        self._window = (
            policy.window_s((), 0.0)
            if self._use_calendar and self._edf is None else 0.0
        )
        self._cap = self.scheduler.schedule.max_superkernel_size
        # preemption can force-dispatch BEFORE any calendar instant, so the
        # skip-pump-at-submit shortcut must stay off — at-risk buckets are
        # caught by pumping at every arrival.
        self._preempt_pump = self.scheduler.schedule.preemption
        self._ripe_at: dict = {}
        self._heap: list = []
        self._seq = 0

    # ------------------------------------------------------------- intake
    def submit(self, w, t_s: float) -> bool:
        """Advance to the arrival instant, admit, and pump immediately.

        The TRUE arrival time is stamped even when this replica's (busy)
        clock has run ahead — queueing delay under overload stays honest.
        (On a wall clock ``advance_to`` is a no-op: real time already is
        the arrival instant.)
        """
        self.clock.advance_to(t_s)
        admitted = self.scheduler.submit(w, now=t_s)
        rec = self.recorder
        if rec is not None:
            rec.record_arrival(t_s, w.tenant_id, w.bucket, admitted,
                               self.scheduler.admit_reason)
        if admitted:
            self.pending_est_s += w.est_s
            if self._use_calendar:
                b = w.bucket
                if self._edf is not None:
                    self._edf_note_push(
                        b, w, len(self.scheduler.queue._buckets[b]))
                else:
                    self._cal_note_push(
                        b, t_s, len(self.scheduler.queue._buckets[b]))
        # pump even when admission rejected: advancing to t_s may have
        # ripened other buckets (drain_until only covers instants < t_s)
        if self._use_calendar and not self._preempt_pump:
            # with the calendar we know the earliest ripeness instant
            # without scanning; skip the (previously unconditional) pump
            # when nothing can possibly be ripe. The guard is a few ULPs
            # wide: the legacy ripeness test computes (now - oldest) >=
            # window while the calendar stores oldest + window — not
            # bit-equivalent at the boundary — and a spuriously attempted
            # pump is a harmless no-op while a skipped-but-due pump would
            # change the timeline.
            m = self._ripe_min()
            now = self.clock.now()
            if m is None or m > now + (1e-9 + abs(now) * 1e-12):
                return admitted
        self._absorb(self.scheduler.pump())
        return admitted

    # ---------------------------------------------------------- event loop
    def _cal_note_push(self, bucket, arrival_s: float, depth: int) -> None:
        """Calendar maintenance after one item lands in ``bucket``."""
        ripe_at = self._ripe_at
        if depth >= self._cap:
            if ripe_at.get(bucket) != _NEG_INF:
                ripe_at[bucket] = _NEG_INF
                self._seq += 1
                heappush(self._heap, (_NEG_INF, self._seq, bucket))
        elif depth == 1:
            # bucket just went empty -> nonempty: its instant is fixed
            # (stable window) at oldest + window
            t = arrival_s + self._window
            ripe_at[bucket] = t
            self._seq += 1
            heappush(self._heap, (t, self._seq, bucket))
        # depths in between leave the instant untouched: the oldest
        # arrival didn't change, so neither did the ripeness instant

    def _cal_note_dispatch(self, done: List) -> None:
        """Recompute the instants of every bucket a pump touched."""
        queue = self.scheduler.queue
        buckets_map = queue._buckets
        ripe_at = self._ripe_at
        window = self._window
        cap = self._cap
        for b in {w.bucket for w in done}:
            q = buckets_map.get(b)
            if not q:
                ripe_at.pop(b, None)   # heap entries die lazily
            elif len(q) >= cap:
                if ripe_at.get(b) != _NEG_INF:
                    ripe_at[b] = _NEG_INF
                    self._seq += 1
                    heappush(self._heap, (_NEG_INF, self._seq, b))
            else:
                t = q[0].arrival_time + window
                if ripe_at.get(b) != t:
                    ripe_at[b] = t
                    self._seq += 1
                    heappush(self._heap, (t, self._seq, b))

    def _edf_note_push(self, bucket, w, depth: int) -> None:
        """EDF calendar maintenance after ``w`` lands in ``bucket``: the
        bucket's instant is the min of its items' fixed ripe_at instants,
        so any push may lower it (min-update, unlike the fixed window
        where only the first item sets it)."""
        ripe_at = self._ripe_at
        if depth >= self._cap:
            if ripe_at.get(bucket) != _NEG_INF:
                ripe_at[bucket] = _NEG_INF
                self._seq += 1
                heappush(self._heap, (_NEG_INF, self._seq, bucket))
            return
        t = self._edf.ripe_at(w)
        cur = ripe_at.get(bucket)
        if cur is None or t < cur:
            ripe_at[bucket] = t
            self._seq += 1
            heappush(self._heap, (t, self._seq, bucket))

    def _edf_note_dispatch(self, done: List) -> None:
        """Recompute EDF instants of every bucket a pump touched."""
        queue = self.scheduler.queue
        buckets_map = queue._buckets
        ripe_at = self._ripe_at
        cap = self._cap
        edf = self._edf
        for b in {w.bucket for w in done}:
            q = buckets_map.get(b)
            if not q:
                ripe_at.pop(b, None)   # heap entries die lazily
            elif len(q) >= cap:
                if ripe_at.get(b) != _NEG_INF:
                    ripe_at[b] = _NEG_INF
                    self._seq += 1
                    heappush(self._heap, (_NEG_INF, self._seq, b))
            else:
                t = min(edf.ripe_at(w) for w in q)
                if ripe_at.get(b) != t:
                    ripe_at[b] = t
                    self._seq += 1
                    heappush(self._heap, (t, self._seq, b))

    def _ripe_min(self) -> Optional[float]:
        """Earliest live calendar instant (lazy-deleting stale entries)."""
        heap = self._heap
        ripe_at = self._ripe_at
        while heap:
            t, _, b = heap[0]
            if ripe_at.get(b) == t:
                return t
            heappop(heap)
        return None

    def next_ripe_time(self) -> Optional[float]:
        """Earliest instant any bucket becomes dispatchable.

        For slack-aware policies the window shrinks as time passes, so
        ``oldest + window(now)`` is an upper bound on the true ripeness
        instant — pumping there is guaranteed to dispatch (the estimate
        errs at most by how much the window shrank in between), which
        keeps the drain loop strictly progressing.
        """
        if self._use_calendar:
            m = self._ripe_min()
            if m is None:
                return None
            now = self.clock.now()
            return m if m > now else now
        sched = self.scheduler
        now = self.clock.now()
        queue, policy = sched.queue, sched.policy
        cap = sched.schedule.max_superkernel_size
        best = None
        for bucket, count in queue.buckets():
            if count >= cap:
                return now
            oldest = queue.oldest_arrival(bucket)
            pending = queue.peek(bucket) if policy.needs_pending else ()
            t = max(now, oldest + policy.window_s(pending, now))
            if best is None or t < best:
                best = t
        return best

    def pump_at(self, t_ripe: float) -> List:
        """Advance to a ripeness instant and pump; nudge one epsilon past
        it if float rounding left the window a ULP short of elapsed."""
        self.clock.advance_to(t_ripe)
        done = self.scheduler.pump()
        if not done:
            self.scheduler.stats.ripe_nudges += 1
            self.clock.advance_to(t_ripe + self._RIPE_EPS)
            done = self.scheduler.pump()
        self._absorb(done)
        return done

    def poll(self) -> List:
        """Pump at the clock's CURRENT instant and absorb whatever ripened
        — the live serving loop's heartbeat, where wall time advances on
        its own and there is nothing to advance_to."""
        done = self.scheduler.pump()
        if done:
            self._absorb(done)
        return done

    def drain_until(self, t_limit: float) -> None:
        """Pump every bucket that ripens strictly before ``t_limit``."""
        while True:
            t_ripe = self.next_ripe_time()
            if t_ripe is None or t_ripe >= t_limit:
                return
            if not self.pump_at(t_ripe):
                return  # estimate failed to ripen anything; arrivals resume

    def drain_tail(self) -> None:
        """Drain at exact ripeness instants, then force-flush the rest."""
        sched = self.scheduler
        while len(sched.queue):
            t_ripe = self.next_ripe_time()
            if t_ripe is None or not self.pump_at(t_ripe):
                self._absorb(sched.flush())
                break

    def _absorb(self, done: List) -> None:
        if not done:
            return
        if self._use_calendar:
            if self._edf is not None:
                self._edf_note_dispatch(done)
            else:
                self._cal_note_dispatch(done)
        if self.track_inflight:
            # sequential -= preserves the exact float accumulation order
            # the routing-signal contract (backlog_s) was baselined with
            pending = self.pending_est_s
            inflight_append = self._inflight.append
            for w in done:
                pending -= w.est_s
                inflight_append(w.completion_time)
            self.pending_est_s = pending if pending > 0.0 else 0.0
        for acc in self.accs:
            acc.add_batch(done)
        if self.on_complete is not None:
            self.on_complete(done)

    # ------------------------------------------------------ routing signals
    def queue_depth(self, now: Optional[float] = None) -> int:
        """Occupancy as a router sees it: items pending in the queue plus
        items whose modeled completion lies beyond the fleet's current
        instant (this replica's clock ran ahead; the work is still in
        flight in fleet time even though this replica already priced it).
        Without ``now`` (or in-flight tracking off) it is just the queue.
        """
        depth = len(self.scheduler.queue)
        if now is None or not self.track_inflight:
            return depth
        inflight = self._inflight
        while inflight and inflight[0] <= now:
            inflight.popleft()
        return depth + len(inflight)

    def backlog_s(self, now: float) -> float:
        """Estimated seconds until this replica would run dry: residual
        busy time (its clock ahead of global ``now``) plus the estimated
        cost of everything still queued."""
        return max(0.0, self.clock.now() - now) + self.pending_est_s

    def estimate_item_s(self, w) -> float:
        """Estimated seconds this item adds to THIS replica.

        If the item's bucket already has pending items here it rides the
        forming super-kernel — marginal roofline cost only, compile shared
        with the batch. Otherwise it opens a fresh dispatch: full solo
        cost, plus the compile term when this replica's cache is cold for
        the bucket (the warm-affinity signal).

        When a ``route_model`` is attached (fleet calibration: this
        replica's measured-cost table), routing prices through IT instead
        of the true model — the convergence loop that turns wrong priors
        into measured per-replica costs."""
        model = self.route_model if self.route_model is not None \
            else self.cost_model
        if self.scheduler.queue.head(w.bucket) is not None:
            item_s = getattr(model, "item_s", None)
            if item_s is not None:
                return item_s(w)
        estimate = getattr(model, "estimate", None)
        if estimate is not None:
            return estimate((w,))
        return model((w,))

    # -------------------------------------------------------- observability
    def attach_recorder(self, shard) -> None:
        """Record this replica's events into a flight-recorder shard:
        arrivals via ``submit`` (and the chunked intake), dispatch spans
        via an ``on_dispatch`` tap composed OVER any existing tap
        (calibration keeps working underneath). Must run after the final
        cost model is in place — the tap captures its ``dispatch_cold``
        array for cold/warm labeling."""
        from repro_torch.obs.recorder import dispatch_tap

        self.recorder = shard
        # the scheduler emits preemption decisions directly (they happen
        # inside its EDF pump, not at the pump boundary)
        self.scheduler.recorder = shard
        shard.spec_name = self.spec_name
        model = self.cost_model
        base = getattr(model, "base", model)
        shard.strategy = getattr(base, "strategy", None) or getattr(
            getattr(base, "prior", None), "strategy", None)
        self.scheduler.on_dispatch = dispatch_tap(
            shard, model=model, prev=self.scheduler.on_dispatch)

    def freeze(self, acc, sim_duration_s: float):
        """Freeze one accumulator against this replica's scheduler stats."""
        sched = self.scheduler
        return acc.freeze(
            sim_duration_s=sim_duration_s,
            busy_time_s=sched.stats.busy_time_s,
            dispatches=sched.stats.dispatches,
            rejected=sched.stats.rejected,
            evicted_tenants=len(sched.evicted),
            ripe_nudges=sched.stats.ripe_nudges,
            deadline_rejected=sched.stats.deadline_rejected,
            oversubscribed=sched.stats.oversubscribed,
            preemptions=sched.stats.preemptions,
        )


def drain_merged(pumps: Sequence[PumpCore], t_limit: float) -> None:
    """Merged global timeline across replicas: pump whichever replica
    ripens earliest, repeatedly, until no replica ripens before
    ``t_limit``.

    A replica whose ripeness estimate fails to dispatch (slack-aware
    window shrank underneath it) is stalled until the next arrival —
    the same per-replica semantics as the solo drain loop, without
    letting one stalled replica block the others.
    """
    stalled = 0  # bitmask — replica counts are small
    while True:
        best_i, best_t = -1, t_limit
        for i, p in enumerate(pumps):
            if stalled & (1 << i):
                continue
            t = p.next_ripe_time()
            if t is not None and t < best_t:
                best_i, best_t = i, t
        if best_i < 0:
            return
        if not pumps[best_i].pump_at(best_t):
            stalled |= 1 << best_i


def drain_fleet_tail(pumps: Sequence[PumpCore],
                     drain_until: Callable[[float], None]) -> None:
    """Fleet tail drain: keep merging ripeness instants until every queue
    is dry, then force-flush whatever the estimates could not ripen."""
    while any(len(p.scheduler.queue) for p in pumps):
        before = sum(len(p.scheduler.queue) for p in pumps)
        drain_until(float("inf"))
        if sum(len(p.scheduler.queue) for p in pumps) == before:
            for p in pumps:
                if len(p.scheduler.queue):
                    p._absorb(p.scheduler.flush())
            break

"""DynamicSpaceTimeScheduler — the unified space-time execution core (port).

Queries arrive stochastically, so super-kernels cannot be precomputed
ahead-of-time. The scheduler operates on the generic ``Workload``
protocol (see ``core.workload``) — kernel-level GEMMs and request-level
prefill/decode cohorts flow through the SAME policy core:

  1. ``submit`` stamps arrivals with the injected ``Clock`` and applies
     admission control (per-tenant pending caps);
  2. a pluggable ``BatchingPolicy`` decides when each shape bucket is
     ripe — the fixed window of the paper, or an SLO-adaptive window
     that shrinks as a tenant's slack to its deadline shrinks;
  3. ``pump`` dispatches each ripe bucket as ONE super-dispatch: items
     carrying an ``execute`` callback run it over the merged batch;
     bare GEMM problems route through the super-kernel cache
     (``SuperKernelCache``), bounded by ``max_superkernel_size``;
  4. per-tenant latency is recorded against the same clock, stragglers
     are detected and evicted (``LatencyMonitor`` + caller hook).

The pump is synchronous and host-driven — the paper's scheduler is also a
software scheduler above the accelerator. All policy decisions read time
only through ``self.clock`` (no hidden ``time.perf_counter()``), so a
``VirtualClock`` plus a ``cost_model`` turns the pump into a fully
deterministic simulator: the property-based tests and the Fig-4
fixed-vs-adaptive comparison both rely on that.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Hashable, List, Optional, Sequence

from repro_torch.config import ScheduleConfig
from repro_torch.core.clock import Clock, WallClock
from repro_torch.core.policy import BatchingPolicy, make_policy
from repro_torch.core.queue import WorkQueue
from repro_torch.core.slo import LatencyMonitor
from repro_torch.core.superkernel import SuperKernelCache


@dataclasses.dataclass
class SchedulerStats:
    dispatches: int = 0
    problems_completed: int = 0
    total_cost: float = 0.0
    busy_time_s: float = 0.0
    rejected: int = 0
    # times a simulated pump found nothing ripe at a computed ripeness
    # instant and had to re-pump one epsilon later (float rounding left
    # the window a ULP short of elapsed) — drift that used to be silent
    ripe_nudges: int = 0
    # feasibility admission: rejects because the priced completion missed
    # the deadline beyond the oversubscription allowance (subset of
    # ``rejected``), and admits that landed past the deadline but inside it
    deadline_rejected: int = 0
    oversubscribed: int = 0
    # unripe buckets force-dispatched ahead of their window because
    # waiting would have missed their deadline
    preemptions: int = 0

    @property
    def total_flops(self) -> float:
        """Alias: for GEMM workloads ``cost`` is exactly FLOPs."""
        return self.total_cost

    @property
    def achieved_tflops(self) -> float:
        if self.busy_time_s == 0.0:
            return 0.0
        return self.total_cost / self.busy_time_s / 1e12


class DynamicSpaceTimeScheduler:
    def __init__(
        self,
        schedule: Optional[ScheduleConfig] = None,
        on_evict: Optional[Callable[[int], None]] = None,
        clock: Optional[Clock] = None,
        policy: Optional[BatchingPolicy] = None,
        cost_model: Optional[Callable[[Sequence], float]] = None,
        on_dispatch: Optional[Callable[[List, float, Optional[int]], None]] = None,
        replica_id: Optional[int] = None,
    ):
        self.schedule = schedule or ScheduleConfig()
        self.clock = clock or WallClock()
        self.policy = policy or make_policy(self.schedule)
        # Maps a dispatched batch to modeled seconds; a VirtualClock then
        # advances by it, making completion times deterministic.
        self.cost_model = cost_model
        # Called with (batch, elapsed_s, replica_id) after every
        # super-dispatch — the calibration tap a CalibratedCostModel
        # (repro.sim.costmodel) learns per-(bucket, pow2-R) dispatch costs
        # through. ``replica_id`` identifies which fleet replica dispatched
        # (None for a solo scheduler), so fleet-wide calibration can keep
        # per-replica tables apart.
        self.on_dispatch = on_dispatch
        self.replica_id = replica_id
        self.queue = WorkQueue()
        self.cache = SuperKernelCache(self.schedule)
        self.monitor = LatencyMonitor(
            self.schedule.latency_ewma_alpha,
            self.schedule.straggler_eviction_ratio,
        )
        self.stats = SchedulerStats()
        self.on_evict = on_evict
        self.evicted: List[int] = []
        # without an admission cap the per-tenant counters are never read;
        # skipping them saves a defaultdict update per submitted workload
        self.queue._track_tenants = self.schedule.max_pending_per_tenant is not None
        # feasibility admission: earliest instant all admitted-but-
        # unfinished work can complete, advanced O(1) per admit and
        # naturally overtaken by the clock as dispatches drain it.
        self._feasibility = self.schedule.admission_policy == "feasibility"
        if self._feasibility and self.cost_model is None:
            raise ValueError(
                "admission_policy='feasibility' needs a cost_model to price "
                "candidate completions"
            )
        self._committed_s = 0.0
        self._edf_mode = bool(getattr(self.policy, "deadline_aware", False))
        # per-tenant preemption debt: seconds of ahead-of-window dispatch
        # each tenant has charged against preemption_budget_s
        self._preempt_debt: Dict[int, float] = {}
        # why the last submit admitted/rejected (recorder reason codes:
        # 0 admit, 1 oversubscribed admit, 2 cap reject, 3 infeasible
        # reject); a flight-recorder shard, when attached, reads this.
        self.admit_reason = 0
        self.recorder = None

    # ---------------------------------------------------------------- intake
    def submit(self, item, now: Optional[float] = None) -> bool:
        """Admit one workload; returns False if admission control rejects.

        ``item`` is anything satisfying the Workload protocol (a
        ``Workload``, a ``GemmProblem``, ...).
        """
        cap = self.schedule.max_pending_per_tenant
        if cap is not None and self.queue.pending_for_tenant(item.tenant_id) >= cap:
            self.stats.rejected += 1
            self.admit_reason = 2
            return False
        t = now if now is not None else self.clock.now()
        if self._feasibility:
            est = self._estimate_item_s(item)
            start = self._committed_s
            clk = self.clock.now()
            if clk > start:
                start = clk
            if t > start:
                start = t
            predicted = start + est
            deadline = t + item.slo_s
            if predicted > deadline + (self.schedule.oversubscription - 1.0) * item.slo_s:
                self.stats.rejected += 1
                self.stats.deadline_rejected += 1
                self.admit_reason = 3
                return False
            self._committed_s = predicted
            if predicted > deadline:
                self.stats.oversubscribed += 1
                self.admit_reason = 1
            else:
                self.admit_reason = 0
        else:
            self.admit_reason = 0
        item.arrival_time = t
        self.queue.push(item)
        return True

    def _estimate_item_s(self, item) -> float:
        """Price one item's marginal service time WITHOUT side effects.

        Prefers the cost model's ``item_s`` marginal (roofline/calibrated),
        then a non-mutating ``estimate``; falls back to calling the model on
        a singleton batch. Never used on models whose ``__call__`` mutates
        (ColdStartCostModel exposes both safe entry points).
        """
        cm = self.cost_model
        fn = getattr(cm, "item_s", None)
        if fn is not None:
            return fn(item)
        fn = getattr(cm, "estimate", None)
        if fn is not None:
            return fn((item,))
        return cm((item,))

    # ---------------------------------------------------------------- dispatch
    def _ripe(self, bucket: Hashable, count: int, now: float) -> bool:
        if count >= self.schedule.max_superkernel_size:
            return True
        oldest = self.queue.oldest_arrival(bucket)
        if oldest is None:
            return False
        # only slack-aware policies need the full pending list (O(n));
        # the fixed window stays O(1) per bucket per tick.
        pending = self.queue.peek(bucket) if self.policy.needs_pending else ()
        return (now - oldest) >= self.policy.window_s(pending, now)

    def pump(self, now: Optional[float] = None, force: bool = False) -> List:
        """Dispatch every ripe bucket; returns completed workloads.

        With ``allow_ragged_merge`` (beyond-paper, MAGMA-vbatched
        analogue), ripe buckets sharing a non-None ``merge_family`` are
        merged into ONE grouped super-kernel instead of one uniform
        super-kernel per exact shape.
        """
        now = now if now is not None else self.clock.now()
        if self._edf_mode and not force:
            return self._pump_edf(now)
        completed: List = []

        if self.schedule.allow_ragged_merge:
            families: Dict[Hashable, List] = {}
            for bucket, count in self.queue.buckets():
                if not force and not self._ripe(bucket, count, now):
                    continue
                fam = getattr(self.queue.head(bucket), "merge_family", None)
                # items without a family only merge within their own bucket
                key = fam if fam is not None else ("__solo__", bucket)
                families.setdefault(key, []).append(bucket)
            for fam_buckets in families.values():
                while True:  # families over the size cap drain fully too
                    batch: List = []
                    for b in fam_buckets:
                        batch.extend(
                            self.queue.pop_batch(
                                b, self.schedule.max_superkernel_size - len(batch)
                            )
                        )
                        if len(batch) >= self.schedule.max_superkernel_size:
                            break
                    if not batch:
                        break
                    ragged = len({p.x.shape[0] for p in batch if hasattr(p, "x")}) > 1
                    completed.extend(self._dispatch(batch, ragged=ragged))
                    if len(batch) < self.schedule.max_superkernel_size:
                        break
            return completed

        for bucket, count in self.queue.buckets():
            if not force and not self._ripe(bucket, count, now):
                continue
            while True:
                batch = self.queue.pop_batch(bucket, self.schedule.max_superkernel_size)
                if not batch:
                    break
                completed.extend(self._dispatch(batch))
                if len(batch) < self.schedule.max_superkernel_size:
                    break
        return completed

    def _pump_edf(self, now: float) -> List:
        """Drain ripe buckets earliest-deadline-first; with preemption on,
        force-dispatch an unripe bucket whose deadline cannot survive its
        remaining window, merged into the same deadline order.

        Preemption is bounded interference: each force-dispatch charges its
        priced service time against the tenant's ``preemption_budget_s``
        debt, so one tight-deadline tenant cannot starve ripe cohorts
        indefinitely. Every preemption is emitted through the flight
        recorder (when attached) with the number of ripe victim cohorts it
        jumped ahead of.
        """
        policy = self.policy
        cap = self.schedule.max_superkernel_size
        preempt = self.schedule.preemption
        budget = self.schedule.preemption_budget_s
        # (deadline, phase, scan_order, bucket, est_s, tenant) — phase 0 is
        # a ripe bucket, phase 1 a preempting (unripe, at-risk) one; the
        # sort keys on the deadline first, scan order breaks ties so equal
        # deadlines stay deterministic across reruns.
        ready = []
        order = 0
        for bucket, count in self.queue.buckets():
            pending = self.queue.peek(bucket)
            if not pending:
                continue
            order += 1
            dl = min(it.arrival_time + it.slo_s for it in pending)
            # same float expression the simulator's calendar stores, so a
            # pump at a calendar instant finds the bucket ripe exactly
            ripe_at = min(policy.ripe_at(it) for it in pending)
            if count >= cap or now >= ripe_at:
                ready.append((dl, 0, order, bucket, 0.0, -1))
            elif preempt and self.cost_model is not None:
                est = self._estimate_item_s(pending[0])
                tid = pending[0].tenant_id
                # at risk: waiting out the window misses the deadline, but
                # dispatching now still makes it — and the tenant has debt
                # budget left to pay for jumping the queue.
                if (
                    ripe_at + est > dl
                    and now + est <= dl
                    and self._preempt_debt.get(tid, 0.0) + est <= budget
                ):
                    ready.append((dl, 1, order, bucket, est, tid))
        if not ready:
            return []
        ready.sort()
        completed: List = []
        for dl, phase, _order, bucket, est, tid in ready:
            if phase == 1:
                victims = sum(1 for r in ready if r[1] == 0 and (r[0], r[1], r[2]) > (dl, 1, _order))
                self._preempt_debt[tid] = self._preempt_debt.get(tid, 0.0) + est
                self.stats.preemptions += 1
                if self.recorder is not None:
                    self.recorder.record_preempt(now, tid, bucket, est, victims)
            while True:
                batch = self.queue.pop_batch(bucket, cap)
                if not batch:
                    break
                completed.extend(self._dispatch(batch))
                if len(batch) < cap:
                    break
        return completed

    def flush(self) -> List:
        """Force-dispatch everything pending (end-of-step/benchmark drain)."""
        return self.pump(force=True)

    def _execute(self, batch: List, ragged: bool) -> List:
        """One super-dispatch: callback workloads run their own merged
        executor; bare GEMMs route through the super-kernel cache."""
        execute = getattr(batch[0], "execute", None)
        if execute is not None:
            return execute(batch)
        if ragged:
            return self.cache.execute_ragged(batch)
        return self.cache.execute(batch)

    def _dispatch(self, batch: List, ragged: bool = False) -> List:
        t0 = self.clock.now()
        outs = self._execute(batch, ragged)
        if self.cost_model is not None:
            self.clock.advance(self.cost_model(batch))
        t1 = self.clock.now()

        stats = self.stats
        stats.dispatches += 1
        stats.problems_completed += len(batch)
        stats.total_cost += sum([float(getattr(p, "cost", 0.0)) for p in batch])
        stats.busy_time_s += t1 - t0

        if outs is None:
            # executor contract: None means "no per-item results" (the
            # simulator's no-op path) — skip the result zip entirely
            for p in batch:
                p.completion_time = t1
        else:
            for p, out in zip(batch, outs):
                p.result = out
                p.completion_time = t1
        # tap fires after completion stamping so observers can read
        # batch[*].completion_time (== t1) as the dispatch-end instant
        if self.on_dispatch is not None:
            self.on_dispatch(batch, t1 - t0, self.replica_id)
        self.monitor.record_batch(batch, t1)

        self._evict_stragglers()
        return batch

    # ---------------------------------------------------------------- isolation
    def _evict_stragglers(self) -> None:
        for tid in self.monitor.stragglers():
            if tid in self.evicted:
                continue
            self.evicted.append(tid)
            if self.on_evict is not None:
                self.on_evict(tid)

    # ---------------------------------------------------------------- reporting
    def report(self) -> Dict[str, float]:
        rep = {
            "dispatches": float(self.stats.dispatches),
            "problems": float(self.stats.problems_completed),
            "rejected": float(self.stats.rejected),
            "achieved_tflops": self.stats.achieved_tflops,
            "cache_hit_rate": self.cache.stats.hit_rate,
            "evicted_tenants": float(len(self.evicted)),
            "ripe_nudges": float(self.stats.ripe_nudges),
            "deadline_rejected": float(self.stats.deadline_rejected),
            "oversubscribed": float(self.stats.oversubscribed),
            "preemptions": float(self.stats.preemptions),
        }
        rep.update(self.monitor.summary())
        return rep

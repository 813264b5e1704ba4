"""Per-tenant latency tracking: EWMA, SLO attainment, predictability.

"We preserve predictability and isolation during virtualization by
monitoring inference latencies per-kernel. This allows reallocating
resources between tenants on-the-fly." (paper section 4)
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
from bisect import bisect_left, insort
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass
class TenantLatency:
    ewma_s: Optional[float] = None
    count: int = 0
    slo_violations: int = 0
    history: List[float] = dataclasses.field(default_factory=list)

    def percentile(self, q: float) -> float:
        if not self.history:
            return 0.0
        h = sorted(self.history)
        idx = min(len(h) - 1, int(q * len(h)))
        return h[idx]

    @property
    def attainment(self) -> float:
        """Fraction of recorded latencies that met their SLO."""
        if self.count == 0:
            return 1.0
        return 1.0 - self.slo_violations / self.count


class LatencyMonitor:
    """Cohort-level latency bookkeeping + straggler detection.

    With every workload flowing through the unified scheduler, one
    monitor sees heterogeneous work (steady-state decode steps,
    compile-heavy prefills, raw kernels). ``kind`` keeps a cohort-level
    history per workload class so consumers can report percentiles for
    one class (``summary_for``) without a second monitor.
    """

    # per-kind histories are bounded (recent window) so long-running
    # serving processes don't leak a float per dispatch forever
    KIND_HISTORY_MAX = 8192

    def __init__(self, ewma_alpha: float = 0.2, eviction_ratio: float = 1.5):
        self.alpha = ewma_alpha
        self.eviction_ratio = eviction_ratio
        self.tenants: Dict[int, TenantLatency] = {}
        # every non-None tenant EWMA, kept sorted incrementally (one
        # bisect-delete + insort per update) so straggler detection after
        # each dispatch is O(log T) instead of a full re-sort — the fleet
        # sim's former per-dispatch fixed cost. All EWMA updates MUST go
        # through record/record_batch to keep this in sync.
        self._ewma_sorted: List[float] = []
        self.by_kind: Dict[str, Deque[float]] = {}
        # False = keep only the signals the scheduler acts on (EWMA,
        # counts, violations) and skip the per-item history lists. The
        # simulator flips this off: its metrics come from
        # MetricsAccumulator, and an unbounded per-tenant history is a
        # float leaked per event at million-event scale. History-derived
        # views (summary / percentiles / spread) then report empty.
        self.record_history = True

    def record(
        self, tenant_id: int, latency_s: float, slo_s: float,
        kind: str = "default",
    ) -> None:
        t = self.tenants.setdefault(tenant_id, TenantLatency())
        t.count += 1
        if latency_s > slo_s:
            t.slo_violations += 1
        srt = self._ewma_sorted
        old = t.ewma_s
        if old is None:
            t.ewma_s = latency_s
        else:
            t.ewma_s = self.alpha * latency_s + (1 - self.alpha) * old
            del srt[bisect_left(srt, old)]
        insort(srt, t.ewma_s)
        if self.record_history:
            t.history.append(latency_s)
            self.by_kind.setdefault(
                kind, collections.deque(maxlen=self.KIND_HISTORY_MAX)
            ).append(latency_s)

    def record_batch(self, items, completion_s: float) -> None:
        """Record one dispatch's completions: ``completion_s -
        item.arrival_time`` against ``item.slo_s`` per item, in batch
        order. Same arithmetic as per-item ``record`` with the dict and
        attribute traffic hoisted out of the loop — the scheduler calls
        this once per dispatch instead of once per workload.
        """
        alpha = self.alpha
        one_minus = 1 - alpha
        tenants = self.tenants
        srt = self._ewma_sorted
        keep_history = self.record_history
        by_kind = self.by_kind
        # sorted-list fixups are deferred to once per distinct tenant per
        # batch: only each tenant's final EWMA survives the batch, so the
        # resulting list is identical to per-item maintenance
        before: Dict[int, Optional[float]] = {}
        for p in items:
            latency_s = completion_s - p.arrival_time
            tid = p.tenant_id
            t = tenants.get(tid)
            if t is None:
                t = TenantLatency()
                tenants[tid] = t
            t.count += 1
            if latency_s > p.slo_s:
                t.slo_violations += 1
            e = t.ewma_s
            if tid not in before:
                before[tid] = e
            if e is None:
                t.ewma_s = latency_s
            else:
                t.ewma_s = alpha * latency_s + one_minus * e
            if keep_history:
                t.history.append(latency_s)
                kind = getattr(p, "kind", "default")
                d = by_kind.get(kind)
                if d is None:
                    d = collections.deque(maxlen=self.KIND_HISTORY_MAX)
                    by_kind[kind] = d
                d.append(latency_s)
        for tid, old in before.items():
            if old is not None:
                del srt[bisect_left(srt, old)]
            insort(srt, tenants[tid].ewma_s)

    def slo_attainment(self, tenant_id: int) -> float:
        """Per-tenant SLO attainment (1.0 for unknown tenants)."""
        t = self.tenants.get(tenant_id)
        return t.attainment if t is not None else 1.0

    def cohort_median_ewma(self) -> Optional[float]:
        # read off the incrementally-maintained sorted list; the even-n
        # arithmetic matches statistics.median exactly (byte-identical
        # eviction decisions vs the old per-call re-sort)
        srt = self._ewma_sorted
        n = len(srt)
        if n == 0:
            return None
        mid = n // 2
        return srt[mid] if n % 2 else (srt[mid - 1] + srt[mid]) / 2

    def stragglers(self) -> List[int]:
        """Tenants whose EWMA latency exceeds eviction_ratio x cohort median.

        "CUDA Stream scheduling anomalies typically only create a few
        stragglers, so we can simply evict degraded workers without
        significantly impacting total system throughput."
        """
        med = self.cohort_median_ewma()
        if med is None or med == 0.0:
            return []
        cut = self.eviction_ratio * med
        if self._ewma_sorted[-1] <= cut:
            # common case — no tenant above the cut; O(1) per dispatch
            return []
        return [
            tid
            for tid, t in self.tenants.items()
            if t.ewma_s is not None and t.ewma_s > cut
        ]

    # ------------------------------------------------------------ metrics
    def predictability_spread(self) -> float:
        """Max/min inter-tenant typical-latency gap (paper Fig 4: 25% for MPS).

        Returns (max - min) / min over each tenant's MEDIAN latency; 0 =
        perfectly uniform (predictable) cohort. Median rather than mean:
        with every workload flowing through the unified scheduler, a
        tenant's history mixes steady-state decode steps with one-off
        compile-heavy prefills, and the paper's claim is about the
        steady-state step latency the device scheduler hands each tenant.
        """
        meds = [
            statistics.median(t.history) for t in self.tenants.values() if t.history
        ]
        if len(meds) < 2 or min(meds) == 0.0:
            return 0.0
        return (max(meds) - min(meds)) / min(meds)

    @staticmethod
    def _percentiles(latencies: List[float]) -> Dict[str, float]:
        h = sorted(latencies)
        return {
            "p50_s": h[len(h) // 2],
            "p95_s": h[min(len(h) - 1, int(0.95 * len(h)))],
            "p99_s": h[min(len(h) - 1, int(0.99 * len(h)))],
            "mean_s": statistics.mean(h),
        }

    def summary_for(self, kind: str) -> Dict[str, float]:
        """Percentiles over one workload class (empty dict if unseen)."""
        lat = self.by_kind.get(kind)
        return self._percentiles(lat) if lat else {}

    def summary(self) -> Dict[str, float]:
        all_lat = [x for t in self.tenants.values() for x in t.history]
        if not all_lat:
            return {}
        out = self._percentiles(all_lat)
        out.update({
            "num_tenants": float(len(self.tenants)),
            "spread": self.predictability_spread(),
            "slo_violations": float(
                sum(t.slo_violations for t in self.tenants.values())
            ),
        })
        return out

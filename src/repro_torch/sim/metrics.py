"""Simulation metrics: latency percentiles, SLO attainment, goodput,
utilization, and tenant-interference — with deterministic JSON export.

``MetricsAccumulator`` ingests completed workloads one at a time in the
simulator's hot loop (columnar ``array`` appends, no per-item objects —
million-event runs stay cheap) and freezes into a ``SimMetrics`` whose
summary is computed vectorized at the end.

Exports are BENCH-compatible: ``SimMetrics.bench_rows()`` yields the same
``(name, us_per_call, derived)`` triples the benchmark runner's CSV block
prints, and ``to_bench_json()`` wraps them plus the full metric dict into
one JSON document (``BENCH_<name>.json``). All exports use sorted keys
and pure-deterministic arithmetic, so one seed produces one byte-exact
JSON — the determinism contract the tests pin.
"""

from __future__ import annotations

import json
import math
from array import array
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Version stamp of every exported metrics document (SimMetrics /
# FleetMetrics to_dict + to_bench_json); the same number as the JAX
# package's, so the two packages' documents diff directly. Bump when the
# JSON layout changes shape, so a reader reports a version mismatch
# instead of silently comparing rows across incompatible layouts.
SCHEMA_VERSION = 1


class MetricsAccumulator:
    """Columnar per-completion record store (hot-loop ingestion side)."""

    def __init__(self) -> None:
        self._lat = array("d")
        self._slo = array("d")
        self._cost = array("d")
        self._tenant = array("l")
        self._kind_idx = array("l")
        self._kinds: Dict[str, int] = {}

    def add(self, tenant_id: int, latency_s: float, slo_s: float,
            cost: float, kind: str) -> None:
        self._lat.append(latency_s)
        self._slo.append(slo_s)
        self._cost.append(cost)
        self._tenant.append(tenant_id)
        ki = self._kinds.get(kind)
        if ki is None:
            ki = self._kinds.setdefault(kind, len(self._kinds))
        self._kind_idx.append(ki)

    def add_batch(self, done: Sequence) -> None:
        """Absorb one dispatch's completed workloads (arrival/completion
        stamps already set). Column-at-a-time ``array.extend`` over
        listcomps: one C call per column per dispatch instead of five
        Python-level appends per completion, with identical column
        contents (batch order preserved).
        """
        kinds = self._kinds
        try:
            kidx = [kinds[w.kind] for w in done]
        except KeyError:
            # rare path (new kind seen): intern first so the columns are
            # only extended once the whole index list exists
            kidx = []
            for w in done:
                ki = kinds.get(w.kind)
                if ki is None:
                    ki = kinds.setdefault(w.kind, len(kinds))
                kidx.append(ki)
        self._lat.extend([w.completion_time - w.arrival_time for w in done])
        self._slo.extend([w.slo_s for w in done])
        self._cost.extend([w.cost for w in done])
        self._tenant.extend([w.tenant_id for w in done])
        self._kind_idx.extend(kidx)

    def __len__(self) -> int:
        return len(self._lat)

    def freeze(self, sim_duration_s: float, busy_time_s: float,
               dispatches: int, rejected: int = 0,
               evicted_tenants: int = 0,
               ripe_nudges: int = 0,
               deadline_rejected: int = 0,
               oversubscribed: int = 0,
               preemptions: int = 0) -> "SimMetrics":
        return SimMetrics(
            lat=np.asarray(self._lat, np.float64),
            slo=np.asarray(self._slo, np.float64),
            cost=np.asarray(self._cost, np.float64),
            tenant=np.asarray(self._tenant, np.int64),
            kind_idx=np.asarray(self._kind_idx, np.int64),
            kinds=[k for k, _ in sorted(self._kinds.items(), key=lambda kv: kv[1])],
            sim_duration_s=float(sim_duration_s),
            busy_time_s=float(busy_time_s),
            dispatches=int(dispatches),
            rejected=int(rejected),
            evicted_tenants=int(evicted_tenants),
            ripe_nudges=int(ripe_nudges),
            deadline_rejected=int(deadline_rejected),
            oversubscribed=int(oversubscribed),
            preemptions=int(preemptions),
        )


def _pct(lat: np.ndarray) -> Dict[str, float]:
    if lat.size == 0:
        return {"p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
    p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
    return {"p50_s": float(p50), "p95_s": float(p95), "p99_s": float(p99),
            "mean_s": float(lat.mean())}


class SimMetrics:
    """Frozen simulation outcome; every metric derives from the columns."""

    def __init__(self, lat, slo, cost, tenant, kind_idx, kinds,
                 sim_duration_s, busy_time_s, dispatches,
                 rejected=0, evicted_tenants=0, ripe_nudges=0,
                 deadline_rejected=0, oversubscribed=0, preemptions=0):
        self.lat = lat
        self.slo = slo
        self.cost = cost
        self.tenant = tenant
        self.kind_idx = kind_idx
        self.kinds = kinds
        self.sim_duration_s = sim_duration_s
        self.busy_time_s = busy_time_s
        self.dispatches = dispatches
        self.rejected = rejected
        self.evicted_tenants = evicted_tenants
        # scheduler counters, surfaced in bench rows but deliberately NOT
        # in summary()/to_dict():
        # the metrics JSON layout (SCHEMA_VERSION 1) stays byte-identical
        self.ripe_nudges = ripe_nudges
        self.deadline_rejected = deadline_rejected
        self.oversubscribed = oversubscribed
        self.preemptions = preemptions
        self._met = lat <= slo if lat.size else np.zeros(0, bool)

    # ------------------------------------------------------------- headline
    @property
    def completed(self) -> int:
        return int(self.lat.size)

    @property
    def slo_attainment(self) -> float:
        """Fraction of completed workloads that met their SLO."""
        return float(self._met.mean()) if self.lat.size else 1.0

    @property
    def throughput_cost_per_s(self) -> float:
        """Simulated throughput in cost units (FLOPs/tokens) per second."""
        if self.sim_duration_s <= 0.0:
            return 0.0
        return float(self.cost.sum()) / self.sim_duration_s

    @property
    def goodput_cost_per_s(self) -> float:
        """Throughput counting only SLO-met work (D-STACK's usefulness
        criterion: late answers don't count)."""
        if self.sim_duration_s <= 0.0:
            return 0.0
        return float(self.cost[self._met].sum()) / self.sim_duration_s

    @property
    def utilization(self) -> float:
        """Fraction of simulated time the device was busy."""
        if self.sim_duration_s <= 0.0:
            return 0.0
        return min(1.0, self.busy_time_s / self.sim_duration_s)

    # ------------------------------------------------------------ breakdowns
    def per_tenant(self) -> Dict[int, Dict[str, float]]:
        out: Dict[int, Dict[str, float]] = {}
        for t in np.unique(self.tenant):
            mask = self.tenant == t
            d = _pct(self.lat[mask])
            d["slo_attainment"] = float(self._met[mask].mean())
            d["completed"] = float(mask.sum())
            out[int(t)] = d
        return out

    def per_kind(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for ki, kind in enumerate(self.kinds):
            mask = self.kind_idx == ki
            if not mask.any():
                continue
            d = _pct(self.lat[mask])
            d["slo_attainment"] = float(self._met[mask].mean())
            out[kind] = d
        return out

    def summary(self) -> Dict[str, float]:
        out = _pct(self.lat)
        out.update({
            "completed": float(self.completed),
            "dispatches": float(self.dispatches),
            "rejected": float(self.rejected),
            "evicted_tenants": float(self.evicted_tenants),
            "sim_duration_s": self.sim_duration_s,
            "busy_time_s": self.busy_time_s,
            "utilization": self.utilization,
            "slo_attainment": self.slo_attainment,
            "throughput_cost_per_s": self.throughput_cost_per_s,
            "goodput_cost_per_s": self.goodput_cost_per_s,
        })
        return out

    # --------------------------------------------------------------- export
    def bench_rows(self, prefix: str) -> List[Tuple[str, float, str]]:
        """``(name, us_per_call, derived)`` triples, the benchmark runner's
        CSV schema, for appending to a run's ``csv_rows``."""
        s = self.summary()
        return [
            (f"{prefix}/p50", s["p50_s"] * 1e6, "us latency"),
            (f"{prefix}/p95", s["p95_s"] * 1e6, "us latency"),
            (f"{prefix}/p99", s["p99_s"] * 1e6, "us latency"),
            (f"{prefix}/attainment", s["slo_attainment"] * 100.0, "pct SLO met"),
            (f"{prefix}/goodput", s["goodput_cost_per_s"],
             "cost_units_per_s_slo_met"),
            (f"{prefix}/utilization", s["utilization"] * 100.0, "pct busy"),
            (f"{prefix}/ripe_nudges", float(self.ripe_nudges),
             "count (ungated)"),
            (f"{prefix}/deadline_rejected", float(self.deadline_rejected),
             "count (ungated)"),
            (f"{prefix}/oversubscribed", float(self.oversubscribed),
             "count (ungated)"),
            (f"{prefix}/preemptions", float(self.preemptions),
             "count (ungated)"),
        ]

    def to_dict(self) -> Dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "summary": self.summary(),
            "per_tenant": {str(k): v for k, v in self.per_tenant().items()},
            "per_kind": self.per_kind(),
        }

    def to_json(self) -> str:
        """Canonical (sorted-keys) JSON — byte-identical across same-seed
        runs; the determinism tests compare these strings directly."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


class FleetMetrics:
    """Fleet-level simulation outcome: the merged (fleet-wide) metrics
    plus per-replica breakdowns and the routing/cold-start signals the
    single-replica ``SimMetrics`` cannot express.

    Duck-types ``SimMetrics``'s export surface (``summary`` /
    ``bench_rows`` / ``to_dict`` / ``to_json``) so ``to_bench_json``
    consumes fleet sections unchanged.

    ``cold_times`` / ``cold_flags`` are the concatenated per-dispatch
    ``(virtual seconds, was_cold)`` series across replicas — the warm-up
    curve; ``cold_fraction_halves()`` splits it at the fleet horizon
    midpoint (cold fraction must decay as caches warm).

    ``scale_events`` is the autoscale timeline (one dict per decision
    that changed the fleet), ``replica_specs`` names each replica's
    hardware (heterogeneous fleets), and ``final_active`` is the replica
    count still receiving arrivals when the trace ended — all part of the
    deterministic JSON, so the byte-identical contract covers elasticity
    too. Every fleet-signal accessor is total: empty or single-completion
    windows (a replica spun up at the very end, a trace with no
    arrivals) yield defined 0.0 values, never NaN in BENCH JSON.
    """

    def __init__(self, merged: SimMetrics, per_replica: List[SimMetrics],
                 routed_counts: Sequence[int], router: str,
                 cold_times: np.ndarray, cold_flags: np.ndarray,
                 scale_events: Optional[Sequence] = None,
                 replica_specs: Optional[Sequence[Optional[str]]] = None,
                 final_active: Optional[int] = None,
                 partition: Optional[Dict] = None):
        self.merged = merged
        self.per_replica = per_replica
        self.routed_counts = np.asarray(routed_counts, np.int64)
        self.router = router
        self.cold_times = np.asarray(cold_times, np.float64)
        self.cold_flags = np.asarray(cold_flags, np.int64)
        # normalize to plain dicts so to_json stays canonical
        self.scale_events: List[Dict] = [
            e.to_dict() if hasattr(e, "to_dict") else dict(e)
            for e in (scale_events or [])]
        self.replica_specs: List[Optional[str]] = (
            list(replica_specs) if replica_specs is not None
            else [None] * len(per_replica))
        self.final_active = (len(per_replica) if final_active is None
                             else int(final_active))
        # fractional-share section (repro_torch.partition): the final plan plus
        # the assign/replan event timeline. None on unpartitioned fleets,
        # and then absent from to_dict() — pre-partition metrics JSON
        # stays byte-identical.
        self.partition: Optional[Dict] = partition

    @property
    def replicas(self) -> int:
        """Replicas that were ever live (autoscaled fleets: spawned)."""
        return len(self.per_replica)

    @property
    def ripe_nudges(self) -> int:
        """Fleet-wide scheduler drift counter (sum over replicas)."""
        return self.merged.ripe_nudges

    @property
    def deadline_rejected(self) -> int:
        """Fleet-wide feasibility-admission rejects (sum over replicas)."""
        return self.merged.deadline_rejected

    @property
    def oversubscribed(self) -> int:
        """Fleet-wide past-deadline admits (sum over replicas)."""
        return self.merged.oversubscribed

    @property
    def preemptions(self) -> int:
        """Fleet-wide ahead-of-window force-dispatches (sum over replicas)."""
        return self.merged.preemptions

    @property
    def initial_replicas(self) -> int:
        """Fleet size at trace start (every scale-up spawned one more)."""
        return len(self.per_replica) - self.scale_ups

    @property
    def scale_ups(self) -> int:
        return sum(1 for e in self.scale_events if e["action"] == "up")

    @property
    def scale_downs(self) -> int:
        return sum(1 for e in self.scale_events if e["action"] == "down")

    # ------------------------------------------------------- fleet signals
    # Every accessor below must be total over degenerate windows: an empty
    # fleet section, a single completion, or a replica that never routed
    # returns a defined 0.0 — these numbers flow verbatim into gated BENCH
    # JSON, where one NaN poisons every downstream comparison.
    @property
    def utilization_spread(self) -> float:
        """max - min per-replica utilization (0 = perfectly even work)."""
        utils = [m.utilization for m in self.per_replica]
        if not utils:
            return 0.0
        spread = float(max(utils) - min(utils))
        return spread if math.isfinite(spread) else 0.0

    @property
    def routing_imbalance(self) -> float:
        """Coefficient of variation of per-replica routed arrival counts
        (0 = perfectly balanced; round-robin's floor)."""
        c = self.routed_counts.astype(np.float64)
        if c.size == 0:
            return 0.0
        mean = float(c.mean())
        if mean <= 0.0:
            return 0.0
        return float(c.std() / mean)

    @property
    def cold_start_fraction(self) -> float:
        """Fraction of all fleet dispatches that paid a compile."""
        if self.cold_flags.size == 0:
            return 0.0
        return float(self.cold_flags.mean())

    def cold_fraction_halves(self) -> Tuple[float, float]:
        """Cold-dispatch fraction in the first vs second half of the fleet
        horizon — the warm-up decay the tests pin. Windows with no
        dispatches (empty trace; a single dispatch leaves the second half
        empty) contribute a defined 0.0, not a NaN mean."""
        if self.cold_times.size == 0:
            return 0.0, 0.0
        mid = (float(self.cold_times.min()) + float(self.cold_times.max())) / 2.0
        early = self.cold_times <= mid
        first = self.cold_flags[early]
        second = self.cold_flags[~early]
        return (float(first.mean()) if first.size else 0.0,
                float(second.mean()) if second.size else 0.0)

    # ------------------------------------------------------------- exports
    def summary(self) -> Dict[str, float]:
        out = self.merged.summary()
        first, second = self.cold_fraction_halves()
        out.update({
            # merged utilization clamps Σbusy/horizon at 1.0 — meaningless
            # for N > 1; report the per-replica mean instead
            "utilization": float(
                np.mean([m.utilization for m in self.per_replica])
            ) if self.per_replica else 0.0,
            "replicas": float(self.replicas),
            "final_active": float(self.final_active),
            "scale_ups": float(self.scale_ups),
            "scale_downs": float(self.scale_downs),
            "routing_imbalance": self.routing_imbalance,
            "utilization_spread": self.utilization_spread,
            "cold_start_fraction": self.cold_start_fraction,
            "cold_fraction_first_half": first,
            "cold_fraction_second_half": second,
        })
        return out

    def bench_rows(self, prefix: str) -> List[Tuple[str, float, str]]:
        s = self.summary()
        rows = [
            (f"{prefix}/p50", s["p50_s"] * 1e6, "us latency"),
            (f"{prefix}/p95", s["p95_s"] * 1e6, "us latency"),
            (f"{prefix}/p99", s["p99_s"] * 1e6, "us latency"),
            (f"{prefix}/attainment", s["slo_attainment"] * 100.0, "pct SLO met"),
            (f"{prefix}/goodput", s["goodput_cost_per_s"],
             "cost_units_per_s_slo_met"),
            (f"{prefix}/utilization", s["utilization"] * 100.0,
             "pct busy (mean over replicas)"),
        ]
        rows.extend([
            (f"{prefix}/ripe_nudges", float(self.ripe_nudges),
             "count (ungated)"),
            (f"{prefix}/deadline_rejected", float(self.deadline_rejected),
             "count (ungated)"),
            (f"{prefix}/oversubscribed", float(self.oversubscribed),
             "count (ungated)"),
            (f"{prefix}/preemptions", float(self.preemptions),
             "count (ungated)"),
            (f"{prefix}/routing_imbalance", self.routing_imbalance,
             "cv routed counts"),
            (f"{prefix}/utilization_spread", self.utilization_spread * 100.0,
             "pct max-min"),
            (f"{prefix}/cold_fraction", self.cold_start_fraction * 100.0,
             "pct dispatches compiling"),
        ])
        if self.scale_events:
            rows.extend([
                (f"{prefix}/scale_events", float(len(self.scale_events)),
                 "autoscale decisions applied"),
                (f"{prefix}/final_active", float(self.final_active),
                 "replicas active at trace end"),
            ])
        return rows

    def to_dict(self) -> Dict:
        doc = self.merged.to_dict()
        doc["summary"] = self.summary()
        per_replica = {}
        for i, m in enumerate(self.per_replica):
            entry = m.summary()
            entry["routed"] = float(self.routed_counts[i]) \
                if i < self.routed_counts.size else 0.0
            spec = self.replica_specs[i] if i < len(self.replica_specs) else None
            if spec is not None:
                entry["spec"] = spec
            per_replica[str(i)] = entry
        doc["per_replica"] = per_replica
        doc["routed_counts"] = [int(c) for c in self.routed_counts]
        doc["router"] = self.router
        doc["scale_events"] = self.scale_events
        if self.partition is not None:
            doc["partition"] = self.partition
        return doc

    def to_json(self) -> str:
        """Canonical sorted-keys JSON — byte-identical per seed, same
        contract as ``SimMetrics.to_json``."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def to_bench_json(name: str, sections: Dict[str, "SimMetrics | FleetMetrics"],
                  extra: Optional[Dict] = None) -> str:
    """One BENCH_<name>.json document over named simulation sections."""
    rows = []
    for section, metrics in sorted(sections.items()):
        rows.extend(
            {"name": n, "us_per_call": v, "derived": d}
            for n, v, d in metrics.bench_rows(f"{name}/{section}")
        )
    doc = {
        "benchmark": name,
        "schema_version": SCHEMA_VERSION,
        "rows": rows,
        "sections": {k: m.to_dict() for k, m in sorted(sections.items())},
    }
    if extra:
        doc["extra"] = extra
    return json.dumps(doc, indent=2, sort_keys=True)


def interference_matrix(
    run_mix: Callable[[Sequence], SimMetrics],
    specs: Sequence,
) -> np.ndarray:
    """Tenant-interference (isolation) matrix from counterfactual co-runs.

    ``M[i][j]`` = mean latency of tenant ``i`` co-run with tenant ``j``,
    divided by tenant ``i``'s solo mean latency — 1.0 everywhere means
    perfect isolation; row spikes name the victim, column spikes the
    aggressor. ``run_mix(specs_subset)`` must run one deterministic
    simulation over the given subset (the simulator is fast enough that
    the O(T^2) counterfactuals finish in seconds).

    Specs must carry distinct tenant_ids: results are keyed per tenant,
    so two specs of one tenant (e.g. a serving mix's prefill + decode
    streams) would blend into one meaningless row — pick one spec per
    tenant before calling.
    """
    n = len(specs)
    if len({s.tenant_id for s in specs}) != n:
        raise ValueError(
            "interference_matrix needs unique tenant_ids; pick one spec "
            "per tenant (got "
            f"{sorted(s.tenant_id for s in specs)})")
    solo = np.empty(n)
    for i, s in enumerate(specs):
        pt = run_mix([s]).per_tenant()
        solo[i] = pt[s.tenant_id]["mean_s"]
    M = np.ones((n, n))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            pt = run_mix([specs[i], specs[j]]).per_tenant()
            entry = pt.get(specs[i].tenant_id)
            if entry is None or solo[i] <= 0.0:
                # victim completed nothing in this co-run (starved) or has
                # a degenerate solo baseline — surface it, don't report it
                # as perfect isolation
                M[i, j] = float("nan")
            else:
                M[i, j] = entry["mean_s"] / solo[i]
    return M

"""Dispatch cost models: analytical roofline prior + online calibration.

A cost model is a callable ``model(batch) -> seconds`` pricing ONE
super-dispatch of merged workloads; the scheduler advances its
``VirtualClock`` by that amount, which is what turns the live pump into a
deterministic simulator (see ``core.scheduler``).

Three models, designed to compose:

``RooflineCostModel``
    Analytical prior over a ``HardwareSpec`` (``launch/roofline.py``;
    the default is the H100's). First-order, strategy-aware:

        t_item_i   = max(flops_i/peak, bytes_i/hbm_bw)       (per workload)
        roof       = max(Σflops/peak, Σbytes/hbm_bw)         (merged batch)

        space_time = disp + fill + roof
        exclusive  = space_time (shared-weight upper bound; same roof here)
        space_only = disp + R*fill + roof/eff
        time_only  = Σ_i (ctx + disp + fill + t_item_i/eff)

    ``eff`` (< 1) models the spatial underutilization of small unmerged
    kernels: concurrent streams cannot widen any single kernel, so neither
    the tensor cores nor the HBM pipeline reach their roofs. Only the merged
    super-kernel runs at the roofline. Since Σ t_item_i >= roof always
    (sum of maxes dominates max of sums), the model *guarantees* the
    paper's qualitative ordering space_time > space_only > time_only for
    every batch, while the default eff lands the gaps in the ballpark of
    the paper's measured 3.23x/7.73x wins.

``CalibratedCostModel``
    Replaces the prior, per (bucket, pow2-R) key, with an EWMA fit of
    OBSERVED dispatch seconds — attach it to a live scheduler via the
    ``on_dispatch`` tap, then ``save()``/``load()`` the fitted table as
    JSON and replay millions of simulated events against real measured
    costs. Keys use the same ``round_pow2`` bucketing as the super-kernel
    compile cache, so a measurement made on a live (bucket, R) dispatch
    resolves for exactly the simulated batches that would have hit that
    compiled variant.

``ColdStartCostModel``
    Wraps either of the above with per-instance compile-cache accounting:
    the first dispatch per (bucket, pow2-R) key pays an extra ``compile_s``
    (building that super-kernel variant), later dispatches reuse
    the warm variant. One instance per fleet replica models per-replica
    compile caches — the state that makes warm-cache-affinity routing
    trade against load balance (see ``repro_torch.sim.fleet``).
"""

from __future__ import annotations

import json
import os
from array import array
from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.workload import round_pow2
from repro_torch.launch.roofline import (  # noqa: F401  (re-exported: the
    H100,  # registry lives beside HardwareSpec in launch/roofline;
    HARDWARE_SPECS,  # sim callers keep importing it from here)
    HardwareSpec,
    resolve_spec,
)

# canonical strategy names, worst-to-best throughput (display order too)
STRATEGIES = ("time_only", "space_only", "space_time", "exclusive")


def _flops(w) -> float:
    # explicit None check: flops == 0.0 is a valid value (pure data
    # movement) and must NOT fall back to the abstract cost field
    flops = getattr(w, "flops", None)
    if flops is None:
        flops = getattr(w, "cost", 0.0)
    return float(flops)


def _bytes(w) -> float:
    return float(getattr(w, "bytes", 0.0) or 0.0)


class RooflineCostModel:
    """Analytical strategy-aware roofline prior (see module docstring)."""

    def __init__(
        self,
        spec: HardwareSpec = H100,
        strategy: str = "space_time",
        small_kernel_efficiency: float = 0.45,
    ):
        if strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
        if not (0.0 < small_kernel_efficiency <= 1.0):
            raise ValueError("small_kernel_efficiency must be in (0, 1]")
        self.spec = spec
        self.strategy = strategy
        self.eff = small_kernel_efficiency

    def __call__(self, batch: Sequence) -> float:
        # called once per super-dispatch with up to max_superkernel_size
        # items — the loops below are the simulator's per-item pricing
        # cost, so the flops/bytes fallbacks are inlined (one pass, no
        # per-item helper calls) with the exact arithmetic order of the
        # original sum() generators
        s = self.spec
        fill = s.pipe_fill_s()
        if self.strategy == "time_only":
            tot = 0.0
            t_compute, t_memory = s.t_compute, s.t_memory
            eff = self.eff
            per_item = s.context_switch_s + s.dispatch_overhead_s + fill
            for w in batch:
                flops = getattr(w, "flops", None)
                if flops is None:
                    flops = getattr(w, "cost", 0.0)
                t_item = max(t_compute(float(flops)),
                             t_memory(float(getattr(w, "bytes", 0.0) or 0.0)))
                tot += per_item + t_item / eff
            return tot
        f_sum = 0.0
        b_sum = 0.0
        for w in batch:
            flops = getattr(w, "flops", None)
            if flops is None:
                flops = getattr(w, "cost", 0.0)
            f_sum += float(flops)
            b_sum += float(getattr(w, "bytes", 0.0) or 0.0)
        roof = max(s.t_compute(f_sum), s.t_memory(b_sum))
        if self.strategy == "space_only":
            return s.dispatch_overhead_s + len(batch) * fill + roof / self.eff
        # space_time / exclusive: one wide kernel at the roofline
        return s.dispatch_overhead_s + fill + roof

    def item_s(self, w) -> float:
        """Marginal seconds of adding ``w`` to an already-forming merged
        batch: the incremental roofline term only — dispatch, fill, and
        (for a cold key) compile are paid by the batch regardless. Upper
        bounds ``cost(batch + w) - cost(batch)`` for the merged
        strategies; routers use it to price joining a pending bucket."""
        s = self.spec
        return max(s.t_compute(_flops(w)), s.t_memory(_bytes(w)))

    def estimate_item_s(self, w, share: float = 1.0) -> float:
        """Share-aware marginal: ``item_s`` when the tenant holds only a
        ``share`` fraction of this chip. The marginal term is pure roof
        (overheads are the batch's, not the item's) and roofs scale
        linearly with the spatial share, so the fractional price is
        exactly ``item_s / share`` — this is what feasibility admission
        charges a tenant on a partition slice instead of assuming
        whole-chip service (``repro_torch.partition``)."""
        if not (0.0 < share <= 1.0):
            raise ValueError(f"share must be in (0, 1], got {share}")
        return self.item_s(w) / share


def batch_key(batch: Sequence) -> str:
    """Calibration key of one super-dispatch: (bucket, pow2-R) as a string.

    The pow2 rounding is the shared ``round_pow2`` the compile cache uses,
    so observed timings bucket exactly like compiled super-kernel variants.
    String-typed so the fitted table round-trips through JSON losslessly.
    """
    bucket = getattr(batch[0], "bucket", None)
    return f"{bucket!r}|r{round_pow2(len(batch))}"


class CalibratedCostModel:
    """EWMA-fitted per-(bucket, pow2-R) dispatch costs over a prior.

    Usage (live calibration -> simulated replay):

        model = CalibratedCostModel()
        sched = DynamicSpaceTimeScheduler(..., on_dispatch=model.observe)
        ...run live traffic...                # fits the table
        model.save("costs.json")
        sim_model = CalibratedCostModel.load("costs.json")
        Simulator(..., cost_model=sim_model)  # prices batches from data

    Warm-up: a key's first ``1/alpha`` observations are folded in at
    ``alpha_eff = 1/count`` (a plain cumulative mean), after which the fit
    settles into steady-state EWMA at ``alpha``. Observation counts are
    part of the persisted state: a loaded model resumes steady-state EWMA
    on its warm keys instead of letting one fresh sample overwrite a
    long-fitted value.

    Calibration confidence: ``prior_strength`` (a pseudo-count ``k``,
    default 0 = off) prices each fitted key as the count-weighted
    Bayesian blend ``(n*fitted + k*prior) / (n + k)`` — a key seen once
    stays near the analytical prior, a key seen hundreds of times is
    essentially its measured value. Without it, knee curves fit from
    thin tables are jagged: one noisy observation of a sparse
    (bucket, R) key would swing a whole throughput-vs-share sweep.
    """

    def __init__(
        self,
        prior: Optional[Callable[[Sequence], float]] = None,
        ewma_alpha: float = 0.2,
        prior_strength: float = 0.0,
    ):
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError("ewma_alpha must be in (0, 1]")
        if prior_strength < 0.0:
            raise ValueError(
                f"prior_strength must be >= 0, got {prior_strength}")
        self.prior = prior or RooflineCostModel()
        self.alpha = ewma_alpha
        self.prior_strength = float(prior_strength)
        self.table: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    # --------------------------------------------------------------- fitting
    def observe(self, batch: Sequence, seconds: float,
                replica_id: Optional[int] = None) -> None:
        """Fold one measured dispatch into the fit (scheduler ``on_dispatch``
        signature, so it plugs in directly; ``replica_id`` is accepted for
        tap compatibility — the table is fleet-wide)."""
        if not batch or seconds < 0.0:
            return
        key = batch_key(batch)
        count = self.counts.get(key, 0) + 1
        self.counts[key] = count
        prev = self.table.get(key)
        if prev is None:
            self.table[key] = seconds
            return
        # cumulative mean while count < 1/alpha, steady-state EWMA after
        alpha_eff = max(self.alpha, 1.0 / count)
        self.table[key] = alpha_eff * seconds + (1.0 - alpha_eff) * prev

    # --------------------------------------------------------------- pricing
    def __call__(self, batch: Sequence) -> float:
        key = batch_key(batch)
        fitted = self.table.get(key)
        if fitted is None:
            return self.prior(batch)
        k = self.prior_strength
        if k <= 0.0:
            return fitted
        n = self.counts.get(key, 1)
        return (n * fitted + k * self.prior(batch)) / (n + k)

    def coverage(self, batch: Sequence) -> bool:
        """True if this batch would be priced from data, not the prior."""
        return batch_key(batch) in self.table

    def item_s(self, w) -> float:
        """Marginal seconds of joining an already-forming batch of ``w``'s
        bucket. Fitted entries are WHOLE-dispatch costs, not increments,
        so the marginal term delegates to the prior's roofline marginal —
        routers pricing through a calibrated table keep seeing the
        merge-economy discount instead of a full solo dispatch."""
        prior_item = getattr(self.prior, "item_s", None)
        if prior_item is not None:
            return prior_item(w)
        return self((w,))

    def estimate_item_s(self, w, share: float = 1.0) -> float:
        """Share-aware marginal seconds (the ``repro_torch.partition``
        surface): the marginal term is pure roof, so it scales as
        ``1/share`` regardless of whether the solo estimate came from
        the prior or a fitted table."""
        if not (0.0 < share <= 1.0):
            raise ValueError(f"share must be in (0, 1], got {share}")
        return self.item_s(w) / share

    def dispatch_share_s(self, batch: Sequence, share: float = 1.0) -> float:
        """Whole-dispatch seconds when the batch runs on a ``share``
        fraction of the chip: the blended fitted-or-prior whole-chip
        seconds decomposed into fixed launch overhead (dispatch + pipe
        fill, paid at full price on any slice) plus a roof-bound
        remainder that scales as ``1/share`` — how knee curves price
        shares from calibrated tables without per-share measurements."""
        if not (0.0 < share <= 1.0):
            raise ValueError(f"share must be in (0, 1], got {share}")
        t_full = self(batch)
        if share >= 1.0:
            return t_full
        spec = getattr(self.prior, "spec", None)
        overhead = (spec.dispatch_overhead_s + spec.pipe_fill_s()
                    if spec is not None else 0.0)
        scalable = max(t_full - overhead, 0.0)
        return min(t_full, overhead) + scalable / share

    # ----------------------------------------------------------- persistence
    def to_json(self) -> str:
        doc = {"ewma_alpha": self.alpha,
               "entries": {k: {"seconds": self.table[k],
                               "observations": self.counts.get(k, 0)}
                           for k in sorted(self.table)}}
        if self.prior_strength > 0.0:
            # only when set: tables written with the default stay
            # byte-identical to pre-shrinkage builds
            doc["prior_strength"] = self.prior_strength
        return json.dumps(doc, indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def from_json(cls, text: str,
                  prior: Optional[Callable[[Sequence], float]] = None,
                  prior_strength: Optional[float] = None,
                  ) -> "CalibratedCostModel":
        data = json.loads(text)
        strength = (data.get("prior_strength", 0.0)
                    if prior_strength is None else prior_strength)
        model = cls(prior=prior, ewma_alpha=data.get("ewma_alpha", 0.2),
                    prior_strength=strength)
        for key, entry in data.get("entries", {}).items():
            model.table[key] = float(entry["seconds"])
            model.counts[key] = int(entry.get("observations", 1))
        return model

    @classmethod
    def load(cls, path: str,
             prior: Optional[Callable[[Sequence], float]] = None,
             prior_strength: Optional[float] = None,
             ) -> "CalibratedCostModel":
        with open(path) as fh:
            return cls.from_json(fh.read(), prior=prior,
                                 prior_strength=prior_strength)


class FleetCalibrator:
    """Per-replica ``CalibratedCostModel`` tables behind ONE dispatch tap.

    On a heterogeneous fleet one fleet-wide table is wrong by
    construction: the same (bucket, pow2-R) dispatch takes 2x longer on a
    half-speed chip, so blending replicas' observations fits a cost no
    replica actually has. This keeps one table per ``replica_id`` —
    ``observe`` (the scheduler ``on_dispatch`` signature, replica identity
    included) routes each measurement to its replica's table, and
    ``for_replica`` hands the fleet simulator a per-replica pricing model
    routers consult, so a calibrated fleet converges toward each chip's
    MEASURED costs even when the shared prior is wrong for it.

    Tables are created lazily on first sight of a replica id, which makes
    autoscaled fleets (fresh replica ids mid-run) work unchanged; the
    JSON round-trip (``save``/``load``) persists every table keyed by
    replica id, counts included, same warm-resume contract as
    ``CalibratedCostModel``.
    """

    def __init__(
        self,
        prior: Optional[Callable[[Sequence], float]] = None,
        ewma_alpha: float = 0.2,
    ):
        self.prior = prior
        self.alpha = ewma_alpha
        self.models: Dict[int, CalibratedCostModel] = {}

    @staticmethod
    def _rid(replica_id: Optional[int]) -> int:
        # solo schedulers tap with replica_id=None; file one table for them
        return -1 if replica_id is None else int(replica_id)

    def for_replica(self, replica_id: Optional[int]) -> CalibratedCostModel:
        rid = self._rid(replica_id)
        model = self.models.get(rid)
        if model is None:
            model = CalibratedCostModel(prior=self.prior,
                                        ewma_alpha=self.alpha)
            self.models[rid] = model
        return model

    def observe(self, batch: Sequence, seconds: float,
                replica_id: Optional[int] = None) -> None:
        """Scheduler ``on_dispatch`` tap: fold one measured dispatch into
        the dispatching replica's table."""
        self.for_replica(replica_id).observe(batch, seconds)

    def coverage(self, batch: Sequence, replica_id: Optional[int]) -> bool:
        model = self.models.get(self._rid(replica_id))
        return model is not None and model.coverage(batch)

    @property
    def observations(self) -> int:
        return sum(sum(m.counts.values()) for m in self.models.values())

    # ----------------------------------------------------------- persistence
    def to_json(self) -> str:
        return json.dumps(
            {"ewma_alpha": self.alpha,
             "replicas": {str(rid): json.loads(m.to_json())
                          for rid, m in sorted(self.models.items())}},
            indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def from_json(cls, text: str,
                  prior: Optional[Callable[[Sequence], float]] = None,
                  ) -> "FleetCalibrator":
        data = json.loads(text)
        calib = cls(prior=prior, ewma_alpha=data.get("ewma_alpha", 0.2))
        for rid, doc in data.get("replicas", {}).items():
            calib.models[int(rid)] = CalibratedCostModel.from_json(
                json.dumps(doc), prior=prior)
        return calib

    @classmethod
    def load(cls, path: str,
             prior: Optional[Callable[[Sequence], float]] = None,
             ) -> "FleetCalibrator":
        with open(path) as fh:
            return cls.from_json(fh.read(), prior=prior)


class ColdStartCostModel:
    """Compile-cache cold-start accounting over a base cost model.

    The live scheduler's ``SuperKernelCache`` keeps one super-kernel
    variant per (bucket, pow2-R); the FIRST dispatch that hits a variant
    pays its build, later ones reuse it. This wrapper models that:
    the first dispatch per ``batch_key`` adds ``compile_s``; the key is
    then *warm* and subsequent dispatches pay only the base cost.

    Each fleet replica wraps the (shared, stateless) base model in its OWN
    instance — compile caches are per-process state, so a fleet of N
    replicas pays up to N compiles per variant. That is exactly what makes
    routing interesting: tenant-affinity keeps tenants on replicas that
    already compiled their shapes, pure load balancing spreads every shape
    onto every replica and pays the full N-fold compile bill.

    Every dispatch is also logged as ``(virtual time, was_cold)`` so fleet
    metrics can report the cold-start fraction and its decay over the
    trace (warm-up curve).
    """

    def __init__(
        self,
        base: Optional[Callable[[Sequence], float]] = None,
        compile_s: float = 1e-3,
        clock=None,
    ):
        if compile_s < 0.0:
            raise ValueError("compile_s must be >= 0")
        self.base = base or RooflineCostModel()
        self.compile_s = float(compile_s)
        self.clock = clock
        self._warm: set = set()
        self._warm_buckets: set = set()
        self.dispatch_times = array("d")
        self.dispatch_cold = array("b")

    def __call__(self, batch: Sequence) -> float:
        key = batch_key(batch)
        cold = key not in self._warm
        if cold:
            self._warm.add(key)
            self._warm_buckets.add(getattr(batch[0], "bucket", None))
        self.dispatch_times.append(
            self.clock.now() if self.clock is not None else 0.0)
        self.dispatch_cold.append(1 if cold else 0)
        return self.base(batch) + (self.compile_s if cold else 0.0)

    # ------------------------------------------------------- routing signals
    def bucket_warm(self, bucket) -> bool:
        """True once ANY variant of this bucket has compiled here — the
        affinity signal routers use (R varies dispatch to dispatch, the
        bucket is the stable part of the key)."""
        return bucket in self._warm_buckets

    def estimate(self, batch: Sequence) -> float:
        """Price a batch WITHOUT mutating the warm set (what a router asks
        when weighing candidate replicas)."""
        cold = getattr(batch[0], "bucket", None) not in self._warm_buckets
        return self.base(batch) + (self.compile_s if cold else 0.0)

    def item_s(self, w) -> float:
        """Marginal cost of joining an already-pending batch of ``w``'s
        bucket: no compile term — the forming batch pays any compile once
        for everyone riding it."""
        base_item = getattr(self.base, "item_s", None)
        if base_item is not None:
            return base_item(w)
        return self.base((w,))

    # ------------------------------------------------------------- reporting
    @property
    def cold_dispatches(self) -> int:
        return int(sum(self.dispatch_cold))

    @property
    def dispatches(self) -> int:
        return len(self.dispatch_cold)


def estimate_capacity_hz(
    mix: Sequence,
    model: Callable[[Sequence], float],
    merge_size: int = 32,
) -> float:
    """Sustainable arrivals/s for a tenant mix under a cost model.

    Prices one representative dispatch ROUND — ``merge_size`` arrivals
    split by weight into one merged batch PER BUCKET, matching what the
    scheduler can actually co-dispatch (specs in different buckets never
    share a super-kernel, so each bucket pays its own per-dispatch
    overheads) — and converts to a service rate. This is the anchor load
    sweeps use to express offered load as a fraction of capacity (rho)
    instead of an absolute rate that only fits one mix.
    """
    from repro_torch.sim.simulator import SimWorkload  # local: avoid import cycle

    total_w = sum(s.weight for s in mix)
    by_bucket: Dict = {}
    items = 0
    for spec in mix:
        n = max(1, round(merge_size * spec.weight / total_w))
        by_bucket.setdefault(spec.bucket, []).extend(
            SimWorkload(spec, spec.cost) for _ in range(n))
        items += n
    round_s = sum(model(batch) for batch in by_bucket.values())
    return items / round_s

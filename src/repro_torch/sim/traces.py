"""Composable arrival-process generators — timestamped workload streams.

A *trace* is an iterable of time-ordered ``Arrival(t_s, spec, cost)``
events over a heterogeneous tenant mix. Traces are the input language of
the discrete-event simulator (``repro_torch.sim.simulator``) and the pacing
source for live replay (``repro_torch.serving.fleet``): the SAME seeded
generator drives both, so a live wall-clock run and a virtual-clock
simulation see bit-identical arrival sequences.

Processes (all deterministic per seed, generated lazily in vectorized
numpy chunks so million-event traces stream in O(chunk) memory):

    PoissonTrace          -- homogeneous Poisson arrivals (the paper's
                             stochastic-query setting)
    MarkovModulatedTrace  -- 2-state MMPP: calm/burst regimes with
                             exponential dwell times (bursty online traffic)
    DiurnalTrace          -- sinusoidal rate over a configurable period
                             (day/night load curves), via thinning
    FlashCrowdTrace       -- constant base rate plus a rate spike window
                             (launch-day / retry-storm shape)
    CsvReplayTrace        -- replay recorded ``t_s,tenant`` rows (real
                             production timestamps)

Tenant mixes are lists of ``TenantSpec`` — one entry per (tenant,
workload-class) with a mergeability bucket, roofline quantities
(flops/bytes), an SLO, and an arrival weight. Two mix functions cover the
repo's two scheduling layers:

    paper_sgemm_mix       -- kernel-level GEMM tenants over the paper's
                             Table-1 shapes (tiered SLOs)
    prefill_decode_mix    -- engine-shaped cohorts: rare compile-heavy
                             prefills + frequent decode steps per tenant,
                             bucketed exactly like MultiTenantEngine
                             submits them
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import operator
from typing import Hashable, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.queue import ShapeBucket
from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES

_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant workload class: what arrives, how it merges, what it owes.

    ``bucket`` uses the same key types the live schedulers use
    (``ShapeBucket`` for GEMMs, ``("decode", "cohort")`` tuples for engine
    cohorts) so calibrated cost-model entries measured on live runs
    resolve for simulated batches too.
    """

    tenant_id: int
    name: str
    bucket: Hashable
    cost: float                 # abstract work units (FLOPs / tokens)
    flops: float                # roofline compute term per arrival
    bytes: float                # roofline HBM term per arrival
    slo_s: float
    kind: str = "default"
    merge_family: Optional[Hashable] = None
    weight: float = 1.0         # relative arrival share within the mix


class Arrival(NamedTuple):
    t_s: float
    spec: TenantSpec
    cost: float


#: One columnar block of arrivals: ``(times, spec_idx, costs, specs)``.
#: ``times``/``costs`` are float64 arrays, ``spec_idx`` indexes int64 into
#: the ``specs`` table — the table is shared (and may grow) across blocks.
TraceChunk = Tuple[np.ndarray, np.ndarray, np.ndarray, List[TenantSpec]]


class Trace:
    """Iterable of time-ordered arrivals; ``+`` composes two traces."""

    def __iter__(self) -> Iterator[Arrival]:
        raise NotImplementedError

    def iter_chunks(self) -> Iterator[TraceChunk]:
        """Columnar view of the arrival stream in ``_CHUNK``-event blocks.

        Yields ``(times, spec_idx, costs, specs)`` with specs interned
        into an int-indexed table, so consumers touch numpy columns and
        small-int indices instead of one ``Arrival`` namedtuple (and one
        ``TenantSpec`` hash) per event. The event VALUES are exactly the
        ones ``__iter__`` yields — this is a representation change, not a
        resampling — so chunked and per-event consumers see bit-identical
        streams.

        This generic fallback batches ``__iter__`` (correct for any
        trace, including CSV replay and merged traces); generated mixes
        override it with a vectorized path that skips the per-event hop
        entirely.
        """
        table: List[TenantSpec] = []
        index: dict = {}            # id(spec) -> table slot
        ts: List[float] = []
        ii: List[int] = []
        cs: List[float] = []
        for t, spec, cost in self:
            j = index.get(id(spec))
            if j is None:
                j = len(table)
                index[id(spec)] = j
                table.append(spec)
            ts.append(t)
            ii.append(j)
            cs.append(cost)
            if len(ts) >= _CHUNK:
                yield (np.asarray(ts, np.float64), np.asarray(ii, np.int64),
                       np.asarray(cs, np.float64), table)
                ts, ii, cs = [], [], []
        if ts:
            yield (np.asarray(ts, np.float64), np.asarray(ii, np.int64),
                   np.asarray(cs, np.float64), table)

    def __add__(self, other: "Trace") -> "Trace":
        return MergedTrace(self, other)


class MergedTrace(Trace):
    """Time-ordered merge of component traces (composition operator)."""

    def __init__(self, *traces: Trace):
        self.traces = traces

    def __iter__(self) -> Iterator[Arrival]:
        # attrgetter, not a lambda: heapq.merge evaluates the key once per
        # yielded event, and the C-level getter shaves ~0.2us each — a
        # micro-regression that compounds at million-event scale
        return heapq.merge(*self.traces, key=operator.attrgetter("t_s"))


class _MixTrace(Trace):
    """Shared machinery: per-chunk tenant assignment over mix weights."""

    def __init__(self, mix: Sequence[TenantSpec], events: int, seed: int = 0,
                 start_s: float = 0.0):
        if not mix:
            raise ValueError("tenant mix must be non-empty")
        if events < 0:
            raise ValueError(f"events must be >= 0, got {events}")
        self.mix = list(mix)
        self.events = int(events)
        self.seed = seed
        self.start_s = float(start_s)
        w = np.array([s.weight for s in self.mix], np.float64)
        if np.any(w < 0) or w.sum() <= 0:
            raise ValueError("spec weights must be non-negative with a positive sum")
        self._cum_w = np.cumsum(w / w.sum())
        # float cumsum can land one ULP below 1.0 — exactly the largest
        # value rng.random() can draw, which would searchsorted past the
        # last spec; pin the tail so every draw lands in range
        self._cum_w[-1] = 1.0

    def _init_state(self, rng: np.random.Generator) -> dict:
        """Per-iteration generator state (kept off the instance so two
        concurrent iterations of one trace object stay independent)."""
        return {}

    def _times(self, rng: np.random.Generator, n: int, t0: float,
               state: dict) -> np.ndarray:
        """Return ``n`` monotone arrival times starting after ``t0``."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[Arrival]:
        mix = self.mix
        for times, idx, _costs, _table in self.iter_chunks():
            for t, i in zip(times, idx):
                spec = mix[i]
                yield Arrival(float(t), spec, spec.cost)

    def iter_chunks(self) -> Iterator[TraceChunk]:
        """Vectorized chunk path: the same RNG draws and chunk boundaries
        as the historical per-event iterator (``t0`` restarts each block
        from ``float(times[-1])``, so block size is part of the float
        accumulation and must stay ``_CHUNK``), minus the per-event
        namedtuple hop."""
        rng = np.random.default_rng(self.seed)
        mix, cum_w = self.mix, self._cum_w
        costs = np.array([s.cost for s in mix], np.float64)
        state = self._init_state(rng)
        remaining, t0 = self.events, self.start_s
        while remaining > 0:
            n = min(_CHUNK, remaining)
            times = self._times(rng, n, t0, state)
            idx = np.searchsorted(cum_w, rng.random(n), side="right")
            yield times, idx.astype(np.int64, copy=False), costs[idx], mix
            t0 = float(times[-1])
            remaining -= n


class PoissonTrace(_MixTrace):
    """Homogeneous Poisson arrivals at ``rate_hz`` over the mix."""

    def __init__(self, mix: Sequence[TenantSpec], rate_hz: float, events: int,
                 seed: int = 0, start_s: float = 0.0):
        super().__init__(mix, events, seed, start_s)
        if rate_hz <= 0:
            raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
        self.rate_hz = float(rate_hz)

    def _times(self, rng, n, t0, state):
        return t0 + np.cumsum(rng.exponential(1.0 / self.rate_hz, n))


class MarkovModulatedTrace(_MixTrace):
    """2-state MMPP: Poisson at ``calm_hz``/``burst_hz`` with exponential
    dwell times — the classic bursty-traffic model."""

    def __init__(self, mix: Sequence[TenantSpec], calm_hz: float, burst_hz: float,
                 events: int, mean_calm_s: float = 1.0, mean_burst_s: float = 0.2,
                 seed: int = 0, start_s: float = 0.0):
        super().__init__(mix, events, seed, start_s)
        if calm_hz <= 0 or burst_hz <= 0:
            raise ValueError("state rates must be > 0")
        self.rates = (float(calm_hz), float(burst_hz))
        self.dwells = (float(mean_calm_s), float(mean_burst_s))

    def _init_state(self, rng):
        return {"regime": 0,
                "next_switch": self.start_s + rng.exponential(self.dwells[0])}

    def _times(self, rng, n, t0, state):
        out = np.empty(n, np.float64)
        t, k = t0, 0
        regime, next_switch = state["regime"], state["next_switch"]
        while k < n:
            t = t + rng.exponential(1.0 / self.rates[regime])
            while t >= next_switch:
                # first-order regime change: restart the inter-arrival gap
                # at the switch point under the new state's rate
                regime = 1 - regime
                t = next_switch + rng.exponential(1.0 / self.rates[regime])
                next_switch = next_switch + rng.exponential(self.dwells[regime])
            out[k] = t
            k += 1
        state["regime"], state["next_switch"] = regime, next_switch
        return out


class _ThinnedTrace(_MixTrace):
    """Non-homogeneous Poisson via Lewis-Shedler thinning against a
    constant majorant rate."""

    peak_hz: float = 1.0

    def _rate_at(self, t: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _times(self, rng, n, t0, state):
        out = np.empty(n, np.float64)
        filled, t = 0, t0
        while filled < n:
            cand = t + np.cumsum(rng.exponential(1.0 / self.peak_hz, max(n - filled, 64)))
            keep = cand[rng.random(cand.shape[0]) * self.peak_hz < self._rate_at(cand)]
            take = min(keep.shape[0], n - filled)
            out[filled:filled + take] = keep[:take]
            filled += take
            t = float(cand[-1])
        return out


class DiurnalTrace(_ThinnedTrace):
    """Sinusoidal rate between ``trough_hz`` and ``peak_hz`` with period
    ``period_s`` — the day/night load curve, time-compressed."""

    def __init__(self, mix: Sequence[TenantSpec], trough_hz: float, peak_hz: float,
                 period_s: float, events: int, seed: int = 0, start_s: float = 0.0):
        super().__init__(mix, events, seed, start_s)
        if not (0 < trough_hz <= peak_hz):
            raise ValueError("need 0 < trough_hz <= peak_hz")
        self.trough_hz, self.peak_hz = float(trough_hz), float(peak_hz)
        self.period_s = float(period_s)

    def _rate_at(self, t):
        mid = (self.peak_hz + self.trough_hz) / 2.0
        amp = (self.peak_hz - self.trough_hz) / 2.0
        return mid + amp * np.sin(2.0 * math.pi * t / self.period_s)


class FlashCrowdTrace(_ThinnedTrace):
    """Constant ``base_hz`` plus a ``spike_hz`` window — launch-day load."""

    def __init__(self, mix: Sequence[TenantSpec], base_hz: float, spike_hz: float,
                 spike_start_s: float, spike_duration_s: float, events: int,
                 seed: int = 0, start_s: float = 0.0):
        super().__init__(mix, events, seed, start_s)
        if not (0 < base_hz <= spike_hz):
            raise ValueError("need 0 < base_hz <= spike_hz")
        self.base_hz, self.peak_hz = float(base_hz), float(spike_hz)
        self.spike = (float(spike_start_s), float(spike_start_s + spike_duration_s))

    def _rate_at(self, t):
        lo, hi = self.spike
        return np.where((t >= lo) & (t < hi), self.peak_hz, self.base_hz)


class CsvReplayTrace(Trace):
    """Replay recorded arrivals: rows of ``t_s,spec_index`` (or
    ``t_s,spec_name``) against a tenant mix.

    ``rows`` may be a path to a CSV file or any iterable of strings —
    production trace replay without a separate code path.
    """

    def __init__(self, mix: Sequence[TenantSpec], rows):
        self.mix = list(mix)
        self.rows = rows
        self._by_name = {s.name: s for s in self.mix}

    def _resolve(self, token: str) -> TenantSpec:
        token = token.strip()
        if token in self._by_name:
            return self._by_name[token]
        return self.mix[int(token)]

    def __iter__(self) -> Iterator[Arrival]:
        rows: Iterable[str]
        close = None
        if isinstance(self.rows, str):
            fh = open(self.rows)
            rows, close = fh, fh.close
        else:
            rows = self.rows
        try:
            last_t = -math.inf
            for line in rows:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t_str, spec_str = line.split(",")[:2]
                t = float(t_str)
                if t < last_t:
                    raise ValueError(f"CSV trace times must be non-decreasing ({t} < {last_t})")
                last_t = t
                spec = self._resolve(spec_str)
                yield Arrival(t, spec, spec.cost)
        finally:
            if close is not None:
                close()


# --------------------------------------------------------------- tenant mixes
def paper_sgemm_mix(
    tenants: int,
    slo_tiers_s: Sequence[float] = (0.005, 0.010, 0.025),
    shapes: Optional[Sequence[str]] = None,
    dtype: str = "float32",
) -> List[TenantSpec]:
    """Kernel-level mix: each tenant repeatedly launches one of the paper's
    Table-1 SGEMM geometries under a tiered SLO.

    Buckets are real ``ShapeBucket`` keys and merge families match
    ``GemmProblem.merge_family``, so a cost model calibrated on live
    ``dynamic_trace`` dispatches prices these simulated batches directly.
    """
    names = list(shapes or PAPER_GEMM_SHAPES)
    dt_bytes = 4 if dtype == "float32" else 2
    out = []
    for t in range(tenants):
        g = PAPER_GEMM_SHAPES[names[t % len(names)]]
        bucket = ShapeBucket("gemm", g.M, g.K, g.N, dtype)
        out.append(TenantSpec(
            tenant_id=t,
            name=f"t{t}/{g.name}",
            bucket=bucket,
            cost=float(g.flops),
            flops=float(g.flops),
            bytes=float(dt_bytes * (g.M * g.K + g.K * g.N + g.M * g.N)),
            slo_s=float(slo_tiers_s[t % len(slo_tiers_s)]),
            kind="kernel",
            merge_family=(bucket.op, bucket.K, bucket.N, bucket.dtype),
        ))
    return out


def fleet_sgemm_mix(
    tenants: int,
    zipf_a: float = 1.1,
    slo_tiers_s: Sequence[float] = (0.005, 0.010, 0.025),
    shapes: Optional[Sequence[str]] = None,
    dtype: str = "float32",
) -> List[TenantSpec]:
    """Fleet-scale mix: many tenants with Zipf-distributed arrival shares.

    Same Table-1 GEMM tenants as ``paper_sgemm_mix``, but tenant t's
    arrival weight is ``(t+1)^-zipf_a`` — a few hot tenants dominate the
    stream, the long tail trickles. That skew is what makes fleet routing
    a real decision: sticky/affinity policies keep a hot tenant's compiled
    variants warm on few replicas, load balancers spread its traffic (and
    its compiles) everywhere. ``zipf_a=0`` recovers the uniform mix.
    """
    if zipf_a < 0.0:
        raise ValueError(f"zipf_a must be >= 0, got {zipf_a}")
    return [
        dataclasses.replace(spec, weight=float((t + 1) ** -zipf_a))
        for t, spec in enumerate(
            paper_sgemm_mix(tenants, slo_tiers_s=slo_tiers_s,
                            shapes=shapes, dtype=dtype))
    ]


def prefill_decode_mix(
    tenants: int,
    prompt_tokens: int = 128,
    decode_slots: int = 4,
    active_params: float = 1.6e9,
    decode_slo_s: float = 0.020,
    prefill_slo_s: float = 0.250,
    decode_per_prefill: float = 64.0,
    dtype_bytes: int = 2,
) -> List[TenantSpec]:
    """Engine-shaped cohort mix: per tenant, a rare prefill stream plus a
    frequent decode-step stream, bucketed exactly as ``MultiTenantEngine``
    submits them (prefills merge by prompt length, decode cohorts share one
    bucket). Decode is weight-streaming memory-bound; prefill is
    compute-heavy — the roofline prior prices them accordingly.
    """
    out = []
    param_bytes = active_params * dtype_bytes
    for t in range(tenants):
        out.append(TenantSpec(
            tenant_id=t,
            name=f"t{t}/prefill",
            bucket=("prefill", prompt_tokens),
            cost=float(prompt_tokens),
            flops=2.0 * active_params * prompt_tokens,
            bytes=param_bytes + 8.0 * prompt_tokens * dtype_bytes * 2048,
            slo_s=prefill_slo_s,
            kind="prefill",
            weight=1.0,
        ))
        out.append(TenantSpec(
            tenant_id=t,
            name=f"t{t}/decode",
            bucket=("decode", "cohort"),
            cost=float(decode_slots),
            flops=2.0 * active_params * decode_slots,
            bytes=param_bytes,
            slo_s=decode_slo_s,
            kind="decode",
            weight=decode_per_prefill,
        ))
    return out


def make_trace(
    process: str,
    mix: Sequence[TenantSpec],
    rate_hz: float,
    events: int,
    seed: int = 0,
) -> Trace:
    """Name-keyed trace factory (the CLI surface of this module)."""
    if process == "poisson":
        return PoissonTrace(mix, rate_hz, events, seed=seed)
    if process == "mmpp":
        return MarkovModulatedTrace(
            mix, calm_hz=rate_hz * 0.5, burst_hz=rate_hz * 3.0, events=events,
            mean_calm_s=2000.0 / rate_hz, mean_burst_s=400.0 / rate_hz, seed=seed)
    if process == "diurnal":
        return DiurnalTrace(
            mix, trough_hz=rate_hz * 0.25, peak_hz=rate_hz * 1.75,
            period_s=events / rate_hz / 4.0, events=events, seed=seed)
    if process == "flash":
        horizon = events / rate_hz
        return FlashCrowdTrace(
            mix, base_hz=rate_hz * 0.6, spike_hz=rate_hz * 4.0,
            spike_start_s=horizon * 0.4, spike_duration_s=horizon * 0.1,
            events=events, seed=seed)
    raise ValueError(f"unknown arrival process: {process!r}")

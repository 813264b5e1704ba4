"""Windowed time-series telemetry over a flight recording.

Folds the recorder's event columns into fixed-width windows (the
``ObservabilitySpec.window_s`` tick): arrivals / rejections / completions
per window, rolling p50/p95 latency, SLO attainment, end-of-window
backlog, busy seconds and utilization — fleet-wide plus per-tenant and
per-replica breakdowns. This is the rolling view the end-of-run
aggregates (``SimMetrics``) cannot express: you can see the flash crowd
arrive, the backlog build, the autoscaler catch up, and attainment
recover, window by window.

Everything is vectorized numpy over the columnar shards and merged in
replica-id order, so the series is a pure deterministic function of the
recording — identical for ``workers=1`` and ``workers=K`` fleet runs of
one seed (the shards are). Output is a plain JSON-able dict.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from repro_torch.obs.recorder import FlightRecorder

TELEMETRY_SCHEMA = "telemetry/v1"

# per-window percentile grid kept deliberately small: windows * series
# is the budget of every report that carries it
_PCTS = (50.0, 95.0)


def _empty(window_s: float) -> Dict:
    return {"schema": TELEMETRY_SCHEMA, "window_s": window_s,
            "windows": 0, "t0_s": 0.0, "arrivals": [], "rejected": [],
            "completed": [], "p50_ms": [], "p95_ms": [],
            "slo_attainment": [], "backlog": [], "busy_s": [],
            "utilization": [], "per_tenant": {}, "per_replica": {}}


def _cat(shards, attr, dtype) -> np.ndarray:
    parts = [np.asarray(getattr(s, attr), dtype) for s in shards]
    return np.concatenate(parts) if parts else np.zeros(0, dtype)


def _busy_per_window(t0: np.ndarray, dur: np.ndarray, lo: float,
                     w: float, n: int) -> np.ndarray:
    """Exact busy seconds per window from dispatch spans. Spans fully
    inside one window (the vast majority at realistic ticks) are binned
    vectorized; the rare window-straddlers are split exactly."""
    busy = np.zeros(n)
    if t0.size == 0:
        return busy
    t1 = t0 + dur
    w0 = np.clip(((t0 - lo) / w).astype(np.int64), 0, n - 1)
    w1 = np.clip(((t1 - lo) / w).astype(np.int64), 0, n - 1)
    inside = w0 == w1
    if inside.any():
        busy += np.bincount(w0[inside], weights=dur[inside], minlength=n)
    for s, e, a, b in zip(t0[~inside], t1[~inside], w0[~inside],
                          w1[~inside]):
        for k in range(a, b + 1):
            lo_k = lo + k * w
            busy[k] += min(e, lo_k + w) - max(s, lo_k)
    return busy


def windowed_series(rec: FlightRecorder, window_s: float) -> Dict:
    """Fold ``rec`` into fixed windows of ``window_s`` simulated seconds
    (wall seconds for live recordings); see module docstring for the
    series produced."""
    if window_s <= 0.0:
        raise ValueError(f"window_s must be > 0, got {window_s}")
    w = float(window_s)
    shards = [rec.shards[k] for k in sorted(rec.shards)]

    arr_t = _cat(shards, "_arr_t", np.float64)
    arr_adm = _cat(shards, "_arr_admitted", np.int64)
    req_t0 = _cat(shards, "_req_t0", np.float64)
    req_t1 = _cat(shards, "_req_t1", np.float64)
    req_slo = _cat(shards, "_req_slo", np.float64)
    req_tenant = _cat(shards, "_req_tenant", np.int64)
    dsp_t0 = _cat(shards, "_dsp_t0", np.float64)
    dsp_dur = _cat(shards, "_dsp_dur", np.float64)
    dsp_rid = np.concatenate(
        [np.full(s.n_dispatches, s.replica_id, np.int64) for s in shards]
    ) if shards else np.zeros(0, np.int64)

    bounds = [a for a in (arr_t, req_t1, dsp_t0) if a.size]
    if not bounds:
        return _empty(w)
    lo = min(float(a.min()) for a in bounds)
    hi = max(float(arr_t.max()) if arr_t.size else lo,
             float(req_t1.max()) if req_t1.size else lo,
             float((dsp_t0 + dsp_dur).max()) if dsp_t0.size else lo)
    n = max(1, int(math.ceil((hi - lo) / w))) if hi > lo else 1

    def widx(t: np.ndarray) -> np.ndarray:
        return np.clip(((t - lo) / w).astype(np.int64), 0, n - 1)

    def counts(t: np.ndarray) -> np.ndarray:
        if t.size == 0:
            return np.zeros(n, np.int64)
        return np.bincount(widx(t), minlength=n)

    arrivals = counts(arr_t)
    admitted = counts(arr_t[arr_adm == 1])
    rejected = arrivals - admitted
    completed = counts(req_t1)

    lat = req_t1 - req_t0
    met = (lat <= req_slo).astype(np.float64)
    cw = widx(req_t1) if req_t1.size else np.zeros(0, np.int64)

    p50 = np.zeros(n)
    p95 = np.zeros(n)
    attain = np.ones(n)
    if req_t1.size:
        order = np.argsort(cw, kind="stable")
        starts = np.searchsorted(cw[order], np.arange(n + 1))
        lat_sorted = lat[order]
        met_sums = np.bincount(cw, weights=met, minlength=n)
        for k in range(n):
            a, b = starts[k], starts[k + 1]
            if a < b:
                p50[k], p95[k] = np.percentile(lat_sorted[a:b], _PCTS)
                attain[k] = met_sums[k] / (b - a)

    backlog = np.cumsum(admitted) - np.cumsum(completed)
    busy = _busy_per_window(dsp_t0, dsp_dur, lo, w, n)
    n_replicas = max(1, len(shards))
    util = busy / (w * n_replicas)

    out = {
        "schema": TELEMETRY_SCHEMA,
        "window_s": w,
        "windows": n,
        "t0_s": lo,
        "arrivals": arrivals.tolist(),
        "rejected": rejected.tolist(),
        "completed": completed.tolist(),
        "p50_ms": (p50 * 1e3).tolist(),
        "p95_ms": (p95 * 1e3).tolist(),
        "slo_attainment": attain.tolist(),
        "backlog": backlog.tolist(),
        "busy_s": busy.tolist(),
        "utilization": util.tolist(),
        "per_tenant": {},
        "per_replica": {},
    }

    if req_t1.size:
        per_tenant: Dict[str, Dict[str, List]] = {}
        for t in np.unique(req_tenant):
            mask = req_tenant == t
            cw_t = cw[mask]
            done = np.bincount(cw_t, minlength=n).astype(np.float64)
            met_t = np.bincount(cw_t, weights=met[mask], minlength=n)
            at = np.divide(met_t, done, out=np.ones(n), where=done > 0)
            per_tenant[str(int(t))] = {
                "completed": done.astype(np.int64).tolist(),
                "slo_attainment": at.tolist(),
            }
        out["per_tenant"] = per_tenant

    per_replica: Dict[str, Dict[str, List]] = {}
    for s in shards:
        rid = s.replica_id
        mask = dsp_rid == rid
        per_replica[str(rid)] = {
            "busy_s": _busy_per_window(dsp_t0[mask], dsp_dur[mask],
                                       lo, w, n).tolist(),
            "dispatches": counts(dsp_t0[mask]).tolist(),
        }
    out["per_replica"] = per_replica
    return out

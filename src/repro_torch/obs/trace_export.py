"""Chrome ``trace_event`` JSON export of a flight recording.

Produces the JSON Object Format (``{"traceEvents": [...]}``) that
Perfetto (ui.perfetto.dev) and ``chrome://tracing`` load directly:

    pid 1  "replicas"   one thread per replica — dispatch spans ("X"),
                        named by bucket, with batch size R, cold/warm,
                        and strategy in args: the space-time packing
                        picture, cold starts visibly longer
    pid 2  "tenants"    one thread per tenant — request spans ("X") from
                        arrival to completion (queueing + service) with
                        SLO-met in args, plus admission-rejection
                        instants ("i"): interference as it happens
    pid 3  "control"    router decisions (with the price vector that
                        justified them), autoscale events, and partition
                        assign/replan events as instants

Timestamps are microseconds (the format's unit); simulated seconds map
as ``t_s * 1e6``. Export is a pure function of recorder contents built
in deterministic order (shards by replica id, rows in record order), so
same-seed runs export byte-identical JSON — the contract the trace
tests pin.
"""

from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.obs.recorder import FlightRecorder

PID_REPLICAS = 1
PID_TENANTS = 2
PID_CONTROL = 3
_TID_ROUTER = 0
_TID_AUTOSCALER = 1
_TID_PARTITION = 2


def _meta(pid: int, tid: int, name: str, value: str) -> Dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": name,
            "args": {"name": value}}


def chrome_trace_events(rec: FlightRecorder) -> List[Dict]:
    """The ``traceEvents`` list (metadata first, then spans/instants)."""
    events: List[Dict] = []
    add = events.append
    rids = sorted(rec.shards)

    # ------------------------------------------------------------ metadata
    add(_meta(PID_REPLICAS, 0, "process_name", "replicas"))
    add(_meta(PID_TENANTS, 0, "process_name", "tenants"))
    tenants: set = set()
    for rid in rids:
        s = rec.shards[rid]
        tenants.update(s._arr_tenant)
        tenants.update(s._req_tenant)
        label = f"replica {rid}"
        if s.spec_name:
            label += f" ({s.spec_name})"
        add(_meta(PID_REPLICAS, rid, "thread_name", label))
    tenants.update(rec._rt_tenant)
    for t in sorted(tenants):
        add(_meta(PID_TENANTS, t, "thread_name", f"tenant {t}"))
    if rec.n_routes or rec.scale_events or rec.partition_events:
        add(_meta(PID_CONTROL, 0, "process_name", "control"))
        if rec.n_routes:
            name = "router"
            if rec.router_name:
                name += f" ({rec.router_name})"
            add(_meta(PID_CONTROL, _TID_ROUTER, "thread_name", name))
        if rec.scale_events:
            add(_meta(PID_CONTROL, _TID_AUTOSCALER, "thread_name",
                      "autoscaler"))
        if rec.partition_events:
            add(_meta(PID_CONTROL, _TID_PARTITION, "thread_name",
                      "partitioner"))

    # ------------------------------------------------- per-replica shards
    for rid in rids:
        s = rec.shards[rid]
        labels = s._bucket_labels
        strategy = s.strategy
        for t0, dur, bi, size, cold in zip(s._dsp_t0, s._dsp_dur,
                                           s._dsp_bucket, s._dsp_size,
                                           s._dsp_cold):
            args = {"batch": size, "cold": bool(cold)}
            if strategy:
                args["strategy"] = strategy
            add({"ph": "X", "pid": PID_REPLICAS, "tid": rid,
                 "ts": t0 * 1e6, "dur": dur * 1e6, "cat": "dispatch",
                 "name": labels[bi], "args": args})
        for t0, t1, tenant, slo, bi in zip(s._req_t0, s._req_t1,
                                           s._req_tenant, s._req_slo,
                                           s._req_bucket):
            lat = t1 - t0
            add({"ph": "X", "pid": PID_TENANTS, "tid": tenant,
                 "ts": t0 * 1e6, "dur": lat * 1e6, "cat": "request",
                 "name": labels[bi],
                 "args": {"replica": rid, "slo_ms": slo * 1e3,
                          "met": lat <= slo}})
        for t, tenant, bi, admitted, reason in zip(
                s._arr_t, s._arr_tenant, s._arr_bucket, s._arr_admitted,
                s._arr_reason):
            if not admitted:
                add({"ph": "i", "pid": PID_TENANTS, "tid": tenant,
                     "ts": t * 1e6, "s": "t", "cat": "admission",
                     "name": ("rejected_infeasible" if reason == 3
                              else "rejected"),
                     "args": {"bucket": labels[bi], "replica": rid}})
            elif reason == 1:
                add({"ph": "i", "pid": PID_TENANTS, "tid": tenant,
                     "ts": t * 1e6, "s": "t", "cat": "admission",
                     "name": "oversubscribed",
                     "args": {"bucket": labels[bi], "replica": rid}})
        for t, tenant, bi, est, victims in zip(
                s._pre_t, s._pre_tenant, s._pre_bucket, s._pre_est,
                s._pre_victims):
            add({"ph": "i", "pid": PID_REPLICAS, "tid": rid,
                 "ts": t * 1e6, "s": "t", "cat": "preemption",
                 "name": "preempt",
                 "args": {"bucket": labels[bi], "tenant": tenant,
                          "est_ms": est * 1e3, "victims": victims}})

    # --------------------------------------------------------- fleet level
    off = 0
    for i in range(rec.n_routes):
        n = rec._rt_n[i]
        args: Dict = {"tenant": rec._rt_tenant[i]}
        if n:
            args["prices"] = {
                f"r{rec._rt_price_rid[off + j]}": rec._rt_price[off + j]
                for j in range(n)}
            off += n
        add({"ph": "i", "pid": PID_CONTROL, "tid": _TID_ROUTER,
             "ts": rec._rt_t[i] * 1e6, "s": "t", "cat": "router",
             "name": f"route->r{rec._rt_chosen[i]}", "args": args})
    for ev in rec.scale_events:
        add({"ph": "i", "pid": PID_CONTROL, "tid": _TID_AUTOSCALER,
             "ts": ev["t_s"] * 1e6, "s": "p", "cat": "autoscale",
             "name": f"scale_{ev['action']}", "args": dict(ev)})
    for ev in rec.partition_events:
        add({"ph": "i", "pid": PID_CONTROL, "tid": _TID_PARTITION,
             "ts": ev["t_s"] * 1e6, "s": "p", "cat": "partition",
             "name": f"partition_{ev['action']}", "args": dict(ev)})
    return events


def export_chrome_trace(rec: FlightRecorder) -> str:
    """Canonical (sorted-keys, compact) JSON document — byte-identical
    per seed, Perfetto-loadable."""
    doc = {"displayTimeUnit": "ms", "traceEvents": chrome_trace_events(rec)}
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))

"""Sharded fleet execution: replica pumps partitioned across processes.

Round-robin routing makes replicas independent: arrival ``j`` goes to
replica ``j mod N`` regardless of any replica's state, so each replica's
entire trajectory (admission, batching, dispatch instants, completions)
is a pure function of the trace subsequence it owns. ``run_sharded``
exploits that: it partitions the replica ids across ``workers`` forked
processes, runs every replica to completion independently against its
own slice of the (re-generated, seeded) trace, and merges the
per-replica completion streams back into the exact global absorb order
the single-process event loop would have produced — same seed, same
JSON bytes.

**Merge keys.** Each replica-local absorb is tagged at record time:

* ``(t_j, 0, j)``   — dispatch triggered by submitting global arrival
  ``j`` at trace time ``t_j``;
* ``(tau, 1, rid)`` — dispatch at ripeness instant ``tau`` during a
  drain phase;
* ``(inf, 2, rid)`` — the force-flush fallback at the very end.

The single-process fleet loop interleaves replicas as: drain every
instant strictly before each arrival (earliest instant first, lowest
replica id on ties), then run the submit itself; the tail drains
ascending instants and flushes in replica order. That interleaving is
exactly ascending order of the keys above (drain instants between
consecutive arrivals satisfy ``t_j <= tau < t_{j+1}`` with the phase
bit breaking the ``tau == t_j`` tie the right way), so one sort of the
recorded events reconstructs the global stream — including the merged
accumulator's float-accumulation order and its kind-interning order,
which is why the bytes match rather than just the statistics.

**Why the restrictions.** The independence argument needs routing and
pricing to never read cross-replica state: a fresh ``round_robin``
router (state-oblivious assignment), no autoscaler (scale decisions
read fleet-wide occupancy), no calibration (the shared table couples
replicas through observed dispatches), and a stable-window policy (the
ripeness calendar guarantees instant-pumps dispatch, so the
single-process stall/retry interleaving — which IS cross-replica —
never arises). ``run_sharded`` validates all of these up front and
raises with the fix rather than silently diverging.

Workers prefer the ``fork`` start method (the parent's built fleet and
trace are inherited by reference — nothing is pickled going in; only
the compact per-replica results come back). Where ``fork`` is
unavailable the shards run sequentially in-process: same bytes, no
parallelism.
"""

from __future__ import annotations

import math
import multiprocessing
import queue as queue_mod
import traceback
from typing import Dict, Iterator, List, Tuple

import numpy as np

from repro_torch.sim.metrics import FleetMetrics, MetricsAccumulator
from repro_torch.sim.router import RoundRobinRouter
from repro_torch.sim.simulator import SimWorkload
from repro_torch.sim.traces import Trace

_FLUSH_KEY = math.inf


def _validate(fleet, trace) -> None:
    """Reject configurations whose replicas are not provably independent."""
    if not isinstance(fleet.router, RoundRobinRouter):
        raise ValueError(
            f"workers>1 requires the 'round_robin' router — state-oblivious "
            f"assignment is what makes replicas independent; got "
            f"{fleet.router.name!r}. Use workers=1 for state-aware routing.")
    if fleet.router._next != 0:
        raise ValueError(
            "workers>1 needs a FRESH round-robin router (no prior route() "
            "calls); build a new FleetSimulator per run")
    if fleet.autoscaler is not None:
        raise ValueError(
            "workers>1 is incompatible with autoscaling: scale decisions "
            "read fleet-wide replica state. Use workers=1.")
    if fleet.calibration is not None:
        raise ValueError(
            "workers>1 is incompatible with fleet calibration: the shared "
            "table couples replicas through observed dispatches. "
            "Use workers=1.")
    if not fleet.pumps or not getattr(
            fleet.pumps[0].scheduler.policy, "stable_window", False):
        raise ValueError(
            "workers>1 requires a stable-window batching policy "
            "(policy='fixed'): slack-adaptive and deadline-aware policies "
            "need the merged single-process timeline. Use workers=1.")
    sched0 = fleet.pumps[0].scheduler.schedule
    if sched0.admission_policy != "cap":
        raise ValueError(
            "workers>1 requires admission_policy='cap': feasibility "
            "admission prices against a replica's committed horizon, which "
            "the stalled-replica interleaving couples across shards. "
            "Use workers=1.")
    if not isinstance(trace, Trace):
        raise ValueError(
            "workers>1 needs a re-iterable Trace (each worker regenerates "
            f"its shard from the seed); got {type(trace).__name__}. "
            "Use workers=1 for ad-hoc arrival iterables.")


def _owned_arrivals(trace: Trace, rid: int,
                    n_replicas: int) -> Iterator[Tuple[int, float, object, float]]:
    """Yield ``(j, t_s, spec, cost)`` for the arrivals round-robin routes
    to replica ``rid`` — the strided slice ``j % N == rid`` of the chunked
    columns, without materializing the other replicas' events."""
    offset = 0
    for times, idx, costs, table in trace.iter_chunks():
        n = len(times)
        k0 = (rid - offset) % n_replicas
        if k0 < n:
            ts = times[k0::n_replicas].tolist()
            ii = idx[k0::n_replicas].tolist()
            cs = costs[k0::n_replicas].tolist()
            for k, t, i, c in zip(range(offset + k0, offset + n, n_replicas),
                                  ts, ii, cs):
                yield k, t, table[i], c
        offset += n


def _run_replica(pump, rid: int, trace: Trace, n_replicas: int) -> Dict:
    """Drive one replica over its owned arrivals exactly as the merged
    loop would (drain instants strictly before each arrival, submit,
    drain-then-flush tail), recording a merge key per absorb."""
    acc = MetricsAccumulator()
    pump.accs = [acc]
    events: List[Tuple[float, int, int, int]] = []  # (t, phase, tiebreak, n)
    # (j, t, tenant) per owned arrival when recording — the merge replays
    # these in global arrival order to rebuild the fleet route timeline
    routes: List[Tuple[int, float, int]] = []
    recording = pump.recorder is not None
    routed = 0
    next_ripe = pump.next_ripe_time
    pump_at = pump.pump_at
    submit = pump.submit
    estimate = pump.estimate_item_s

    for j, t, spec, cost in _owned_arrivals(trace, rid, n_replicas):
        if recording:
            routes.append((j, t, spec.tenant_id))
        while True:
            tau = next_ripe()
            if tau is None or tau >= t:
                break
            done = pump_at(tau)
            if not done:
                break  # stalled until arrivals resume (merged-loop parity)
            events.append((tau, 1, rid, len(done)))
        w = SimWorkload(spec, cost)
        w.est_s = estimate(w)
        before = len(acc)
        if submit(w, t):
            routed += 1
        n_done = len(acc) - before
        if n_done:
            events.append((t, 0, j, n_done))

    sched = pump.scheduler
    while len(sched.queue):
        tau = next_ripe()
        done = pump_at(tau) if tau is not None else []
        if done:
            events.append((tau, 1, rid, len(done)))
        else:
            before = len(acc)
            pump._absorb(sched.flush())
            n_done = len(acc) - before
            if n_done:
                events.append((_FLUSH_KEY, 2, rid, n_done))
            break

    stats = sched.stats
    model = pump.cost_model
    cold_times = getattr(model, "dispatch_times", None)
    cold_flags = getattr(model, "dispatch_cold", None)
    kinds = acc._kinds
    return {
        "rid": rid,
        "events": events,
        "lat": acc._lat, "slo": acc._slo, "cost": acc._cost,
        "tenant": acc._tenant, "kind_idx": acc._kind_idx,
        "kinds": [k for k, _ in sorted(kinds.items(), key=lambda kv: kv[1])],
        "busy": stats.busy_time_s,
        "dispatches": stats.dispatches,
        "rejected": stats.rejected,
        "evicted": len(sched.evicted),
        "clock_end": pump.clock.now(),
        "routed": routed,
        "spec_name": pump.spec_name,
        "cold_times": cold_times,
        "cold_flags": cold_flags,
        "ripe_nudges": stats.ripe_nudges,
        "deadline_rejected": stats.deadline_rejected,
        "oversubscribed": stats.oversubscribed,
        "preemptions": stats.preemptions,
        "obs": pump.recorder.payload() if recording else None,
        "routes": routes,
    }


def _worker_main(fleet, trace, rids, n_replicas, wid, out_q) -> None:
    try:
        res = [_run_replica(fleet.pumps[rid], rid, trace, n_replicas)
               for rid in rids]
        out_q.put((wid, "ok", res))
    except BaseException:
        out_q.put((wid, "err", traceback.format_exc()))


def _collect(procs, out_q) -> List[Dict]:
    results: List[Dict] = []
    got: set = set()
    while len(got) < len(procs):
        try:
            wid, tag, payload = out_q.get(timeout=1.0)
        except queue_mod.Empty:
            dead = [p for i, p in enumerate(procs)
                    if i not in got and not p.is_alive()
                    and p.exitcode not in (0, None)]
            if dead:
                raise RuntimeError(
                    f"shard worker died without reporting "
                    f"(exitcode {dead[0].exitcode})")
            continue
        if tag == "err":
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise RuntimeError(f"shard worker {wid} failed:\n{payload}")
        got.add(wid)
        results.extend(payload)
    for p in procs:
        p.join()
    return results


def _merge(fleet, shards: List[Dict], t_start: float) -> FleetMetrics:
    """Rebuild the single-process ``FleetMetrics`` from per-replica
    shard payloads: per-replica sections verbatim, the merged section by
    replaying absorbs in sorted merge-key order (so float accumulation
    and kind interning match the merged accumulator byte-for-byte)."""
    shards = sorted(shards, key=lambda s: s["rid"])
    horizon = max((s["clock_end"] for s in shards if s["dispatches"] > 0),
                  default=t_start) - t_start

    per_replica = []
    for s in shards:
        acc = MetricsAccumulator()
        acc._lat, acc._slo, acc._cost = s["lat"], s["slo"], s["cost"]
        acc._tenant, acc._kind_idx = s["tenant"], s["kind_idx"]
        acc._kinds = {k: i for i, k in enumerate(s["kinds"])}
        per_replica.append(acc.freeze(
            sim_duration_s=horizon, busy_time_s=s["busy"],
            dispatches=s["dispatches"], rejected=s["rejected"],
            evicted_tenants=s["evicted"],
            ripe_nudges=s["ripe_nudges"],
            deadline_rejected=s["deadline_rejected"],
            oversubscribed=s["oversubscribed"],
            preemptions=s["preemptions"]))

    merged = MetricsAccumulator()
    mkinds = merged._kinds
    evs: List[Tuple[float, int, int, int, int]] = []
    for s in shards:
        rid = s["rid"]
        evs.extend((t, ph, tb, rid, n) for (t, ph, tb, n) in s["events"])
    evs.sort(key=lambda e: (e[0], e[1], e[2]))
    cursors = [0] * len(shards)
    remap: List[Dict[int, int]] = [{} for _ in shards]
    for t, ph, tb, rid, n in evs:
        s = shards[rid]
        i = cursors[rid]
        j = i + n
        cursors[rid] = j
        merged._lat.extend(s["lat"][i:j])
        merged._slo.extend(s["slo"][i:j])
        merged._cost.extend(s["cost"][i:j])
        merged._tenant.extend(s["tenant"][i:j])
        rmap = remap[rid]
        kinds_r = s["kinds"]
        out = []
        for ki in s["kind_idx"][i:j]:
            mi = rmap.get(ki)
            if mi is None:
                name = kinds_r[ki]
                mi = mkinds.get(name)
                if mi is None:
                    mi = len(mkinds)
                    mkinds[name] = mi
                rmap[ki] = mi
            out.append(mi)
        merged._kind_idx.extend(out)
    for s, cur in zip(shards, cursors):
        if cur != len(s["lat"]):
            raise RuntimeError(
                f"shard merge inconsistency: replica {s['rid']} recorded "
                f"{len(s['lat'])} completions but events account for {cur}")

    merged_metrics = merged.freeze(
        sim_duration_s=horizon,
        busy_time_s=sum(s["busy"] for s in shards),
        dispatches=sum(s["dispatches"] for s in shards),
        rejected=sum(s["rejected"] for s in shards),
        evicted_tenants=sum(s["evicted"] for s in shards),
        ripe_nudges=sum(s["ripe_nudges"] for s in shards),
        deadline_rejected=sum(s["deadline_rejected"] for s in shards),
        oversubscribed=sum(s["oversubscribed"] for s in shards),
        preemptions=sum(s["preemptions"] for s in shards),
    )

    if fleet.recorder is not None:
        _merge_recording(fleet.recorder, fleet.router.name, shards)

    times = [np.asarray(s["cold_times"], np.float64) for s in shards
             if s["cold_times"] is not None]
    flags = [np.asarray(s["cold_flags"], np.int64) for s in shards
             if s["cold_flags"] is not None]
    if times:
        t = np.concatenate(times)
        f = np.concatenate(flags)
        order = np.argsort(t, kind="stable")
        cold_times, cold_flags = t[order], f[order]
    else:
        cold_times = np.zeros(0, np.float64)
        cold_flags = np.zeros(0, np.int64)

    routed_counts = [s["routed"] for s in shards]
    fleet.routed_counts = list(routed_counts)
    return FleetMetrics(
        merged=merged_metrics,
        per_replica=per_replica,
        routed_counts=routed_counts,
        router=fleet.router.name,
        cold_times=cold_times,
        cold_flags=cold_flags,
        scale_events=fleet.scale_events,
        replica_specs=[s["spec_name"] for s in shards],
        final_active=len(shards),
    )


def _merge_recording(rec, router_name: str, shards: List[Dict]) -> None:
    """Reassemble the fleet's flight recording from worker payloads:
    per-replica shards verbatim (their trajectories are identical to the
    single-process run), fleet-level route rows replayed in global
    arrival order. Round-robin routing records empty price vectors by
    design, so the replay is byte-equal to live recording; scale events
    cannot occur (sharding forbids autoscaling)."""
    from repro_torch.obs.recorder import ReplicaShard

    for s in shards:
        if s["obs"] is not None:
            rec.shards[s["rid"]] = ReplicaShard.from_payload(s["obs"])
    all_routes: List[Tuple[int, float, int, int]] = []
    for s in shards:
        all_routes.extend((j, t, tenant, s["rid"])
                          for (j, t, tenant) in s["routes"])
    all_routes.sort(key=lambda r: r[0])
    for _, t, tenant, rid in all_routes:
        rec.record_route(t, tenant, rid)
    rec.router_name = router_name


def run_sharded(fleet, trace) -> FleetMetrics:
    """Run ``fleet`` over ``trace`` with its replicas partitioned across
    ``fleet.workers`` processes; returns the same ``FleetMetrics`` (same
    JSON bytes) as the single-process event loop."""
    _validate(fleet, trace)
    n = len(fleet.pumps)
    k = min(fleet.workers, n)
    shards_rids = [[rid for rid in range(n) if rid % k == w] for w in range(k)]

    try:
        ctx = multiprocessing.get_context("fork")
    except ValueError:
        ctx = None

    if ctx is None or k == 1:
        results = [_run_replica(fleet.pumps[rid], rid, trace, n)
                   for rid in range(n)]
    else:
        out_q = ctx.Queue()
        procs = [ctx.Process(target=_worker_main,
                             args=(fleet, trace, rids, n, wid, out_q),
                             daemon=True)
                 for wid, rids in enumerate(shards_rids)]
        for p in procs:
            p.start()
        results = _collect(procs, out_q)

    return _merge(fleet, results, fleet.start_s)

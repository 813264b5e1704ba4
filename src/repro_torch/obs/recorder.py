"""Columnar flight recorder: typed events from every decision point.

``FlightRecorder`` is the zero-overhead-when-off event store a simulator
or fleet takes as ``recorder=``: when no recorder is attached the hot paths pay a
single ``is None`` test (the solo chunked loop hoists even that out);
when attached, events land in per-replica ``ReplicaShard``s as columnar
``array`` appends with interned bucket labels — the same batched-absorb
discipline as ``MetricsAccumulator.add_batch``, so recorder-on runs stay
within a small constant factor of recorder-off ones.

Event families and where they are emitted:

    arrival / admission   ``ReplicaPump.submit`` (and the solo chunked
                          intake), one row per arrival with the admitted
                          flag — rejections are the admission-control
                          story made visible
    dispatch span         the scheduler's ``on_dispatch`` tap (see
                          ``dispatch_tap``): completion instant, modeled
                          seconds, bucket, batch size R, cold/warm from
                          the replica's ``ColdStartCostModel``, strategy
    request span          per item of a dispatch (``per_request=True``):
                          arrival -> completion with tenant, SLO, bucket
    route decision        ``FleetSimulator.run``: chosen replica plus the
                          per-replica price vector that justified it
                          (``route_price_vector``)
    scale event           the autoscale timeline, verbatim

Determinism: shards are keyed by replica id and filled in each replica's
own event order, fleet-level routes in global arrival order — both pure
functions of the seeded trace. The sharded fleet (``repro_torch.sim.shard``)
ships each shard's columns back from its worker process and replays
route rows in arrival order, so ``workers=K`` produces byte-identical
exports to ``workers=1``. Read paths: ``repro_torch.obs.trace_export`` (Chrome
``trace_event`` JSON, Perfetto-loadable) and ``repro_torch.obs.telemetry``
(windowed time series).
"""

from __future__ import annotations

from array import array
from typing import Dict, Hashable, List, Optional, Sequence, Tuple


def bucket_label(bucket) -> str:
    """Compact human-readable label for a shape bucket (interned once
    per distinct bucket, so this can afford to be pretty)."""
    op = getattr(bucket, "op", None)
    if op is not None and hasattr(bucket, "M"):
        return (f"{op} {bucket.M}x{bucket.K}x{bucket.N} "
                f"{getattr(bucket, 'dtype', '')}".rstrip())
    if isinstance(bucket, tuple):
        return "/".join(str(p) for p in bucket)
    return str(bucket)


class ReplicaShard:
    """One replica's event columns (the per-replica unit of determinism:
    identical between single-process and sharded fleet execution)."""

    def __init__(self, replica_id: int, per_request: bool = True):
        self.replica_id = replica_id
        self.per_request = per_request
        self.spec_name: Optional[str] = None
        self.strategy: Optional[str] = None
        self._bucket_index: Dict[Hashable, int] = {}
        self._bucket_labels: List[str] = []
        # arrivals (one row per routed arrival, admitted or not); reason
        # codes mirror scheduler.admit_reason: 0 admit, 1 oversubscribed
        # admit, 2 pending-cap reject, 3 infeasible-deadline reject
        self._arr_t = array("d")
        self._arr_tenant = array("l")
        self._arr_bucket = array("l")
        self._arr_admitted = array("b")
        self._arr_reason = array("b")
        # preemptions (one row per ahead-of-window force-dispatch)
        self._pre_t = array("d")
        self._pre_tenant = array("l")
        self._pre_bucket = array("l")
        self._pre_est = array("d")
        self._pre_victims = array("l")
        # dispatch spans (one row per super-dispatch)
        self._dsp_t0 = array("d")
        self._dsp_dur = array("d")
        self._dsp_bucket = array("l")
        self._dsp_size = array("l")
        self._dsp_cold = array("b")
        # request spans (one row per completed item; per_request only)
        self._req_t0 = array("d")
        self._req_t1 = array("d")
        self._req_tenant = array("l")
        self._req_slo = array("d")
        self._req_bucket = array("l")

    # -------------------------------------------------------------- intern
    def _intern(self, bucket) -> int:
        idx = self._bucket_index
        bi = idx.get(bucket)
        if bi is None:
            bi = len(self._bucket_labels)
            idx[bucket] = bi
            self._bucket_labels.append(bucket_label(bucket))
        return bi

    # ------------------------------------------------------------- record
    def record_arrival(self, t_s: float, tenant_id: int, bucket,
                       admitted: bool, reason: int = 0) -> None:
        self._arr_t.append(t_s)
        self._arr_tenant.append(tenant_id)
        self._arr_bucket.append(self._intern(bucket))
        self._arr_admitted.append(1 if admitted else 0)
        self._arr_reason.append(reason)

    def record_preempt(self, t_s: float, tenant_id: int, bucket,
                       est_s: float, victims: int) -> None:
        """One EDF preemption: an unripe bucket force-dispatched because
        waiting out its window would miss its deadline, jumping ahead of
        ``victims`` ripe cohorts at priced cost ``est_s``."""
        self._pre_t.append(t_s)
        self._pre_tenant.append(tenant_id)
        self._pre_bucket.append(self._intern(bucket))
        self._pre_est.append(est_s)
        self._pre_victims.append(victims)

    def record_dispatch(self, t1_s: float, dur_s: float, batch: Sequence,
                        cold: bool) -> None:
        """Absorb one super-dispatch: span row plus (optionally) one
        request-span row per item, column-at-a-time like
        ``MetricsAccumulator.add_batch``."""
        index = self._bucket_index
        try:
            bis = [index[w.bucket] for w in batch]
        except KeyError:
            bis = [self._intern(w.bucket) for w in batch]
        self._dsp_t0.append(t1_s - dur_s)
        self._dsp_dur.append(dur_s)
        self._dsp_bucket.append(bis[0])
        self._dsp_size.append(len(batch))
        self._dsp_cold.append(1 if cold else 0)
        if self.per_request:
            self._req_t0.extend([w.arrival_time for w in batch])
            self._req_t1.extend([w.completion_time for w in batch])
            self._req_tenant.extend([w.tenant_id for w in batch])
            self._req_slo.extend([w.slo_s for w in batch])
            self._req_bucket.extend(bis)

    # -------------------------------------------------------------- sizing
    @property
    def n_arrivals(self) -> int:
        return len(self._arr_t)

    @property
    def n_dispatches(self) -> int:
        return len(self._dsp_t0)

    @property
    def n_requests(self) -> int:
        return len(self._req_t0)

    @property
    def n_preemptions(self) -> int:
        return len(self._pre_t)

    # ---------------------------------------------------- worker transport
    _COLUMNS = ("_arr_t", "_arr_tenant", "_arr_bucket", "_arr_admitted",
                "_arr_reason",
                "_dsp_t0", "_dsp_dur", "_dsp_bucket", "_dsp_size",
                "_dsp_cold", "_req_t0", "_req_t1", "_req_tenant",
                "_req_slo", "_req_bucket",
                "_pre_t", "_pre_tenant", "_pre_bucket", "_pre_est",
                "_pre_victims")

    def payload(self) -> Dict:
        """Compact picklable form (arrays + label table) for shipping a
        shard back from a forked fleet worker."""
        out = {c: getattr(self, c) for c in self._COLUMNS}
        out.update(replica_id=self.replica_id, per_request=self.per_request,
                   spec_name=self.spec_name, strategy=self.strategy,
                   bucket_labels=self._bucket_labels)
        return out

    @classmethod
    def from_payload(cls, data: Dict) -> "ReplicaShard":
        """Rebuild from ``payload()``. The bucket INDEX is not restored
        (the original keys live in the worker) — a rebuilt shard is
        read-only for export/telemetry, not for further recording."""
        shard = cls(data["replica_id"], per_request=data["per_request"])
        shard.spec_name = data["spec_name"]
        shard.strategy = data["strategy"]
        shard._bucket_labels = list(data["bucket_labels"])
        for c in cls._COLUMNS:
            setattr(shard, c, data[c])
        return shard


class FlightRecorder:
    """Fleet-wide event store: per-replica shards plus the fleet-level
    route/scale timelines no single replica can see."""

    def __init__(self, per_request: bool = True):
        self.per_request = per_request
        self.shards: Dict[int, ReplicaShard] = {}
        self.router_name: Optional[str] = None
        # route decisions: one row per arrival, price vector flattened
        self._rt_t = array("d")
        self._rt_tenant = array("l")
        self._rt_chosen = array("l")
        self._rt_n = array("l")           # prices per row
        self._rt_price = array("d")       # flat, row-major
        self._rt_price_rid = array("l")   # replica id per flat price
        self.scale_events: List[Dict] = []
        self.partition_events: List[Dict] = []

    def shard(self, replica_id: int = 0) -> ReplicaShard:
        s = self.shards.get(replica_id)
        if s is None:
            s = ReplicaShard(replica_id, per_request=self.per_request)
            self.shards[replica_id] = s
        return s

    def record_route(self, t_s: float, tenant_id: int, chosen_rid: int,
                     price_rids: Sequence[int] = (),
                     prices: Sequence[float] = ()) -> None:
        self._rt_t.append(t_s)
        self._rt_tenant.append(tenant_id)
        self._rt_chosen.append(chosen_rid)
        self._rt_n.append(len(prices))
        if prices:
            self._rt_price.extend(prices)
            self._rt_price_rid.extend(price_rids)

    def record_scale_events(self, events: Sequence) -> None:
        self.scale_events = [
            e.to_dict() if hasattr(e, "to_dict") else dict(e)
            for e in events]

    def record_partition_events(self, events: Sequence) -> None:
        """Partition assign/replan timeline (repro_torch.partition): copied to
        plain dicts like scale events, exported as instants on the
        control track."""
        self.partition_events = [
            e.to_dict() if hasattr(e, "to_dict") else dict(e)
            for e in events]

    @property
    def n_routes(self) -> int:
        return len(self._rt_t)

    def total_events(self) -> int:
        """Every recorded row, across shards and the fleet level."""
        n = self.n_routes + len(self.scale_events) \
            + len(self.partition_events)
        for s in self.shards.values():
            n += (s.n_arrivals + s.n_dispatches + s.n_requests
                  + s.n_preemptions)
        return n


def dispatch_tap(shard: ReplicaShard, model=None, prev=None):
    """Build an ``on_dispatch`` tap recording each super-dispatch into
    ``shard``, composing over any existing tap (``prev`` — calibration
    keeps working underneath the recorder).

    ``model`` is the replica's cost model: when it exposes
    ``dispatch_cold`` (``ColdStartCostModel``), the last entry at tap
    time says whether the dispatch just priced was a cold compile. The
    tap runs AFTER completion stamping (see ``scheduler._dispatch``), so
    ``batch[0].completion_time`` is the exact dispatch-end instant for
    both virtual and wall clocks.
    """
    cold_flags = getattr(model, "dispatch_cold", None)
    record = shard.record_dispatch

    def tap(batch, seconds, replica_id):
        if prev is not None:
            prev(batch, seconds, replica_id)
        cold = bool(cold_flags[-1]) if cold_flags else False
        record(batch[0].completion_time, seconds, batch, cold)

    return tap


def route_price_vector(router, spec, replicas: Sequence,
                       now: float) -> Tuple[List[int], List[float]]:
    """The per-replica price vector a router's decision was based on,
    recomputed from the same (idempotent) pump signals the router read:
    estimated-seconds for ``least_cost``, occupancy for ``jsq`` and
    ``affinity``, nothing for state-oblivious ``round_robin`` (which is
    also what keeps sharded round-robin runs byte-identical)."""
    name = getattr(router, "name", "")
    if name == "least_cost":
        return ([p.replica_id for p in replicas],
                [p.backlog_s(now) + p.estimate_item_s(spec)
                 for p in replicas])
    if name in ("jsq", "affinity"):
        return ([p.replica_id for p in replicas],
                [float(p.queue_depth(now)) for p in replicas])
    return [], []

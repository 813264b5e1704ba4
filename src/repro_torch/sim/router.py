"""Fleet routing policies: which replica does the next arrival go to?

A ``Router`` sees one arrival's ``TenantSpec`` plus the live per-replica
state (queue depth, estimated backlog seconds, warm compile caches) and
returns a replica index. Routers are deterministic pure functions of that
state — the fleet determinism contract (same seed, byte-identical
metrics) extends through routing.

The four policies span the classic trade-off surface:

    round_robin  -- load-oblivious; perfectly balanced COUNTS, blind to
                    cost heterogeneity and backlog (the baseline).
    jsq          -- join-shortest-queue on pending item count; the
                    textbook load balancer (Zhao et al.'s predictable-
                    latency setting).
    least_cost   -- join-least-estimated-WORK: residual busy time +
                    estimated backlog seconds + this item's estimated
                    cost on that replica, cold-start compile term
                    included. Sees both cost heterogeneity and warm-cache
                    affinity, so it lands hot shapes on replicas that
                    already compiled them unless the queue gap says
                    otherwise.
    affinity     -- tenant-sticky (session affinity): each tenant pins to
                    one replica via rendezvous (highest-random-weight)
                    hashing over the live replica ids, which maximizes
                    warm-cache reuse and per-tenant ordering, spilling
                    JSQ-style only when the pinned replica's queue is
                    badly out of line. The D-STACK-ish "keep a tenant's
                    state where it is" play — and because the pin is a
                    pure function of (tenant, replica id), an autoscale
                    event only remaps the tenants whose winning replica
                    actually appeared or vanished, not the whole fleet
                    (the old ``t mod N`` pinning remapped ~everyone on
                    every change of N, flushing every warm cache at once).

``route`` receives the list of ``ReplicaPump``s (``repro_torch.sim.simulator``)
— the routing signals are methods on the pump: ``queue_depth()``,
``backlog_s(now)``, ``estimate_item_s(w)``.
"""

from __future__ import annotations

import math
from typing import Sequence

ROUTERS = ("round_robin", "jsq", "least_cost", "affinity")


class Router:
    """Chooses a replica for each arrival; stateful but deterministic."""

    name: str = "base"

    def route(self, w, replicas: Sequence, now: float) -> int:
        """Return the index in ``replicas`` this workload is routed to."""
        raise NotImplementedError


class RoundRobinRouter(Router):
    """Cycle through replicas regardless of state."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def route(self, w, replicas, now) -> int:
        # mod at route time, not store time: the replica count is elastic
        # under autoscaling, and a stored index can outlive a scale-down
        idx = self._next % len(replicas)
        self._next = idx + 1
        return idx


class JoinShortestQueueRouter(Router):
    """Fewest pending + in-flight items wins; ties rotate round-robin.

    The rotating tie-break matters: always breaking to the lowest index
    herds every arrival that lands on an all-idle fleet onto replica 0,
    which concentrates micro-bursts and loses to plain round-robin. With
    rotation, JSQ degenerates to round-robin exactly when queues are even
    and only deviates when there is real imbalance to correct.
    """

    name = "jsq"

    def __init__(self) -> None:
        self._rr = 0

    def route(self, w, replicas, now) -> int:
        depths = [r.queue_depth(now) for r in replicas]
        shortest = min(depths)
        ties = [i for i, d in enumerate(depths) if d == shortest]
        idx = ties[self._rr % len(ties)]
        self._rr += 1
        return idx


class LeastEstimatedCostRouter(Router):
    """Least estimated finish time for THIS item: replica backlog seconds
    plus the item's estimated dispatch cost there (compile term included
    when the replica is cold for the item's bucket)."""

    name = "least_cost"

    def route(self, w, replicas, now) -> int:
        return min(
            range(len(replicas)),
            key=lambda i: (replicas[i].backlog_s(now)
                           + replicas[i].estimate_item_s(w), i),
        )


_HASH_MASK = (1 << 64) - 1


def _hrw_weight(tenant_id: int, replica_id: int) -> int:
    """Deterministic 64-bit mix of (tenant, replica) — the rendezvous
    score. splitmix64 finalizer over a golden-ratio combine: stable
    across runs, Python versions, and platforms (``hash()`` is not)."""
    x = (tenant_id * 0x9E3779B97F4A7C15
         + replica_id * 0xBF58476D1CE4E5B9 + 1) & _HASH_MASK
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _HASH_MASK
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _HASH_MASK
    return x ^ (x >> 31)


class TenantAffinityRouter(Router):
    """Session-sticky via weighted rendezvous hashing: tenant t pins to
    the live replica with the best capacity-weighted
    ``_hrw_weight(t, replica_id)`` score (maximal warm-cache reuse,
    minimal remapping when the replica set changes, and faster chips win
    proportionally more tenants on heterogeneous fleets), spilling to the
    shortest queue only when the pinned replica's queue exceeds
    ``spill_factor`` x the fleet's shortest queue (plus a small absolute
    grace so near-empty fleets never spill)."""

    name = "affinity"

    def __init__(self, spill_factor: float = 4.0, spill_grace: int = 8):
        if spill_factor < 1.0:
            raise ValueError("spill_factor must be >= 1")
        self.spill_factor = spill_factor
        self.spill_grace = spill_grace

    @staticmethod
    def pin(w, replicas) -> int:
        """Index of the tenant's rendezvous winner among ``replicas``.

        Keyed on each replica's stable ``replica_id`` (falling back to its
        position for bare sequences), so the pin survives the list
        reshuffling that scale events cause — only tenants whose winner
        joined or left the fleet move. Weighted a la Hash-Rendezvous-
        Weighted (``log(u)/capacity``): a replica advertising
        ``speed_factor`` 2.0 wins ~2x the tenants of a 1.0 replica, with
        equal speeds reducing to plain rendezvous hashing."""
        t = w.tenant_id

        def score(i: int) -> float:
            r = replicas[i]
            rid = getattr(r, "replica_id", None)
            u = (_hrw_weight(t, i if rid is None else rid) + 1) \
                / float(1 << 64)  # uniform draw in (0, 1]
            speed = getattr(r, "speed_factor", 1.0) or 1.0
            return math.log(u) / speed

        return max(range(len(replicas)), key=score)

    def route(self, w, replicas, now) -> int:
        pinned = self.pin(w, replicas)
        depth = replicas[pinned].queue_depth(now)
        shortest = min(range(len(replicas)),
                       key=lambda i: (replicas[i].queue_depth(now), i))
        if depth > self.spill_grace + self.spill_factor * \
                replicas[shortest].queue_depth(now):
            return shortest
        return pinned


def make_router(name: str, **kwargs) -> Router:
    """Name-keyed router factory (the CLI surface of this module)."""
    if name == "round_robin":
        return RoundRobinRouter()
    if name == "jsq":
        return JoinShortestQueueRouter()
    if name == "least_cost":
        return LeastEstimatedCostRouter()
    if name == "affinity":
        return TenantAffinityRouter(**kwargs)
    raise ValueError(f"unknown router: {name!r} (have {ROUTERS})")

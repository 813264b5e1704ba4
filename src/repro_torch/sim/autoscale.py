"""Deterministic replica autoscaling from the simulated load signal.

The elasticity half of the fleet story: the simulator already shows WHERE
to route work on a fixed fleet; this module decides HOW MANY replicas the
fleet should be running, from the same replica state routers read — so
the policy that looks good here transfers to a production control loop
reading the same signals (queue depths, backlog seconds).

``BacklogAutoscaler`` is a textbook hysteresis controller evaluated at
fixed control-loop ticks of simulated time:

    signal  = mean per-active-replica backlog seconds (``backlog_s``) —
              residual busy time plus the estimated cost of everything
              queued, i.e. "how many seconds behind is the average
              replica right now"
    up      : signal > up_backlog_s   and active < max_replicas
    down    : signal < down_backlog_s and active > min_replicas
    step    : one replica per decision, then ``cooldown_ticks`` quiet
              ticks — rate limiting is what keeps bursty arrivals (MMPP)
              from flapping the fleet

Spin-up is NOT free: the fleet simulator answers a scale-up with a FRESH
replica — new ``replica_id``, empty compile cache (every super-kernel
variant recompiles on it: the full cold-start bill), and a clock that
only starts accepting work ``spinup_s`` after the decision (container /
weights-load latency). Scale-down retires the replica whose drain cost
(backlog seconds priced via its own table — ``pick_scale_down``) is
lowest, the newest on ties: it stops receiving arrivals and drains what
it already owns. Both directions are
pure functions of seeded simulator state, so autoscaled fleets keep the
byte-identical-JSON determinism contract, scale-event timeline included.

The thresholds are in seconds of backlog — SLO-denominated, not
throughput-denominated — because the paper's (and Zhao et al.'s) framing
is latency predictability: scale when predicted queueing delay threatens
the SLO, not when utilization looks big.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One autoscale decision that changed the fleet."""

    t_s: float          # simulated time of the control tick
    action: str         # "up" | "down"
    replica_id: int     # the replica spawned or retired
    active: int         # active replica count AFTER the event
    signal: float       # backlog signal (seconds) that triggered it

    def to_dict(self) -> Dict:
        return {"t_s": self.t_s, "action": self.action,
                "replica_id": self.replica_id, "active": self.active,
                "signal_backlog_s": self.signal}


class Autoscaler:
    """Decides the desired active-replica count at each control tick."""

    name: str = "base"
    interval_s: float = 0.1     # control-loop period (simulated seconds)
    spinup_s: float = 0.0       # delay before a new replica takes work

    def decide(self, replicas: Sequence, now: float) -> int:
        """Return the desired ACTIVE count given the live replica state.

        Must be a deterministic pure function of (replica state, own
        state); the fleet applies at most the returned delta and records
        a ``ScaleEvent`` per replica changed."""
        raise NotImplementedError


class BacklogAutoscaler(Autoscaler):
    """Hysteresis controller on mean per-replica backlog seconds."""

    name = "backlog"

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 8,
        up_backlog_s: float = 0.010,
        down_backlog_s: float = 0.002,
        interval_s: float = 0.1,
        cooldown_ticks: int = 2,
        spinup_s: float = 0.0,
    ):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        if not (0.0 <= down_backlog_s < up_backlog_s):
            raise ValueError(
                "need 0 <= down_backlog_s < up_backlog_s (the hysteresis "
                f"band), got [{down_backlog_s}, {up_backlog_s}]")
        if interval_s <= 0.0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if spinup_s < 0.0:
            raise ValueError(f"spinup_s must be >= 0, got {spinup_s}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_backlog_s = float(up_backlog_s)
        self.down_backlog_s = float(down_backlog_s)
        self.interval_s = float(interval_s)
        self.cooldown_ticks = int(cooldown_ticks)
        self.spinup_s = float(spinup_s)
        self._cooldown = 0
        self.last_signal = 0.0

    def decide(self, replicas: Sequence, now: float) -> int:
        n = len(replicas)
        self.last_signal = sum(r.backlog_s(now) for r in replicas) / n
        if self._cooldown > 0:
            self._cooldown -= 1
            return n
        if self.last_signal > self.up_backlog_s and n < self.max_replicas:
            self._cooldown = self.cooldown_ticks
            return n + 1
        if self.last_signal < self.down_backlog_s and n > self.min_replicas:
            self._cooldown = self.cooldown_ticks
            return n - 1
        return n


def pick_scale_down(replicas: Sequence, now: float) -> int:
    """Index of the replica to retire: the one whose DRAIN COST is lowest.

    Drain cost is the replica's ``backlog_s(now)`` — residual busy time
    plus the estimated seconds of everything it still owns, priced
    through its own (possibly calibrated) table via the same
    ``pending_est_s`` accounting the routers read. Retiring the cheapest
    drainer keeps the most-loaded (and typically longest-warmed) caches
    serving.

    Tie-break preserves the historical policy: iterate newest→oldest with
    a strict ``<``, so equal-cost replicas still retire the NEWEST — the
    longest-warmed caches stay alive and up/down sequences on idle fleets
    are unchanged from the retire-the-newest era.
    """
    best_i = len(replicas) - 1
    best_cost = replicas[best_i].backlog_s(now)
    for i in range(len(replicas) - 2, -1, -1):
        c = replicas[i].backlog_s(now)
        if c < best_cost:
            best_i, best_cost = i, c
    return best_i


def make_autoscaler(name: str, **kwargs) -> Autoscaler:
    """Name-keyed factory (the CLI surface of this module)."""
    if name == "backlog":
        return BacklogAutoscaler(**kwargs)
    raise ValueError(f"unknown autoscaler: {name!r} (have ('backlog',))")

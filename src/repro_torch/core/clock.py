"""Injectable time sources for the scheduling core.

Every *policy* decision in the unified scheduler (batching-window
ripeness, SLO slack, latency accounting) reads time through a ``Clock``
object instead of calling ``time.perf_counter()`` directly. That makes
the event pump deterministic under test and lets benchmarks replay the
same arrival trace against different policies on a virtual timeline —
the property-based "batched == sequential" invariants and the Fig-4
fixed-vs-adaptive comparison both depend on this.

Two implementations:

    WallClock     -- real time (``time.perf_counter``); ``advance`` is a
                     no-op because wall time advances on its own.
    VirtualClock  -- a simulated timeline the caller (or the scheduler's
                     cost model) advances explicitly. Same trace in, same
                     latencies out, every run.
"""

from __future__ import annotations

import time


class Clock:
    """Minimal time-source protocol used by the scheduling core."""

    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt_s: float) -> None:
        raise NotImplementedError

    def advance_to(self, t_s: float) -> None:
        """Jump forward to an absolute time (never backwards)."""
        raise NotImplementedError


class WallClock(Clock):
    """Real host time. The production default."""

    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt_s: float) -> None:
        # wall time advances on its own; modeled time has nothing to add
        pass

    def advance_to(self, t_s: float) -> None:
        # same contract as advance: wall time cannot be pushed. This is
        # what makes the pump core clock-agnostic — the drain machinery
        # calls advance_to unconditionally, and only virtual timelines
        # actually move under it.
        pass


class VirtualClock(Clock):
    """Deterministic simulated timeline (starts at ``start_s``)."""

    def __init__(self, start_s: float = 0.0):
        self._t = float(start_s)

    def now(self) -> float:
        return self._t

    def advance(self, dt_s: float) -> None:
        if dt_s < 0.0:
            raise ValueError("virtual time cannot move backwards")
        self._t += dt_s

    def advance_to(self, t_s: float) -> None:
        """Jump forward to an absolute time (never backwards)."""
        self._t = max(self._t, float(t_s))

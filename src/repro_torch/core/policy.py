"""Pluggable batching-window policies for the unified scheduler.

The batching window is the space-time trade-off knob: wait longer and
more work merges into one super-kernel (throughput), wait shorter and
each item sees less queueing delay (latency). The paper uses a fixed
window; D-STACK-style SLO-aware scheduling shrinks the window as a
tenant's slack to its deadline shrinks, so a bucket holding a nearly-late
item dispatches immediately while relaxed buckets keep accumulating.

A policy answers one question: given the pending items of one bucket and
the current (injected) time, how long may the oldest item keep waiting?
The scheduler combines that with its size cap (a full bucket is always
ripe).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.config import ScheduleConfig


class BatchingPolicy:
    """Decides when a bucket of pending workloads is ripe to dispatch."""

    name: str = "base"
    # True if window_s inspects every pending item (the scheduler then
    # materializes the bucket's pending list; False keeps ripeness O(1)).
    needs_pending: bool = False
    # True if window_s is a constant — independent of both the pending
    # set and the clock. Lets the simulator cache one window value and
    # maintain per-bucket ripeness instants incrementally (a bucket's
    # instant is fixed at submit time) instead of rescanning every
    # bucket per event. Time- or slack-dependent policies must leave
    # this False: their instants drift as the clock advances.
    stable_window: bool = False
    # True if the policy fixes each item's ripeness instant at arrival
    # (``ripe_at``) and wants ripe buckets drained earliest-deadline-
    # first. The scheduler switches to its EDF pump and the simulator
    # keeps a calendar of per-bucket min-ripe_at instants (same
    # incremental machinery stable_window buys the fixed policy, keyed
    # on item deadlines instead of one constant window).
    deadline_aware: bool = False

    def window_s(self, pending: Sequence, now: float) -> float:
        """Max time the oldest pending item may keep waiting (seconds).

        The scheduler's ``_ripe`` combines this with its size cap (a full
        bucket is always ripe) and the bucket's oldest arrival.
        """
        raise NotImplementedError


class FixedWindowPolicy(BatchingPolicy):
    """The paper's policy: one constant accumulation window."""

    name = "fixed"
    stable_window = True

    def __init__(self, window_s: float):
        self._window_s = window_s

    def window_s(self, pending: Sequence, now: float) -> float:
        return self._window_s


class SLOAdaptiveWindowPolicy(BatchingPolicy):
    """Window shrinks as any pending item's slack to its SLO shrinks.

    Each item's slack is ``(arrival + slo) - now``. The bucket's window is
    the most urgent item's ``clamp(slack * slack_fraction, min_window,
    base_window)`` — an item at (or past) its deadline forces immediate
    dispatch, an item with lots of slack waits the full base window and
    merges with more peers.
    """

    name = "slo_adaptive"
    needs_pending = True

    def __init__(
        self,
        base_window_s: float,
        min_window_s: float = 0.0,
        slack_fraction: float = 0.25,
    ):
        self.base_window_s = base_window_s
        self.min_window_s = min_window_s
        self.slack_fraction = slack_fraction

    def window_s(self, pending: Sequence, now: float) -> float:
        w = self.base_window_s
        for item in pending:
            slack = (item.arrival_time + item.slo_s) - now
            w = min(w, max(self.min_window_s, slack * self.slack_fraction))
        return w


class DeadlineEDFPolicy(BatchingPolicy):
    """Earliest-deadline-first: ripeness is fixed per item at arrival.

    An item arriving at ``a`` with SLO ``s`` ripens at ``a + min(base_window,
    s * (1 - lead_fraction))`` — tight deadlines ripen early (reserving
    ``lead_fraction`` of the SLO for dispatch + service), relaxed ones wait
    the full base window and merge with more peers. Because the instant
    depends only on the item (never on the clock), the simulator keeps the
    same incremental per-bucket calendar the fixed policy gets; the
    scheduler additionally drains ripe buckets in earliest-deadline order
    rather than dict order, so a late bucket never queues behind a relaxed
    one.
    """

    name = "edf"
    needs_pending = True
    deadline_aware = True

    def __init__(self, base_window_s: float, lead_fraction: float = 0.5):
        self.base_window_s = base_window_s
        self.lead_fraction = lead_fraction

    def ripe_at(self, item) -> float:
        """The instant ``item`` ripens — fixed once, at arrival."""
        return item.arrival_time + min(
            self.base_window_s, item.slo_s * (1.0 - self.lead_fraction)
        )

    def deadline(self, item) -> float:
        return item.arrival_time + item.slo_s

    def window_s(self, pending: Sequence, now: float) -> float:
        # A bucket is ripe once its earliest-ripening item ripens; expressed
        # as a window on the oldest arrival so _ripe's contract holds. The
        # oldest item always ripens no later than any newer one waiting at
        # most base_window, so the window is never negative.
        if not pending:
            return self.base_window_s
        return min(self.ripe_at(it) for it in pending) - pending[0].arrival_time


def make_policy(schedule: ScheduleConfig) -> BatchingPolicy:
    """Instantiate the policy named by ``schedule.batching_policy``."""
    if schedule.batching_policy == "fixed":
        return FixedWindowPolicy(schedule.batching_window_s)
    if schedule.batching_policy == "slo_adaptive":
        return SLOAdaptiveWindowPolicy(
            schedule.batching_window_s,
            schedule.min_batching_window_s,
            schedule.slo_slack_fraction,
        )
    if schedule.batching_policy == "edf":
        return DeadlineEDFPolicy(
            schedule.batching_window_s,
            schedule.deadline_lead_fraction,
        )
    raise ValueError(f"unknown batching policy: {schedule.batching_policy!r}")

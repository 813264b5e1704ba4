"""``PartitionPlan``: tenants mapped to fractional per-replica shares.

A plan names the spatial slices one physical chip is carved into and
assigns every tenant to exactly one slice. Each slice executes as its
own scheduler pump over ``HardwareSpec.sliced(share)`` — roofs scaled by
the share, launch overheads at full price — and co-located slices run
CONCURRENTLY on the chip's timeline (``repro_torch.sim.fleet``), which is the
fractional generalization of the paper's space-only strategy.

Validation is eager and total: shares in (0, 1] summing to <= 1.0,
disjoint tenant sets, unique group names — a malformed plan fails at
construction with a one-line actionable error, never three layers into
a sweep.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

from repro_torch.launch.roofline import HardwareSpec

# float-noise allowance on the shares-sum cap: 16 slices of 1/16 must
# validate, 0.9 + 0.2 must not
SHARE_SUM_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class PartitionShare:
    """One spatial slice: its name, chip fraction, member tenants, and
    (optionally) the batching window the planner co-optimized for it."""

    name: str
    share: float
    tenants: Tuple[int, ...] = ()
    window_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("partition group name must be non-empty")
        if not (0.0 < self.share <= 1.0):
            raise ValueError(
                f"partition share must be in (0, 1], got {self.share} "
                f"(group {self.name!r})")
        object.__setattr__(self, "tenants",
                           tuple(int(t) for t in self.tenants))
        if self.window_s is not None and self.window_s < 0.0:
            raise ValueError(
                f"partition window_s must be >= 0, got {self.window_s} "
                f"(group {self.name!r})")

    def to_dict(self) -> Dict:
        return {"name": self.name, "share": self.share,
                "tenants": list(self.tenants), "window_s": self.window_s}

    @classmethod
    def from_dict(cls, data: Dict) -> "PartitionShare":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown partition group field(s) {unknown} "
                f"(known: {sorted(known)})")
        return cls(**data)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Named slices of one chip; every replica in the fleet is carved
    identically (the per-replica unit of the plan)."""

    groups: Tuple[PartitionShare, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "groups", tuple(self.groups))
        if not self.groups:
            raise ValueError("a PartitionPlan needs at least one group")
        names = [g.name for g in self.groups]
        if len(set(names)) != len(names):
            raise ValueError(
                f"partition group names must be unique, got {names}")
        total = sum(g.share for g in self.groups)
        if total > 1.0 + SHARE_SUM_TOL:
            raise ValueError(
                f"partition shares sum to {total:g} > 1.0; shares are "
                f"fractions of ONE chip — shrink them or drop a group")
        by_tenant: Dict[int, int] = {}
        for gi, g in enumerate(self.groups):
            for t in g.tenants:
                if t in by_tenant:
                    raise ValueError(
                        f"tenant {t} assigned to two partition groups "
                        f"({self.groups[by_tenant[t]].name!r} and "
                        f"{g.name!r}); tenant sets must be disjoint")
                by_tenant[t] = gi
        object.__setattr__(self, "_by_tenant", by_tenant)

    # ------------------------------------------------------------ accessors
    @property
    def total_share(self) -> float:
        return sum(g.share for g in self.groups)

    def group_of(self, tenant_id: int) -> int:
        """Index of the group serving ``tenant_id``. Tenants the plan
        never named fall back to ``tenant_id % len(groups)`` — a
        deterministic catch-all so a plan built from one mix still routes
        a replayed trace with extra tenants instead of crashing."""
        gi = self._by_tenant.get(int(tenant_id))
        if gi is None:
            return int(tenant_id) % len(self.groups)
        return gi

    def sliced_specs(self, hardware: HardwareSpec) -> Tuple[HardwareSpec, ...]:
        """One ``HardwareSpec`` slice per group, in group order — what
        each co-located partition pump prices against."""
        return tuple(
            hardware.sliced(g.share, name=f"{hardware.name}@{g.name}"
                                          f":{g.share:g}")
            for g in self.groups)

    # ------------------------------------------------------------ round trip
    def to_dict(self) -> Dict:
        return {"groups": [g.to_dict() for g in self.groups]}

    @classmethod
    def from_dict(cls, data: Dict) -> "PartitionPlan":
        if not isinstance(data, dict) or "groups" not in data:
            raise ValueError(
                'a PartitionPlan dict needs a "groups" list '
                f"(got {sorted(data) if isinstance(data, dict) else data!r})")
        return cls(groups=tuple(
            PartitionShare.from_dict(g) for g in data["groups"]))

    def to_json(self) -> str:
        """Canonical sorted-keys JSON — the planner determinism contract
        compares these strings directly."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PartitionPlan":
        return cls.from_dict(json.loads(text))

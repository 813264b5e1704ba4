"""Deterministic partition planner: knee shares co-optimized with batch
windows under deadline-feasibility.

The planner carves one card into per-bucket slices (workloads that share
a bucket can merge into super-kernels; workloads that don't would only
serialize each other inside one slice) and sizes each slice by two
forces:

* the **knee** (``repro_torch.partition.knee``): growing a slice past its
  (bucket, R) throughput knee buys ~nothing, so the knee is where the
  planner would LIKE to stop — card% above it is better spent on other
  tenants;
* **deadline feasibility** (the feasibility admission's pricing, applied at plan
  time): a slice must finish its representative merged dispatch within
  the group's tightest SLO, or feasibility admission will reject the
  work at run time. "Shrink the partition until the deadline stops
  being feasible" is the stopping rule — the planner walks the share
  grid downward and keeps the smallest share that is both at-or-above
  the knee and still meets the deadline.

The batch window rides along: a faster slice leaves more slack to its
SLO, so the planner grants it a wider batching window (bigger merges,
better amortization), never wider than ``slack_fraction`` of the
remaining slack or the configured base window. If the per-group choices
oversubscribe the card (shares summing past 1.0), card% is handed back
proportionally to what each group holds ABOVE its deadline floor —
feasibility survives the squeeze whenever the floors themselves fit —
and the windows re-derive at the squeezed shares.

Everything is a pure function of (mix, hardware, config, calibration
table): byte-identical plans per seed, the property the tests pin.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.roofline import HardwareSpec
from repro_torch.obs.recorder import bucket_label
from repro_torch.partition.knee import (
    DEFAULT_SHARE_GRID,
    knee_share,
    share_pricer,
    throughput_curve,
)
from repro_torch.partition.shares import SHARE_SUM_TOL, PartitionPlan, PartitionShare


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Planner knobs, mirrored by ``repro_torch.api.spec.PartitionSpec``."""

    share_grid: Tuple[float, ...] = DEFAULT_SHARE_GRID
    knee_fraction: float = 0.9
    min_share: float = 0.0625
    base_window_s: float = 0.002     # widest batching window granted
    slack_fraction: float = 0.5      # of deadline slack a window may eat
    merge_size: int = 32             # representative merged-batch budget
    strategy: str = "space_time"
    small_kernel_efficiency: float = 0.45

    def __post_init__(self) -> None:
        grid = tuple(float(s) for s in self.share_grid)
        if not grid:
            raise ValueError("share_grid must be non-empty")
        if any(not (0.0 < s <= 1.0) for s in grid):
            raise ValueError(
                f"share_grid entries must be in (0, 1], got {grid}")
        if list(grid) != sorted(set(grid)):
            raise ValueError(
                f"share_grid must be strictly ascending, got {grid}")
        object.__setattr__(self, "share_grid", grid)
        if not (0.0 < self.knee_fraction <= 1.0):
            raise ValueError(
                f"knee_fraction must be in (0, 1], got {self.knee_fraction}")
        if not (0.0 < self.min_share <= 1.0):
            raise ValueError(
                f"min_share must be in (0, 1], got {self.min_share}")
        if self.base_window_s < 0.0:
            raise ValueError(
                f"base_window_s must be >= 0, got {self.base_window_s}")
        if not (0.0 <= self.slack_fraction <= 1.0):
            raise ValueError(
                f"slack_fraction must be in [0, 1], got {self.slack_fraction}")
        if self.merge_size < 1:
            raise ValueError(
                f"merge_size must be >= 1, got {self.merge_size}")


def group_tenants(mix: Sequence) -> List[Tuple[str, List]]:
    """``(group_name, member_specs)`` per distinct bucket, in mix order.

    Group names prefer the shape suffix of the first member's tenant
    name (``t0/resnet18_conv2_2`` -> ``resnet18_conv2_2``) and fall back
    to the interned bucket label; collisions dedupe with ``#k`` so plan
    JSON and Perfetto tracks stay unambiguous."""
    by_bucket: Dict = {}
    for spec in mix:
        by_bucket.setdefault(spec.bucket, []).append(spec)
    seen: Dict[str, int] = {}
    out: List[Tuple[str, List]] = []
    for bucket, members in by_bucket.items():
        name = members[0].name
        name = name.split("/", 1)[1] if "/" in name else bucket_label(bucket)
        n = seen.get(name, 0)
        seen[name] = n + 1
        out.append((f"{name}#{n + 1}" if n else name, members))
    return out


def representative_r(members: Sequence, total_weight: float,
                     merge_size: int) -> int:
    """The merged batch size this group would see in one dispatch round:
    its weight share of ``merge_size`` arrivals (the same split
    ``estimate_capacity_hz`` prices capacity with), floored at 1."""
    w = sum(s.weight for s in members)
    return max(1, round(merge_size * w / total_weight)) if total_weight \
        else 1


def plan_partitions(
    mix: Sequence,
    hardware: HardwareSpec,
    config: Optional[PlannerConfig] = None,
    calibrated=None,
    r_override: Optional[Dict[str, int]] = None,
) -> PartitionPlan:
    """Carve ``hardware`` into per-bucket slices for ``mix``.

    ``calibrated`` (a ``CalibratedCostModel``) prices the knee curves
    from measured tables instead of the roofline prior; ``r_override``
    maps group names to observed merged batch sizes — the re-planning
    hook the fleet uses mid-run (observed R replaces the weight-derived
    representative R, everything else re-derives deterministically).
    """
    cfg = config or PlannerConfig()
    groups = group_tenants(mix)
    if not groups:
        raise ValueError("plan_partitions needs a non-empty tenant mix")
    total_weight = sum(s.weight for s in mix)
    price = share_pricer(
        hardware, strategy=cfg.strategy,
        small_kernel_efficiency=cfg.small_kernel_efficiency,
        calibrated=calibrated)
    grid = cfg.share_grid

    chosen: List[Tuple[str, List, float, float, float, int]] = []
    for name, members in groups:
        r = (r_override or {}).get(
            name, representative_r(members, total_weight, cfg.merge_size))
        r = max(1, int(r))
        curve = throughput_curve(members[0], r, price, grid)
        knee = knee_share(curve, knee_fraction=cfg.knee_fraction,
                          min_share=cfg.min_share)
        min_slo = min(s.slo_s for s in members)
        batch = [members[0]] * r
        # "shrink the partition until the deadline stops being feasible":
        # walk the grid downward from the whole card, keeping the
        # smallest share whose representative dispatch still fits the
        # tightest member SLO — est(share) grows as the share shrinks,
        # so feasibility is monotone and the first infeasible step ends
        # the walk. If even the whole card misses the deadline the group
        # keeps the largest share (run-time admission will price the
        # overload honestly).
        eligible = [s for s in grid if s >= cfg.min_share] or [grid[-1]]
        floor = eligible[-1]
        for s in reversed(eligible):
            if price(batch, s) <= min_slo:
                floor = s
            else:
                break
        # the knee caps USEFUL growth: card% past it buys < (1 -
        # knee_fraction) throughput, so the ask is the deadline floor
        # raised to the knee — never less than feasibility demands,
        # never more than the curve rewards
        share = max(floor, knee)
        chosen.append((name, members, share, floor, min_slo, r))

    total = sum(share for _, _, share, _, _, _ in chosen)
    if total > 1.0 + SHARE_SUM_TOL:
        # oversubscribed card: give back card% proportionally to what
        # each group holds ABOVE its deadline floor, so feasibility
        # survives the squeeze whenever the floors themselves fit; when
        # even the floors oversubscribe, scale everything proportionally
        # (the admission layer will reject what truly cannot fit)
        floors = sum(floor for _, _, _, floor, _, _ in chosen)
        if floors <= 1.0 + SHARE_SUM_TOL:
            slack = total - floors
            give_back = total - 1.0
            chosen = [
                (name, members,
                 share - give_back * ((share - floor) / slack),
                 floor, min_slo, r)
                for name, members, share, floor, min_slo, r in chosen]
        else:
            chosen = [
                (name, members, share / total, floor, min_slo, r)
                for name, members, share, floor, min_slo, r in chosen]

    out = []
    for name, members, share, _, min_slo, r in chosen:
        est = price([members[0]] * r, share)
        window = min(cfg.base_window_s,
                     max(0.0, (min_slo - est) * cfg.slack_fraction))
        out.append(PartitionShare(
            name=name, share=share,
            tenants=tuple(s.tenant_id for s in members),
            window_s=window))
    return PartitionPlan(groups=tuple(out))

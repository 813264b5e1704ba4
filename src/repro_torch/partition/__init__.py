"""Fractional spatial shares as a first-class schedulable resource.

    shares.py   ``PartitionPlan`` — named per-partition slices of one
                card (``HardwareSpec.sliced``), tenants mapped to
                slices, shares summing to <= 1.0
    knee.py     throughput-vs-share curves per (bucket, R) priced from
                the roofline or a calibrated table, and the D-STACK-style
                knee share beyond which extra card% buys ~nothing
    planner.py  the deterministic planner that co-optimizes partition
                sizes with batch windows, stopping a partition's shrink
                where its deadline stops being feasible

Execution lives in ``repro_torch.sim.fleet`` (co-located partition pumps
on one card, one merged timeline); the declarative surface is
``repro_torch.api.spec.PartitionSpec``.
"""

from repro_torch.partition.knee import (  # noqa: F401
    DEFAULT_SHARE_GRID,
    knee_share,
    share_pricer,
    throughput_curve,
)
from repro_torch.partition.planner import PlannerConfig, plan_partitions  # noqa: F401
from repro_torch.partition.shares import PartitionPlan, PartitionShare  # noqa: F401

"""Fractional spatial shares as a first-class schedulable resource.

    shares.py   ``PartitionPlan`` — named per-partition slices of one
                card (``HardwareSpec.sliced``), tenants mapped to
                slices, shares summing to <= 1.0

Execution lives in ``repro_torch.sim.fleet`` (co-located partition pumps
on one card, one merged timeline).
"""

from repro_torch.partition.shares import PartitionPlan, PartitionShare  # noqa: F401

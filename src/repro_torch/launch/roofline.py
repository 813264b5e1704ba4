"""The card's roofline description, as the cost models price work.

Three roofs and the launch terms, all per card:

    compute    = FLOPs / peak_flops
    memory     = bytes / hbm_bw
    collective = bytes / ici_bw          (one NVLink link, one direction)

plus the per-launch constants the space-time gains hinge on: merging R
kernels into one super-kernel pays ``dispatch_overhead_s`` once instead
of R times.

Roofs of the default ``"h100"`` spec are the NVIDIA H100 SXM5 datasheet's:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s HBM3, and NVLink 4's
900 GB/s over 18 links, i.e. 25 GB/s per link and direction. The two launch
terms were measured by ``chip_smoke.py --phases 8`` (``launch_terms``) on an
NVIDIA H100 80GB HBM3 at a 700 W power limit; ``PERF.md`` names the run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card roofline description.

    One record the sim cost models, the partition slices and the fleet's
    speed factors all price against (another card is a dataclass instance
    away).
    """

    name: str = "h100"
    peak_flops: float = 989e12       # dense bf16 FLOP/s (datasheet)
    hbm_bw: float = 3.35e12          # bytes/s (datasheet)
    ici_bw: float = 25e9             # bytes/s per NVLink link, one direction
    # host time of one empty kernel launch: 4.49 us measured
    dispatch_overhead_s: float = 4.49e-6
    # what a torch.cuda.synchronize() after a launch adds: 9.87 us measured
    context_switch_s: float = 9.87e-6
    # pipe fill: wgmma's M of 64 rows at the 1,980 MHz boost clock. These
    # two set only the pipe-fill term below.
    mxu_dim: int = 64
    mxu_freq_hz: float = 1.98e9

    def t_compute(self, flops: float) -> float:
        return flops / self.peak_flops

    def t_memory(self, bytes_moved: float) -> float:
        return bytes_moved / self.hbm_bw

    def t_collective(self, bytes_moved: float) -> float:
        return bytes_moved / self.ici_bw

    def pipe_fill_s(self) -> float:
        """Pipeline fill paid once per distinct kernel launch."""
        return self.mxu_dim / self.mxu_freq_hz

    def scaled(self, factor: float, name: Optional[str] = None) -> "HardwareSpec":
        """A same-architecture card at ``factor`` x this one's throughput
        (an older or down-binned part): the compute/memory/link roofs
        scale, the per-launch overheads (dispatch, context switch, pipe
        fill) do NOT -- which is why slower cards lose *more* to
        time-sliced multiplexing and heterogeneous fleets need
        speed-aware routing (see ``repro_torch.sim.fleet``)."""
        if factor <= 0.0:
            raise ValueError(f"scale factor must be > 0, got {factor}")
        return dataclasses.replace(
            self,
            name=name or f"{self.name}_x{factor:g}",
            peak_flops=self.peak_flops * factor,
            hbm_bw=self.hbm_bw * factor,
            ici_bw=self.ici_bw * factor,
        )

    def sliced(self, share: float, name: Optional[str] = None) -> "HardwareSpec":
        """A fractional spatial partition of this card: ``share`` of the
        compute/memory/link roofs, full-price launch overheads.

        A tenant granted 25% of the SMs sees 25% of every roof but still
        pays the full ``dispatch_overhead_s`` and pipe fill per launch.
        Shares of co-located slices must sum to <= 1.0;
        ``repro_torch.partition.shares.PartitionPlan`` owns that
        validation."""
        if not (0.0 < share <= 1.0):
            raise ValueError(
                f"partition share must be in (0, 1], got {share} "
                f"(a share is a fraction of one chip's spatial units)")
        return self.scaled(share, name=name or f"{self.name}@{share:g}")


H100 = HardwareSpec()

# Named cards for the sim and fleet surfaces: the H100 plus derated parts
# of the same architecture -- launch overheads identical, roofs scaled
# (see ``HardwareSpec.scaled``).
HARDWARE_SPECS: Dict[str, HardwareSpec] = {
    "h100": H100,
    "h100_half": H100.scaled(0.5, name="h100_half"),
    "h100_quarter": H100.scaled(0.25, name="h100_quarter"),
}


def resolve_spec(spec) -> HardwareSpec:
    """Accept a ``HardwareSpec`` or a ``HARDWARE_SPECS`` name.

    Unknown names raise a ``ValueError`` that lists the registered keys.
    """
    if isinstance(spec, HardwareSpec):
        return spec
    try:
        return HARDWARE_SPECS[spec]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown hardware spec {spec!r} "
            f"(names: {sorted(HARDWARE_SPECS)})") from None

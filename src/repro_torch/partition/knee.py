"""Throughput-vs-share curves and the D-STACK-style knee share.

For a (bucket, R) workload — R problems of one shape merged into one
super-kernel — throughput as a function of the card fraction it runs on
is concave with a knee: the roofline terms scale with the share, the
per-launch overheads (dispatch, pipe fill) do not, so beyond some share
the fixed costs are amortized and extra card% buys almost nothing.
D-STACK and "Spatial Sharing of GPU for Autotuning DNN models" both
exploit exactly this curve; the knee share is where a planner should
STOP growing a partition (``repro_torch.partition.planner``).

Curves are priced either analytically (``RooflineCostModel`` over
``HardwareSpec.sliced(share)``) or from a calibrated table
(``CalibratedCostModel.dispatch_share_s`` — measured whole-card seconds
decomposed into fixed overhead + a share-scaled remainder, with the
count-weighted shrinkage toward the roofline prior keeping curves from
thin tables smooth). Everything here is a pure function of its inputs —
same workload, same grid, same knee — which is what makes planner output
byte-identical per seed.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

from repro_torch.launch.roofline import HardwareSpec
from repro_torch.sim.costmodel import RooflineCostModel

# Candidate shares, ascending: sixteenths up to a half (where knees for
# launch-dominated shapes live), then coarser steps to the whole card.
DEFAULT_SHARE_GRID: Tuple[float, ...] = (
    0.0625, 0.125, 0.1875, 0.25, 0.3125, 0.375, 0.5,
    0.625, 0.75, 0.875, 1.0,
)

#: ``price(batch, share) -> seconds`` for one merged dispatch on a slice.
SharePricer = Callable[[Sequence, float], float]


def share_pricer(
    hardware: HardwareSpec,
    strategy: str = "space_time",
    small_kernel_efficiency: float = 0.45,
    calibrated=None,
) -> SharePricer:
    """Build the ``price(batch, share)`` function knee curves sweep.

    With ``calibrated`` (a ``CalibratedCostModel``), measured costs win:
    pricing goes through ``dispatch_share_s`` (fitted-or-prior seconds,
    overhead-decomposed and share-scaled). Otherwise each share prices
    through a ``RooflineCostModel`` over ``hardware.sliced(share)`` —
    models are cached per share, so sweeping a grid over many workloads
    builds each slice once.
    """
    if calibrated is not None:
        return lambda batch, share: calibrated.dispatch_share_s(batch, share)
    cache = {}

    def price(batch: Sequence, share: float) -> float:
        model = cache.get(share)
        if model is None:
            model = RooflineCostModel(
                spec=hardware.sliced(share), strategy=strategy,
                small_kernel_efficiency=small_kernel_efficiency)
            cache[share] = model
        return model(batch)

    return price


def throughput_curve(
    workload,
    r: int,
    price: SharePricer,
    shares: Sequence[float] = DEFAULT_SHARE_GRID,
) -> Tuple[Tuple[float, float], ...]:
    """``(share, problems/s)`` points for R merged copies of ``workload``.

    ``workload`` is anything with ``flops``/``bytes`` (a ``TenantSpec``,
    a ``SimWorkload``); R copies model the super-kernel the scheduler
    would actually dispatch for that (bucket, R) key.
    """
    if r < 1:
        raise ValueError(f"r must be >= 1, got {r}")
    if not shares:
        raise ValueError("shares grid must be non-empty")
    batch = [workload] * int(r)
    out = []
    for s in shares:
        t = price(batch, s)
        out.append((float(s), (r / t) if t > 0.0 else float("inf")))
    return tuple(out)


def knee_share(
    curve: Sequence[Tuple[float, float]],
    knee_fraction: float = 0.9,
    min_share: float = 0.0,
    tol: float = 1e-12,
) -> float:
    """The knee: the SMALLEST share on the curve whose throughput reaches
    ``knee_fraction`` of the curve's best throughput.

    On a monotone non-decreasing curve (throughput never falls as the
    share grows — the roofline guarantee) this is the unique crossing of
    the threshold, hence well-defined; ``min_share`` floors the answer
    for planners that refuse slivers. Raising ``knee_fraction`` can only
    move the knee up the curve.
    """
    if not curve:
        raise ValueError("knee_share needs a non-empty curve")
    if not (0.0 < knee_fraction <= 1.0):
        raise ValueError(
            f"knee_fraction must be in (0, 1], got {knee_fraction}")
    points = sorted(curve)
    best = max(thr for _, thr in points)
    threshold = knee_fraction * best
    for share, thr in points:
        if share + tol < min_share:
            continue
        if thr + tol >= threshold:
            return share
    # every eligible share is below threshold (min_share excluded the
    # crossing): the largest share is the closest the grid can get
    return points[-1][0]


def knee_for(
    workload,
    r: int,
    price: SharePricer,
    shares: Sequence[float] = DEFAULT_SHARE_GRID,
    knee_fraction: float = 0.9,
    min_share: float = 0.0,
) -> float:
    """Convenience: the (bucket, R) workload's knee share in one call."""
    return knee_share(throughput_curve(workload, r, price, shares),
                      knee_fraction=knee_fraction, min_share=min_share)


def pareto_shares(
    curve: Sequence[Tuple[float, float]],
    fractions: Sequence[float],
    min_share: Optional[float] = None,
) -> Tuple[float, ...]:
    """Knee shares at several quality fractions of one curve — the
    sensitivity view the reference's ``benchmarks/partition_sweep.py`` reports."""
    return tuple(
        knee_share(curve, knee_fraction=f, min_share=min_share or 0.0)
        for f in fractions)

"""Runtime, mesh and scheduler configuration (field for field the JAX
package's ``MeshConfig``, ``ScheduleConfig`` and ``RuntimeConfig``).

``MeshConfig`` describes the reference's device meshes; the port runs on
one card, where a mesh is only the count its sharding arithmetic reads
(``launch.mesh``, ``distributed.sharding``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Production mesh description (pod, data, model)."""

    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names

    @staticmethod
    def single_pod() -> "MeshConfig":
        return MeshConfig((16, 16), ("data", "model"))

    @staticmethod
    def two_pod() -> "MeshConfig":
        return MeshConfig((2, 16, 16), ("pod", "data", "model"))

    @staticmethod
    def host_debug() -> "MeshConfig":
        return MeshConfig((1, 1), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """Dynamic space-time scheduler knobs (paper section 4)."""

    # batching window: how long the scheduler waits to accumulate matching
    # workloads before dispatching a super-kernel (seconds, injected clock).
    batching_window_s: float = 0.002
    # window policy: "fixed" holds every bucket the full window; the
    # "slo_adaptive" policy shrinks a bucket's window as any pending
    # item's slack to its SLO deadline shrinks (D-STACK-style); "edf"
    # fixes each item's ripeness at arrival from its own deadline and
    # dispatches ripe buckets earliest-deadline-first.
    batching_policy: str = "fixed"  # "fixed" | "slo_adaptive" | "edf"
    # slo_adaptive knobs: floor of the shrunken window, and the fraction
    # of remaining slack a bucket may keep waiting.
    min_batching_window_s: float = 0.0
    slo_slack_fraction: float = 0.25
    # admission control: reject submits once a tenant has this many
    # pending workloads queued (None = unbounded).
    max_pending_per_tenant: Optional[int] = None
    # admission policy: "cap" is the blind per-tenant pending cap above;
    # "feasibility" prices a candidate's completion via the cost model
    # and rejects work whose deadline cannot be met even after
    # oversubscription. Requires a cost model.
    admission_policy: str = "cap"  # "cap" | "feasibility"
    # feasibility admission admits past the deadline up to
    # (oversubscription - 1) extra deadlines of predicted lateness.
    oversubscription: float = 1.0
    # edf knob: fraction of an item's SLO reserved as dispatch+service
    # lead; the item ripens after min(base_window, slo * (1 - lead)).
    deadline_lead_fraction: float = 0.5
    # preemption: when an unripe bucket's deadline would be missed by
    # waiting out its window, force-dispatch it ahead of ripe buckets
    # (requires batching_policy="edf"), charging the preempting tenant's
    # interference debt up to preemption_budget_s per tenant.
    preemption: bool = False
    preemption_budget_s: float = 0.010
    # maximum problems merged into one super-kernel invocation.
    max_superkernel_size: int = 128
    # R is padded up to the next bucket to bound the number of compiled
    # super-kernel variants. Power-of-two bucketing.
    r_bucketing: str = "pow2"  # "pow2" | "exact"
    # straggler eviction: tenants whose EWMA latency exceeds this multiple of
    # the cohort median get evicted to a fresh queue slot.
    straggler_eviction_ratio: float = 1.5
    latency_ewma_alpha: float = 0.2
    # SLO default (seconds) used when requests don't carry one.
    default_slo_s: float = 0.100
    # when True the scheduler may merge GEMMs of *different* shapes through
    # the grouped (ragged) kernel.
    allow_ragged_merge: bool = False

    def __post_init__(self) -> None:
        if self.batching_window_s < 0.0:
            raise ValueError(
                f"batching_window_s must be >= 0, got {self.batching_window_s}"
            )
        if self.min_batching_window_s < 0.0:
            raise ValueError(
                "min_batching_window_s must be >= 0, "
                f"got {self.min_batching_window_s}"
            )
        if self.max_superkernel_size < 1:
            raise ValueError(
                f"max_superkernel_size must be >= 1, got {self.max_superkernel_size}"
            )
        if self.max_pending_per_tenant is not None and self.max_pending_per_tenant < 1:
            raise ValueError(
                "max_pending_per_tenant must be >= 1 or None, "
                f"got {self.max_pending_per_tenant}"
            )
        if self.admission_policy not in ("cap", "feasibility"):
            raise ValueError(
                "admission_policy must be 'cap' or 'feasibility', "
                f"got {self.admission_policy!r}"
            )
        if self.oversubscription < 1.0:
            raise ValueError(
                f"oversubscription must be >= 1.0, got {self.oversubscription}"
            )
        if not 0.0 <= self.deadline_lead_fraction <= 1.0:
            raise ValueError(
                "deadline_lead_fraction must be in [0, 1], "
                f"got {self.deadline_lead_fraction}"
            )
        if self.preemption_budget_s < 0.0:
            raise ValueError(
                f"preemption_budget_s must be >= 0, got {self.preemption_budget_s}"
            )
        if self.preemption and self.batching_policy != "edf":
            raise ValueError(
                "preemption requires batching_policy='edf', "
                f"got {self.batching_policy!r}"
            )
        if self.batching_policy == "edf" and self.allow_ragged_merge:
            raise ValueError(
                "allow_ragged_merge is incompatible with batching_policy='edf' "
                "(the ragged merge scans buckets in family order, not "
                "deadline order)"
            )


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Top-level runtime bundle consumed by launchers."""

    arch: str = "granite-3-8b"
    shape: str = "train_4k"
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig.single_pod)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    num_tenants: int = 1
    seed: int = 0
    # training knobs
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 300
    # remat policy: "none" | "block" | "full"
    remat: str = "block"
    checkpoint_dir: Optional[str] = None

"""Declarative system description — the repo's one front door.

A ``SystemSpec`` is a nested, JSON-round-trippable description of a
complete experiment: what arrives (``WorkloadSpec``), on how many
replicas of which hardware (``FleetSpec`` + ``AutoscaleSpec``), routed
how (``RouterSpec``), scheduled how (``SchedulerSpec``), and priced how
(``CostModelSpec``). ``build()`` assembles the right executor for the
spec's shape — the solo ``Simulator`` for one replica, the
``FleetSimulator`` for many, the engine-backed ``LiveFleet`` for
``mode="live"`` — and every executor returns the same ``RunReport``
(metrics + spec echo + schema_version).

Field-to-subsystem map:

    workload    -> repro_torch.sim.traces   (mix builders + arrival processes)
    fleet       -> repro_torch.sim.fleet    (replicas, per-replica HardwareSpec
                                       names, repro_torch.sim.autoscale)
    router      -> repro_torch.sim.router   (ROUTERS registry)
    scheduler   -> repro_torch.config.ScheduleConfig (the real scheduling core)
    cost_model  -> repro_torch.sim.costmodel (roofline / calibrated priors,
                                        cold-start compile accounting,
                                        launch.roofline.HARDWARE_SPECS)
    mode="live" -> repro_torch.serving.fleet.LiveFleet (N real engines behind
                                       the same routers, wall clock)

Every spec constructor validates eagerly with actionable errors (unknown
hardware names list the registered ``HARDWARE_SPECS`` keys, unknown
routers list ``ROUTERS``, ...), so a typo in a JSON spec fails at
``load`` time, not three layers into a sweep.

Round-trip contract (property-tested): ``SystemSpec.from_dict(s.to_dict())
== s``, and ``build()`` on the round-tripped spec reproduces
byte-identical metrics JSON for a fixed seed.

The port's counterpart of ``repro.api.spec``, field for field. Where they
differ is hardware names. The port's registry
(``repro_torch.launch.roofline.HARDWARE_SPECS``) names the H100 and its
derated parts ("h100", "h100_half", "h100_quarter") and no other card,
and ``CostModelSpec.hardware`` defaults to "h100". A spec file written for
the reference names its own card ("v5e"), which this registry refuses
with the names-listing error. Such a file runs unedited through
``SystemSpec.load(path, overrides)``: the dotted overrides (the CLI's
``--set``, ``--events`` and ``--seed``) are merged into the file's JSON
before any section is built, so ``--set cost_model.hardware=h100 --set
'fleet.specs=["h100","h100_half"]'`` replaces the names before they are
validated. For every file that validates as it is, the merge gives the
same spec as loading it and then ``replace(**overrides)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

from repro_torch.config import ScheduleConfig
from repro_torch.launch.roofline import resolve_spec
from repro_torch.sim.costmodel import STRATEGIES
from repro_torch.sim.metrics import SCHEMA_VERSION
from repro_torch.sim.router import ROUTERS

MIXES = ("sgemm", "fleet", "serving", "single")
PROCESSES = ("poisson", "mmpp", "diurnal", "flash", "replay")
MODES = ("sim", "live")
COST_KINDS = ("roofline", "calibrated")
AUTOSCALERS = ("backlog",)
PARTITION_POLICIES = ("knee", "explicit")


def _from_dict(cls, data, where: str):
    """Construct a spec dataclass from a plain dict, rejecting unknown
    keys with the list of known fields (the actionable-error contract)."""
    if not isinstance(data, dict):
        raise ValueError(f"{where} must be a JSON object, got {type(data).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - known)
    if unknown:
        raise ValueError(
            f"unknown {where} field(s) {unknown} (known: {sorted(known)})")
    return cls(**data)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """What arrives: a named tenant mix driven by an arrival process.

    Offered load is either absolute (``rate_hz``) or capacity-anchored
    (``rho``: the fraction of the configured fleet's estimated space_time
    capacity — one number that means the same pressure for any mix or
    fleet shape). Exactly one of the two applies; ``rho`` wins when both
    are unset via its default.

    The live-mode fields (``arch``, ``prompt_tokens``, ``max_new_tokens``)
    only matter under ``SystemSpec(mode="live")``, where ``events`` is the
    total request count spread round-robin over ``tenants``.
    """

    mix: str = "sgemm"             # sgemm | fleet (Zipf) | serving | single
    tenants: int = 8
    process: str = "poisson"       # poisson | mmpp | diurnal | flash | replay
    events: int = 20_000
    seed: int = 0
    rho: Optional[float] = 0.7     # offered load / estimated capacity
    rate_hz: Optional[float] = None  # absolute arrivals/s (overrides rho)
    zipf_a: float = 1.1            # mix="fleet": Zipf skew of tenant weights
    slo_s: float = 0.010           # mix="single": the one SLO tier
    csv_path: Optional[str] = None  # process="replay": recorded t_s,tenant rows
    arch: str = "stablelm-1.6b"    # mode="live": model architecture
    prompt_tokens: int = 8         # mode="live": prompt length per request
    max_new_tokens: int = 8        # mode="live": decode budget per request

    def __post_init__(self) -> None:
        if self.mix not in MIXES:
            raise ValueError(f"unknown mix {self.mix!r} (have {MIXES})")
        if self.process not in PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r} (have {PROCESSES})")
        if self.tenants < 1:
            raise ValueError(f"tenants must be >= 1, got {self.tenants}")
        if self.events < 0:
            raise ValueError(f"events must be >= 0, got {self.events}")
        if self.process == "replay" and not self.csv_path:
            raise ValueError('process="replay" needs csv_path (rows of "t_s,tenant")')
        if self.process != "replay":
            if self.rate_hz is not None:
                if self.rate_hz <= 0:
                    raise ValueError(f"rate_hz must be > 0, got {self.rate_hz}")
            elif self.rho is None:
                raise ValueError("set rho (capacity fraction) or rate_hz (absolute)")
            elif self.rho <= 0:
                raise ValueError(f"rho must be > 0, got {self.rho}")
        if self.zipf_a < 0:
            raise ValueError(f"zipf_a must be >= 0, got {self.zipf_a}")
        if self.slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {self.slo_s}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "WorkloadSpec":
        return _from_dict(cls, data, "workload")


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """Elastic-fleet policy (repro_torch.sim.autoscale) in declarative form."""

    policy: str = "backlog"
    min_replicas: int = 1
    max_replicas: int = 8
    up_backlog_s: float = 0.010
    down_backlog_s: float = 0.002
    interval_s: float = 0.1
    cooldown_ticks: int = 2
    spinup_s: float = 0.0

    def __post_init__(self) -> None:
        if self.policy not in AUTOSCALERS:
            raise ValueError(
                f"unknown autoscaler {self.policy!r} (have {AUTOSCALERS})")
        # range/ordering constraints are owned by the controller itself —
        # construct one so spec validation and runtime agree exactly
        self.build()

    def build(self):
        from repro_torch.sim.autoscale import make_autoscaler

        kwargs = dataclasses.asdict(self)
        kwargs.pop("policy")
        return make_autoscaler(self.policy, **kwargs)

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "AutoscaleSpec":
        return _from_dict(cls, data, "fleet.autoscale")


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """How many replicas, of what hardware, grown how.

    ``replicas`` is the fleet size at trace start; ``specs`` (names from
    ``launch.roofline.HARDWARE_SPECS``, cycled over replica ids) makes
    the fleet heterogeneous; ``autoscale`` makes it elastic between the
    policy's min/max. One replica with no specs/autoscale builds the solo
    ``Simulator``; anything else builds the ``FleetSimulator``.

    ``workers > 1`` shards the replica pumps across that many forked
    processes (``repro_torch.sim.shard``) — byte-identical metrics, restricted
    to independent-replica configurations (round-robin router, no
    autoscale, fixed batching window); ``SystemSpec`` validates the
    combination eagerly.
    """

    replicas: int = 1
    specs: Optional[Tuple[str, ...]] = None
    autoscale: Optional[AutoscaleSpec] = None
    workers: int = 1

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.workers < 1:
            raise ValueError(f"fleet.workers must be >= 1, got {self.workers}")
        if self.specs is not None:
            if not self.specs:
                raise ValueError("fleet.specs must be non-empty when given")
            object.__setattr__(self, "specs", tuple(self.specs))
            for name in self.specs:
                if not isinstance(name, str):
                    raise ValueError(
                        "fleet.specs entries must be HARDWARE_SPECS names "
                        f"(JSON-portable), got {name!r}")
                resolve_spec(name)  # raises the names-listing ValueError

    @property
    def is_fleet(self) -> bool:
        return (self.replicas > 1 or self.specs is not None
                or self.autoscale is not None or self.workers > 1)

    @property
    def max_replicas(self) -> int:
        """Largest replica count this spec can reach (capacity anchor)."""
        if self.autoscale is not None:
            return max(self.replicas, self.autoscale.max_replicas)
        return self.replicas

    def to_dict(self) -> Dict:
        return {
            "replicas": self.replicas,
            "specs": list(self.specs) if self.specs is not None else None,
            "autoscale": self.autoscale.to_dict() if self.autoscale else None,
            "workers": self.workers,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "FleetSpec":
        data = dict(data) if isinstance(data, dict) else data
        if isinstance(data, dict) and isinstance(data.get("autoscale"), dict):
            data["autoscale"] = AutoscaleSpec.from_dict(data["autoscale"])
        if isinstance(data, dict) and data.get("specs") is not None:
            data["specs"] = tuple(data["specs"])
        return _from_dict(cls, data, "fleet")


@dataclasses.dataclass(frozen=True)
class RouterSpec:
    """Which replica each arrival goes to (repro_torch.sim.router registry)."""

    policy: str = "jsq"

    def __post_init__(self) -> None:
        if self.policy not in ROUTERS:
            raise ValueError(f"unknown router {self.policy!r} (have {ROUTERS})")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "RouterSpec":
        return _from_dict(cls, data, "router")


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """The real scheduling core's knobs — mirrors ``ScheduleConfig``
    field-for-field, so a spec file documents exactly what the scheduler
    will run with and validation is ScheduleConfig's own."""

    batching_window_s: float = 0.002
    batching_policy: str = "fixed"
    min_batching_window_s: float = 0.0
    slo_slack_fraction: float = 0.25
    max_pending_per_tenant: Optional[int] = None
    admission_policy: str = "cap"
    oversubscription: float = 1.0
    deadline_lead_fraction: float = 0.5
    preemption: bool = False
    preemption_budget_s: float = 0.010
    max_superkernel_size: int = 128
    r_bucketing: str = "pow2"
    straggler_eviction_ratio: float = 1.5
    latency_ewma_alpha: float = 0.2
    default_slo_s: float = 0.100
    allow_ragged_merge: bool = False

    def __post_init__(self) -> None:
        self.to_schedule_config()  # ScheduleConfig owns the validation

    def to_schedule_config(self) -> ScheduleConfig:
        return ScheduleConfig(**dataclasses.asdict(self))

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "SchedulerSpec":
        return _from_dict(cls, data, "scheduler")


@dataclasses.dataclass(frozen=True)
class CostModelSpec:
    """How a super-dispatch is priced (repro_torch.sim.costmodel).

    ``kind="roofline"`` is the analytical prior over the named hardware;
    ``kind="calibrated"`` loads a fitted ``CalibratedCostModel`` table
    (``calibration_path``, produced by ``python -m repro_torch calibrate`` or a
    live ``dynamic_trace --calibrate`` run) over that prior.
    ``compile_us > 0`` wraps the model in per-replica compile-cache
    cold-start accounting (``ColdStartCostModel``). On heterogeneous
    fleets (``fleet.specs``) each replica prices through its OWN
    hardware's roofline; ``hardware`` then only anchors capacity.
    """

    kind: str = "roofline"
    hardware: str = "h100"
    strategy: str = "space_time"
    small_kernel_efficiency: float = 0.45
    compile_us: float = 0.0
    calibration_path: Optional[str] = None
    ewma_alpha: float = 0.2
    # Bayesian shrinkage toward the roofline prior for sparse calibrated
    # keys: a fitted (bucket, R) cost observed n times prices as
    # (n*fitted + k*prior)/(n + k) with k = prior_strength. 0 = off
    # (fitted values win outright, the pre-shrinkage behavior).
    prior_strength: float = 0.0
    # per-replica measured-cost tables (FleetCalibrator): fleet and live
    # runs LOAD this file when it exists (fresh replicas start from
    # persisted tables instead of cold EWMAs) and live runs SAVE the
    # fitted tables back on completion. Sim runs never write it — the
    # byte-identical rerun contract must not depend on run count.
    fleet_calibration_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kind not in COST_KINDS:
            raise ValueError(f"unknown cost model kind {self.kind!r} "
                             f"(have {COST_KINDS})")
        resolve_spec(self.hardware)  # raises the names-listing ValueError
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r} (have {STRATEGIES})")
        if not (0.0 < self.small_kernel_efficiency <= 1.0):
            raise ValueError("small_kernel_efficiency must be in (0, 1], got "
                             f"{self.small_kernel_efficiency}")
        if self.compile_us < 0.0:
            raise ValueError(f"compile_us must be >= 0, got {self.compile_us}")
        if self.prior_strength < 0.0:
            raise ValueError(
                f"prior_strength must be >= 0, got {self.prior_strength} "
                "(pseudo-observations of the roofline prior)")
        if self.kind == "calibrated" and not self.calibration_path:
            raise ValueError(
                'kind="calibrated" needs calibration_path (a table saved by '
                "CalibratedCostModel.save / `python -m repro_torch calibrate`)")
        if self.fleet_calibration_path is not None:
            if not isinstance(self.fleet_calibration_path, str) \
                    or not self.fleet_calibration_path:
                raise ValueError(
                    "fleet_calibration_path must be a non-empty path "
                    f"(got {self.fleet_calibration_path!r}); it names the "
                    "JSON file FleetCalibrator.save writes")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "CostModelSpec":
        return _from_dict(cls, data, "cost_model")


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """Fractional spatial shares (``repro_torch.partition``), declaratively.

    ``policy="knee"`` runs the deterministic planner at build time: one
    slice per workload bucket, sized at its throughput knee and grown
    only as far as deadline feasibility demands, batch windows
    co-optimized (``repro_torch.partition.planner``). ``policy="explicit"``
    takes ``shares`` verbatim — one fraction per slice, tenants assigned
    round-robin (``tenant_id % len(shares)``).

    Partitioning is simulator-only (real chips expose no share knob
    here) and single-process; ``SystemSpec`` validates those pairings
    eagerly. ``replan_interval_s > 0`` re-runs the planner at fixed
    simulated intervals from each slice's OBSERVED mean merged batch
    size, swapping slice sizes mid-run — every re-plan lands in the
    metrics JSON and the flight-recorder timeline.
    """

    policy: str = "knee"
    shares: Optional[Tuple[float, ...]] = None   # explicit: per-slice
    share_grid: Optional[Tuple[float, ...]] = None  # knee: candidates
    knee_fraction: float = 0.9
    min_share: float = 0.0625
    slack_fraction: float = 0.5
    replan_interval_s: float = 0.0

    def __post_init__(self) -> None:
        if self.policy not in PARTITION_POLICIES:
            raise ValueError(
                f"unknown partition policy {self.policy!r} "
                f"(have {PARTITION_POLICIES})")
        if self.policy == "explicit" and not self.shares:
            raise ValueError(
                'partition.policy="explicit" needs shares (per-slice '
                "fractions of one chip, e.g. [0.5, 0.25, 0.25])")
        if self.policy == "knee" and self.shares is not None:
            raise ValueError(
                "partition.shares only applies to policy='explicit' "
                "(the knee planner derives shares); drop shares or set "
                "policy='explicit'")
        if self.shares is not None:
            shares = tuple(float(s) for s in self.shares)
            object.__setattr__(self, "shares", shares)
            for s in shares:
                if not (0.0 < s <= 1.0):
                    raise ValueError(
                        f"partition shares must be in (0, 1], got {s}")
            total = sum(shares)
            if total > 1.0 + 1e-9:
                raise ValueError(
                    f"partition shares sum to {total:g} > 1.0; shares "
                    f"are fractions of ONE chip — scale them down")
        if self.share_grid is not None:
            grid = tuple(float(s) for s in self.share_grid)
            object.__setattr__(self, "share_grid", grid)
            if not grid or any(not (0.0 < s <= 1.0) for s in grid) \
                    or list(grid) != sorted(set(grid)):
                raise ValueError(
                    "partition.share_grid must be strictly ascending "
                    f"fractions in (0, 1], got {list(grid)}")
        if not (0.0 < self.knee_fraction <= 1.0):
            raise ValueError(
                f"partition.knee_fraction must be in (0, 1], got "
                f"{self.knee_fraction}")
        if not (0.0 < self.min_share <= 1.0):
            raise ValueError(
                f"partition.min_share must be in (0, 1], got "
                f"{self.min_share}")
        if not (0.0 <= self.slack_fraction <= 1.0):
            raise ValueError(
                f"partition.slack_fraction must be in [0, 1], got "
                f"{self.slack_fraction}")
        if self.replan_interval_s < 0.0:
            raise ValueError(
                f"partition.replan_interval_s must be >= 0, got "
                f"{self.replan_interval_s}")

    def to_dict(self) -> Dict:
        return {
            "policy": self.policy,
            "shares": list(self.shares) if self.shares is not None else None,
            "share_grid": (list(self.share_grid)
                           if self.share_grid is not None else None),
            "knee_fraction": self.knee_fraction,
            "min_share": self.min_share,
            "slack_fraction": self.slack_fraction,
            "replan_interval_s": self.replan_interval_s,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "PartitionSpec":
        data = dict(data) if isinstance(data, dict) else data
        if isinstance(data, dict):
            for key in ("shares", "share_grid"):
                if data.get(key) is not None:
                    data[key] = tuple(data[key])
        return _from_dict(cls, data, "partition")


@dataclasses.dataclass(frozen=True)
class ObservabilitySpec:
    """The flight recorder (repro_torch.obs), declaratively. Off by default —
    recorder-off runs are byte-identical to pre-recorder builds.

    ``window_s`` is the telemetry tick (rolling p50/p95, backlog,
    utilization, SLO attainment per window) — 1 simulated millisecond by
    default, sized to the microsecond-scale dispatches the sims model;
    ``per_request`` adds one request span per completion to the trace
    (turn off to shrink traces to dispatch granularity on huge runs);
    ``trace_path``, when set, writes the Chrome ``trace_event`` JSON
    there after ``run()`` — loadable in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``.
    """

    enabled: bool = False
    window_s: float = 0.001
    per_request: bool = True
    trace_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError(
                f"observability.window_s must be > 0, got {self.window_s}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Dict) -> "ObservabilitySpec":
        return _from_dict(cls, data, "observability")


# The spec sections a dotted path walks through, by field name; a section
# that is absent or null takes the section's defaults before a leaf under
# it is set.
SECTIONS = {
    "workload": WorkloadSpec,
    "fleet": FleetSpec,
    "autoscale": AutoscaleSpec,
    "router": RouterSpec,
    "scheduler": SchedulerSpec,
    "cost_model": CostModelSpec,
    "observability": ObservabilitySpec,
    "partition": PartitionSpec,
}


def set_dotted(doc: Dict, dotted: Dict[str, object]) -> None:
    """Set each ``section.field`` path of ``dotted`` in the spec JSON
    ``doc``, in place: the override surface of ``SystemSpec.replace`` and
    ``SystemSpec.load``. A field is settable when its section's dataclass
    has it, whether or not ``doc`` spells it out, so a partial spec file
    takes the same overrides as the full ``to_dict()`` of its spec."""
    for path, value in dotted.items():
        node, fields = doc, {f.name for f in dataclasses.fields(SystemSpec)}
        *parents, leaf = path.split(".")
        for part in parents:
            section = SECTIONS.get(part)
            if section is None or part not in fields:
                raise ValueError(
                    f"cannot set {path!r}: {part!r} is not a spec section")
            child = node.get(part)
            if not isinstance(child, dict):
                # materialize defaults for absent optional sub-specs
                # (e.g. scheduler: null) so leaves under them resolve
                child = section().to_dict()
                node[part] = child
            node, fields = child, {f.name for f in dataclasses.fields(section)}
        if leaf not in fields:
            raise ValueError(
                f"cannot set {path!r}: unknown field {leaf!r} "
                f"(known: {sorted(fields)})")
        node[leaf] = value


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """The complete declarative experiment (see module docstring)."""

    mode: str = "sim"
    workload: WorkloadSpec = dataclasses.field(default_factory=WorkloadSpec)
    fleet: FleetSpec = dataclasses.field(default_factory=FleetSpec)
    router: RouterSpec = dataclasses.field(default_factory=RouterSpec)
    # None = each executor's own defaults (ScheduleConfig() for sims, the
    # engine-derived greedy schedule for live runs)
    scheduler: Optional[SchedulerSpec] = None
    cost_model: CostModelSpec = dataclasses.field(default_factory=CostModelSpec)
    observability: ObservabilitySpec = dataclasses.field(
        default_factory=ObservabilitySpec)
    # None = whole-chip execution; a PartitionSpec carves every replica
    # into fractional spatial slices (repro_torch.partition)
    partition: Optional[PartitionSpec] = None

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r} (have {MODES})")
        if self.partition is not None:
            if self.mode == "live":
                raise ValueError(
                    "mode='live' cannot combine with partition: "
                    "fractional spatial shares are a simulator-only "
                    "resource model (no live slice API); use mode='sim'")
            if self.fleet.workers > 1:
                raise ValueError(
                    "fleet.workers > 1 cannot combine with partition: "
                    "co-located partition pumps share per-chip state the "
                    "shard merge does not replay; set fleet.workers=1")
            if self.fleet.autoscale is not None:
                raise ValueError(
                    "partition cannot combine with fleet.autoscale: the "
                    "plan carves a fixed replica set and scale events "
                    "would need mid-run re-planning (see ROADMAP); drop "
                    "one")
            if self.fleet.specs is not None:
                raise ValueError(
                    "partition cannot combine with fleet.specs: slices "
                    "are carved from ONE base hardware "
                    "(cost_model.hardware); drop fleet.specs")
        if self.mode == "live":
            # the live fleet runs the same PumpCore/router stack as the
            # simulator — replicas, hetero specs, feasibility admission
            # and preemption are all valid. Only process-level features
            # stay sim-only:
            if self.fleet.workers > 1:
                raise ValueError(
                    "mode='live' cannot combine with fleet.workers > 1: "
                    "sharded forked execution is a simulator-only "
                    "optimization (replicas already execute real work)")
            if self.fleet.autoscale is not None:
                raise ValueError(
                    "mode='live' does not support fleet.autoscale yet: "
                    "live elasticity means provisioning real engines "
                    "mid-run (a deployment concern — see ROADMAP); fix "
                    "the replica count")
        if self.fleet.specs is not None and self.cost_model.kind == "calibrated":
            raise ValueError(
                "cost_model.kind='calibrated' cannot combine with "
                "fleet.specs: heterogeneous replicas price through their "
                "own per-hardware rooflines, and per-replica calibrated "
                "tables (FleetCalibrator) are not spec-addressable yet "
                "(see ROADMAP); drop fleet.specs or use kind='roofline'")
        if self.fleet.workers > 1:
            # sharded execution needs provably independent replicas —
            # same conditions repro_torch.sim.shard enforces at run time, but
            # surfaced at spec-load time per the front-door contract
            if self.router.policy != "round_robin":
                raise ValueError(
                    "fleet.workers > 1 requires router.policy="
                    "'round_robin' (state-oblivious routing keeps "
                    f"replicas independent); got {self.router.policy!r}")
            if self.fleet.autoscale is not None:
                raise ValueError(
                    "fleet.workers > 1 cannot combine with fleet.autoscale:"
                    " scale decisions read fleet-wide state; drop one")
            if (self.scheduler is not None
                    and self.scheduler.batching_policy != "fixed"):
                raise ValueError(
                    "fleet.workers > 1 requires the fixed batching window "
                    "(scheduler.batching_policy='fixed'); got "
                    f"{self.scheduler.batching_policy!r}")
            if (self.scheduler is not None
                    and self.scheduler.admission_policy != "cap"):
                raise ValueError(
                    "fleet.workers > 1 requires admission_policy='cap' "
                    "(feasibility admission reads per-replica committed "
                    "horizons the shard merge does not replay); got "
                    f"{self.scheduler.admission_policy!r}")
            if self.cost_model.fleet_calibration_path is not None:
                raise ValueError(
                    "fleet.workers > 1 cannot combine with cost_model."
                    "fleet_calibration_path: calibration reads fleet-wide "
                    "dispatch state the shard merge does not replay")
        if (self.cost_model.fleet_calibration_path is not None
                and self.mode == "sim" and not self.fleet.is_fleet):
            raise ValueError(
                "cost_model.fleet_calibration_path needs a fleet (replicas "
                "> 1, specs, or autoscale) or mode='live': the solo "
                "simulator has no per-replica tables to calibrate")

    # ----------------------------------------------------------- round trip
    def to_dict(self) -> Dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "mode": self.mode,
            "workload": self.workload.to_dict(),
            "fleet": self.fleet.to_dict(),
            "router": self.router.to_dict(),
            "scheduler": self.scheduler.to_dict() if self.scheduler else None,
            "cost_model": self.cost_model.to_dict(),
            "observability": self.observability.to_dict(),
            "partition": self.partition.to_dict() if self.partition else None,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "SystemSpec":
        if not isinstance(data, dict):
            raise ValueError(f"spec must be a JSON object, got {type(data).__name__}")
        data = dict(data)
        version = data.pop("schema_version", SCHEMA_VERSION)
        if not isinstance(version, int):
            raise ValueError(
                f"schema_version must be an integer, got {version!r}")
        if version > SCHEMA_VERSION:
            raise ValueError(
                f"spec schema_version {version} is newer than this build "
                f"supports ({SCHEMA_VERSION}); update the repo or re-save "
                f"the spec")
        converters = {
            "workload": WorkloadSpec.from_dict,
            "fleet": FleetSpec.from_dict,
            "router": RouterSpec.from_dict,
            "scheduler": SchedulerSpec.from_dict,
            "cost_model": CostModelSpec.from_dict,
            "observability": ObservabilitySpec.from_dict,
            "partition": PartitionSpec.from_dict,
        }
        for key, conv in converters.items():
            if isinstance(data.get(key), dict):
                data[key] = conv(data[key])
        if data.get("scheduler") is None:
            data.pop("scheduler", None)
        if data.get("partition") is None:
            data.pop("partition", None)
        return _from_dict(cls, data, "spec")

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json() + "\n")
        os.replace(tmp, path)

    @classmethod
    def from_json(cls, text: str) -> "SystemSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str, overrides: Optional[Dict[str, object]] = None) -> "SystemSpec":
        """The spec in the JSON file at ``path``, with the dotted
        ``overrides`` merged into the file's JSON before it is built (see
        the module docstring)."""
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            raise ValueError(
                f"spec file not found: {path!r} (committed examples live "
                f"under examples/specs/)") from None
        if overrides:
            if not isinstance(doc, dict):
                raise ValueError(f"spec must be a JSON object, got {type(doc).__name__}")
            set_dotted(doc, overrides)
        return cls.from_dict(doc)

    # -------------------------------------------------------------- override
    def replace(self, **dotted) -> "SystemSpec":
        """Functional override by dotted path — the CLI's ``--set``/axis
        surface: ``spec.replace(**{"workload.events": 2000,
        "router.policy": "jsq"})`` re-validates through from_dict."""
        doc = self.to_dict()
        set_dotted(doc, dotted)
        return SystemSpec.from_dict(doc)

    # ----------------------------------------------------------------- build
    def build(self):
        """Assemble the executor this spec's shape calls for: solo
        ``Simulator`` / ``FleetSimulator`` / engine-backed ``LiveFleet``
        behind a uniform ``run() -> RunReport`` surface."""
        from repro_torch.api.build import FleetRun, LiveRun, SimRun

        if self.mode == "live":
            return LiveRun(self)
        if self.partition is not None or self.fleet.is_fleet:
            # a partitioned solo replica is still a fleet of co-located
            # slice pumps sharing one chip's timeline
            return FleetRun(self)
        return SimRun(self)

    def run(self):
        """One-shot convenience: ``build()`` then ``run()``."""
        return self.build().run()


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """The HTTP front door (``python -m repro_torch serve``), declaratively.

    ``system`` describes the fleet behind the endpoints and must be a
    live spec — the server routes every ``POST /v1/predict`` through the
    same ``LiveFleet`` a ``simulate`` run of that spec would build, so
    capacity planning done in sim transfers to the deployed shape.
    ``workload`` fields still matter: tenants define the request classes
    (bucket/SLO per tenant id), ``arch`` picks the engine.

    ``report_path``, when set, receives the schema-versioned ``RunReport``
    JSON on graceful shutdown — the serve-smoke CI contract.
    """

    system: SystemSpec = dataclasses.field(
        default_factory=lambda: SystemSpec(mode="live"))
    host: str = "127.0.0.1"
    port: int = 8077
    report_path: Optional[str] = None
    request_timeout_s: float = 30.0   # per-request wait on the done event
    poll_interval_s: float = 0.050    # pump-thread heartbeat upper bound

    def __post_init__(self) -> None:
        if self.system.mode != "live":
            raise ValueError(
                "serve.system must have mode='live' (a server cannot fan "
                "out over simulated replicas); got "
                f"mode={self.system.mode!r}")
        if not (0 <= self.port < 65536):
            # port 0 binds an OS-assigned free port (tests / CI smoke)
            raise ValueError(f"port must be in [0, 65536), got {self.port}")
        if self.request_timeout_s <= 0:
            raise ValueError(
                f"request_timeout_s must be > 0, got {self.request_timeout_s}")
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0, got {self.poll_interval_s}")

    def to_dict(self) -> Dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "system": self.system.to_dict(),
            "host": self.host,
            "port": self.port,
            "report_path": self.report_path,
            "request_timeout_s": self.request_timeout_s,
            "poll_interval_s": self.poll_interval_s,
        }

    @classmethod
    def from_dict(cls, data: Dict) -> "ServeSpec":
        if not isinstance(data, dict):
            raise ValueError(
                f"serve spec must be a JSON object, got {type(data).__name__}")
        data = dict(data)
        data.pop("schema_version", None)
        if isinstance(data.get("system"), dict):
            data["system"] = SystemSpec.from_dict(data["system"])
        return _from_dict(cls, data, "serve")

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServeSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ServeSpec":
        try:
            with open(path) as fh:
                return cls.from_json(fh.read())
        except FileNotFoundError:
            raise ValueError(
                f"serve spec file not found: {path!r} (committed examples "
                f"live under examples/specs/)") from None

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json() + "\n")
        os.replace(tmp, path)

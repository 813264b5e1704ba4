"""The card's roofline description, as the cost models price work, and the
analytic roofline of one step that the dry run records.

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

The second half is the JAX package's analytic model (``analytic_cost``,
``analytic_collectives``, ``cache_bytes``, ``model_flops_for``) and its
``RooflineReport``, priced against the "h100" spec by default. The
reference also parses collective bytes out of XLA's optimized HLO text;
the port has no HLO, and a one-card program issues no collective, so its
records hold ``coll_bytes`` as zeros in every kind and ``t_collective`` is
the analytic term alone (the reference takes the larger of the two).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.config.model import BlockKind


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


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

COLL_FACTOR = {
    # per-chip link traffic multiplier on the op's LOCAL result bytes
    # (partitioned-module shapes): ring all-gather moves ~result bytes per
    # chip; ring all-reduce ~2x its buffer; the rest ~1x.
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def no_collectives() -> Dict[str, int]:
    """``coll_bytes`` of a one-card program: zero in every kind."""
    return {k: 0 for k in COLLECTIVES}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # raw counts of the program (the dry run's meta
    hlo_bytes: float             # run), recorded for transparency
    coll_bytes: Dict[str, int]   # per-chip local result bytes by kind
    model_flops: float           # 6*N_active*D (train) or 2*N_active*tokens (serve)
    analytic_flops: float = 0.0  # trip-count-exact analytic model (global)
    analytic_bytes: float = 0.0
    analytic_coll: Optional[Dict[str, float]] = None  # per-chip, trip-exact
    spec: HardwareSpec = H100

    @property
    def coll_total(self) -> int:
        return sum(self.coll_bytes.values())

    @property
    def coll_time_bytes(self) -> float:
        return sum(COLL_FACTOR[k] * v for k, v in self.coll_bytes.items())

    @property
    def t_compute(self) -> float:
        return self.spec.t_compute(self.analytic_flops / self.chips)

    @property
    def t_memory(self) -> float:
        return self.spec.t_memory(self.analytic_bytes / self.chips)

    @property
    def t_collective(self) -> float:
        """Per-chip collective seconds: max(analytic, counted bytes)."""
        text = self.spec.t_collective(self.coll_time_bytes)
        ana = self.spec.t_collective((self.analytic_coll or {}).get("total", 0.0))
        return max(text, ana)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.analytic_flops if self.analytic_flops else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_raw": self.hlo_flops,
            "hlo_bytes_raw": self.hlo_bytes,
            "analytic_flops": self.analytic_flops,
            "analytic_bytes": self.analytic_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_total": self.coll_total,
            "analytic_coll": self.analytic_coll or {},
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


_ATTENTION_KINDS = (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE, BlockKind.HYBRID_SHARED_ATTN)


def analytic_cost(cfg, shape, *, remat: bool = True) -> Dict[str, float]:
    """Analytic FLOPs + HBM bytes for one step of (cfg, shape): exact for
    GEMMs, first-order for elementwise (the reference's model, which it
    uses because XLA's CPU cost analysis counts a scanned loop body once).

    Conventions:
        train:   fwd(1x) + bwd(2x) + remat recompute(1x) = 4x fwd FLOPs
        prefill: 1x fwd
        decode:  1x fwd over 1 token/seq; HBM bytes dominated by weight +
                 cache streaming.
    """
    B, S = shape.global_batch, shape.seq_len
    tokens = B * (S if shape.kind in ("train", "prefill") else 1)
    dt_bytes = 2 if cfg.dtype == "bfloat16" else 4

    # ---- matmul params touched per token (active) -> GEMM flops
    n_active = cfg.active_param_count()
    # embedding lookup is a gather, not a matmul; subtract one vocab table
    n_matmul = n_active - cfg.vocab_size * cfg.d_model
    gemm_flops = 2.0 * tokens * n_matmul

    # ---- attention score/value flops per layer kind
    attn_flops = 0.0
    hd, Hq = cfg.head_dim, cfg.num_heads
    for i, kind in enumerate(cfg.layer_pattern):
        if kind not in _ATTENTION_KINDS:
            continue
        ak = cfg.attention_kind_at(i)
        if shape.kind in ("train", "prefill"):
            kv_eff = S if ak.value == "full" else min(cfg.sliding_window or S, S)
            # causal halves the average context; sliding window doesn't
            ctx = S / 2 if ak.value == "full" else kv_eff
            attn_flops += 4.0 * B * S * ctx * Hq * hd
        else:
            kv_eff = S if ak.value == "full" else min(cfg.sliding_window or S, S)
            attn_flops += 4.0 * B * kv_eff * Hq * hd

    # ---- SSM / RWKV recurrence flops
    ssm_flops = 0.0
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = s.num_ssm_heads or d_inner // s.head_dim
        P, N, L = s.head_dim, s.state_dim, s.chunk_size
        for kind in cfg.layer_pattern:
            if kind == BlockKind.MAMBA2:
                if shape.kind in ("train", "prefill"):
                    # intra-chunk: scores 2*T*L*N + y 2*T*L*H*P (causal ~ /2)
                    ssm_flops += B * S * (L * N + L * H * P) \
                        + 4.0 * B * S * H * P * N  # states in/out
                else:
                    ssm_flops += 6.0 * B * H * P * N
            elif kind == BlockKind.RWKV6:
                per_tok = 6.0 * H * N * N  # state update + readout
                ssm_flops += (B * S if shape.kind in ("train", "prefill") else B) * per_tok

    fwd = gemm_flops + attn_flops + ssm_flops
    factor = (4.0 if remat else 3.0) if shape.kind == "train" else 1.0
    flops = fwd * factor

    # ---- HBM bytes
    param_bytes = cfg.param_count() * dt_bytes
    if shape.kind == "train":
        # params fwd+bwd+remat reads + grad writes + opt state rw (f32)
        pbytes = param_bytes * 4 + cfg.param_count() * 4 * 3
        act_bytes = 12.0 * tokens * cfg.d_model * dt_bytes * cfg.num_layers / 4
        logit_bytes = 4.0 * tokens * cfg.vocab_size
        hbm = pbytes + act_bytes + logit_bytes
    elif shape.kind == "prefill":
        hbm = param_bytes + 8.0 * tokens * cfg.d_model * dt_bytes * cfg.num_layers / 4 \
            + cache_bytes(cfg, shape)
    else:
        hbm = cfg.active_param_count() * dt_bytes + cache_bytes(cfg, shape)
    return {"flops": flops, "hbm_bytes": hbm, "fwd_flops": fwd}


def analytic_collectives(
    cfg, shape, *, policy: str = "fsdp", tp_acts: bool = True,
    data: int = 16, model: int = 16, pods: int = 1,
) -> Dict[str, float]:
    """Analytic per-chip collective bytes for one step on the reference's
    production mesh (first-order ring-collective model):

      weight all-gather (fsdp):  passes x param_bytes      (train: fwd+bwd+remat=3)
      grad sync (train):         2 x param_bytes           (ring all-reduce, bf16)
      TP activation all-reduce:  4 x toks_local x d_model x 4B x n_blocks
                                 (1 row-parallel AR fwd + ~2 bwd + 1 remat per block)
      ZeRO-1 pod sync:           2 x param_bytes across pods (multi-pod train)
    """
    dt_bytes = 2 if cfg.dtype == "bfloat16" else 4
    param_bytes = cfg.param_count() * dt_bytes
    # Routed-expert weights are always expert-parallel and never gathered:
    # only the dense remainder moves under FSDP.
    dense_bytes = (cfg.param_count() - cfg.expert_param_count()) * dt_bytes
    B, S = shape.global_batch, shape.seq_len
    toks_local = B * (S if shape.kind in ("train", "prefill") else 1) / data
    n_blocks = cfg.num_layers

    # grads are synced over the data axis PER SHARD (replicate keeps full bytes)
    shard_div = 1 if policy == "replicate" else model

    out = {"weight_ag": 0.0, "grad_ar": 0.0, "tp_ar": 0.0, "pod_ar": 0.0}
    if shape.kind == "train":
        if policy == "fsdp":
            out["weight_ag"] = 3.0 * dense_bytes
        out["grad_ar"] = 2.0 * param_bytes / shard_div
        if pods > 1:
            out["pod_ar"] = 2.0 * param_bytes / shard_div
        if tp_acts and policy in ("fsdp", "tp"):
            out["tp_ar"] = 4.0 * toks_local * cfg.d_model * 4.0 * n_blocks
    else:
        if policy == "fsdp":
            # amortized: weights stay gathered across the (single) step;
            # decode re-gathers the data-sharded fraction only.
            out["weight_ag"] = 1.0 * dense_bytes / max(data, 1)
        if tp_acts and policy in ("fsdp", "tp"):
            out["tp_ar"] = 2.0 * toks_local * cfg.d_model * 4.0 * n_blocks
    out["total"] = sum(out.values())
    return out


def cache_bytes(cfg, shape) -> float:
    """Decode-state bytes read per step (KV caches + recurrent states)."""
    B, S = shape.global_batch, shape.seq_len
    dt_bytes = 2 if cfg.dtype == "bfloat16" else 4
    total = 0.0
    for i, kind in enumerate(cfg.layer_pattern):
        if kind in _ATTENTION_KINDS:
            ak = cfg.attention_kind_at(i)
            s_alloc = S if ak.value == "full" else min(cfg.sliding_window or S, S)
            total += 2.0 * B * cfg.num_kv_heads * s_alloc * cfg.head_dim * dt_bytes
        elif kind == BlockKind.MAMBA2 and cfg.ssm is not None:
            s = cfg.ssm
            d_inner = s.expand * cfg.d_model
            H = s.num_ssm_heads or d_inner // s.head_dim
            total += B * H * s.head_dim * s.state_dim * 4
        elif kind == BlockKind.RWKV6 and cfg.ssm is not None:
            H = cfg.d_model // cfg.ssm.head_dim
            total += B * H * cfg.ssm.head_dim ** 2 * 4
    return total


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N_active*D for training; 2*N_active*tokens for serving."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch

"""Model configuration dataclasses (the port's own copy).

A ModelConfig fully determines a decoder-only (or hybrid) transformer stack:
layer pattern, attention geometry, FFN/MoE geometry, SSM geometry, vocab and
modality frontend. The schema is field-for-field the JAX package's
``repro.config.model`` so that a config built by either package compares
equal field by field; the port keeps its own copy because it imports
nothing of ``repro``.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class AttentionKind(str, enum.Enum):
    """Attention flavour of an attention block."""

    FULL = "full"            # global causal attention
    SLIDING = "sliding"      # sliding-window causal attention (sub-quadratic)
    NONE = "none"            # attention-free architecture (pure SSM)


class BlockKind(str, enum.Enum):
    """One entry in the per-layer block pattern."""

    ATTN_MLP = "attn_mlp"        # standard transformer block (attention + MLP/FFN)
    ATTN_MOE = "attn_moe"        # attention + mixture-of-experts FFN
    MAMBA2 = "mamba2"            # Mamba2 SSM block
    RWKV6 = "rwkv6"              # RWKV-6 "Finch" time-mix + channel-mix block
    HYBRID_SHARED_ATTN = "hybrid_shared_attn"  # Zamba2 shared attention block


class Modality(str, enum.Enum):
    TEXT = "text"
    VISION_TEXT = "vision_text"  # VLM: precomputed patch embeddings + text
    AUDIO_TOKENS = "audio_tokens"  # decoder over codec tokens (MusicGen)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts geometry."""

    num_experts: int
    experts_per_token: int          # top-k
    expert_d_ff: int                # per-expert hidden width
    num_shared_experts: int = 0     # always-on shared experts (0 for assigned archs)
    router_aux_loss_weight: float = 0.01
    router_jitter: float = 0.0
    capacity_factor: float = 1.25   # per-expert capacity = cf * tokens/experts

    def __post_init__(self) -> None:
        if self.experts_per_token > self.num_experts:
            raise ValueError(
                f"top-k {self.experts_per_token} > num_experts {self.num_experts}"
            )


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba2) / linear-recurrence (RWKV6) geometry."""

    state_dim: int = 64            # N: per-head recurrent state size
    num_ssm_heads: int = 0         # 0 -> derived as d_inner // head_dim
    head_dim: int = 64             # P: channels per SSM head
    expand: int = 2                # d_inner = expand * d_model
    conv_width: int = 4            # depthwise causal conv width (Mamba2)
    chunk_size: int = 256          # chunked-scan block length
    dt_rank: int = 0               # unused by Mamba2 (scalar dt per head)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description. One per assigned architecture."""

    name: str
    source: str                     # citation: arXiv id / HF model card
    family: str                     # dense | moe | hybrid | ssm | vlm | audio

    num_layers: int
    d_model: int
    vocab_size: int

    # --- attention geometry ------------------------------------------------
    num_heads: int = 0              # 0 for attention-free archs
    num_kv_heads: int = 0           # GQA KV heads
    head_dim: int = 0               # 0 -> d_model // num_heads
    attention_kind: AttentionKind = AttentionKind.FULL
    sliding_window: int = 0         # window size when attention_kind == SLIDING
    global_every: int = 0           # gemma3: 1 global layer every N (0 = never)
    qkv_bias: bool = False          # qwen2 uses bias on QKV
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0      # gemma-style final-logit soft-capping

    # --- FFN geometry -------------------------------------------------------
    d_ff: int = 0
    mlp_gated: bool = True          # SwiGLU-style gated MLP
    moe: Optional[MoEConfig] = None

    # --- SSM geometry (hybrid / ssm archs) -----------------------------------
    ssm: Optional[SSMConfig] = None

    # --- layer pattern --------------------------------------------------------
    # If None, every layer is the "default" block for the family. Otherwise a
    # tuple of BlockKind with len == num_layers.
    block_pattern: Optional[Tuple[BlockKind, ...]] = None

    # --- modality -------------------------------------------------------------
    modality: Modality = Modality.TEXT
    # VLM / audio stub frontend: number of prefix embedding positions supplied
    # as precomputed frame/patch embeddings by input_specs().
    num_prefix_embeddings: int = 0
    frontend_embed_dim: int = 0     # dim of stubbed frontend output (0 = d_model)

    # --- norm / misc -----------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embed: bool = False       # gemma-family sqrt(d_model) embed scaling
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ helpers
    def __post_init__(self) -> None:
        if self.attention_kind != AttentionKind.NONE:
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: num_heads required for attention arch")
            if self.num_kv_heads <= 0:
                object.__setattr__(self, "num_kv_heads", self.num_heads)
            if self.num_heads % self.num_kv_heads != 0:
                raise ValueError(
                    f"{self.name}: num_heads {self.num_heads} not divisible by "
                    f"num_kv_heads {self.num_kv_heads}"
                )
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.block_pattern is not None and len(self.block_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: block_pattern len {len(self.block_pattern)} != "
                f"num_layers {self.num_layers}"
            )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def layer_pattern(self) -> Tuple[BlockKind, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        if self.family in ("dense", "vlm", "audio"):
            default = BlockKind.ATTN_MLP
        elif self.family == "moe":
            default = BlockKind.ATTN_MOE
        elif self.family == "ssm":
            default = BlockKind.RWKV6
        else:
            raise ValueError(f"{self.name}: family {self.family} needs block_pattern")
        return tuple(default for _ in range(self.num_layers))

    @property
    def is_subquadratic(self) -> bool:
        """True when the arch supports O(seq) long-context decode.

        SSM/RWKV archs are O(1)-state; hybrids with a bounded number of full
        attention layers decode one token in O(seq) cache reads (linear);
        sliding-window dense archs bound the cache window.
        """
        pattern = self.layer_pattern
        n_full_attn = sum(
            1
            for i, b in enumerate(pattern)
            if b in (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE, BlockKind.HYBRID_SHARED_ATTN)
            and self.attention_kind_at(i) == AttentionKind.FULL
        )
        if self.attention_kind == AttentionKind.NONE:
            return True
        if self.family == "hybrid":
            return True  # Mamba2-majority; sparse attn decode is linear
        if self.attention_kind == AttentionKind.SLIDING:
            return True
        return n_full_attn == 0

    def attention_kind_at(self, layer: int) -> AttentionKind:
        """Per-layer attention kind (gemma3 interleaves local/global)."""
        if self.attention_kind != AttentionKind.SLIDING:
            return self.attention_kind
        if self.global_every and (layer + 1) % self.global_every == 0:
            return AttentionKind.FULL
        return AttentionKind.SLIDING

    # ----------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count of the substrate model (frontend stub excluded)."""
        total = self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.d_model  # final norm
        shared_counted = False
        for i, kind in enumerate(self.layer_pattern):
            if kind == BlockKind.HYBRID_SHARED_ATTN:
                # Zamba2-style shared transformer block: ONE weight set reused
                # at every application point (plus a small per-site LoRA-free
                # linear adapter which we fold into the shared count).
                if shared_counted:
                    continue
                shared_counted = True
            total += self._block_params(kind)
        if self.num_prefix_embeddings:
            fed = self.frontend_embed_dim or self.d_model
            total += fed * self.d_model  # modality projector
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        total = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model
        total += self.d_model
        for kind in self.layer_pattern:
            total += self._block_params(kind, active_only=True)
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        p = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            p += nq * hd + 2 * nkv * hd
        return p + 2 * d  # two rmsnorm scales per block

    def _mlp_params(self) -> int:
        mult = 3 if self.mlp_gated else 2
        return mult * self.d_model * self.d_ff

    def _block_params(self, kind: BlockKind, active_only: bool = False) -> int:
        d = self.d_model
        if kind == BlockKind.ATTN_MLP:
            return self._attn_params() + self._mlp_params()
        if kind == BlockKind.ATTN_MOE:
            assert self.moe is not None
            n_exp = self.moe.experts_per_token if active_only else self.moe.num_experts
            n_exp += self.moe.num_shared_experts  # shared experts always run
            mult = 3 if self.mlp_gated else 2
            expert = mult * d * self.moe.expert_d_ff
            router = d * self.moe.num_experts
            return self._attn_params() + n_exp * expert + router
        if kind == BlockKind.MAMBA2:
            assert self.ssm is not None
            s = self.ssm
            d_inner = s.expand * d
            nheads = s.num_ssm_heads or d_inner // s.head_dim
            p = d * (2 * d_inner + 2 * nheads * s.state_dim + nheads)  # in_proj (z,x,B,C,dt)
            p += s.conv_width * (d_inner + 2 * nheads * s.state_dim)   # conv over x,B,C
            p += 2 * nheads                                            # A_log, D
            p += d_inner                                               # gated rmsnorm
            p += d_inner * d                                           # out_proj
            return p + d  # pre-norm
        if kind == BlockKind.RWKV6:
            # time-mix (r,k,v,g,w projections + output) + channel-mix
            p = 4 * d * d + d * d  # r,k,v,g + output
            p += d * 64 * 2 + 5 * d * 2  # w lora + token-shift mix params (approx, exact in model)
            p += d * self.d_ff + self.d_ff * d + d * d  # channel mix (k,v,r)
            return p + 2 * d
        if kind == BlockKind.HYBRID_SHARED_ATTN:
            # Zamba2 shared attention block: attention + dense MLP
            return self._attn_params() + self._mlp_params()
        raise ValueError(kind)

    def expert_param_count(self) -> int:
        """Routed-expert weights only (stay sharded under expert parallelism)."""
        if self.moe is None:
            return 0
        mult = 3 if self.mlp_gated else 2
        per_layer = self.moe.num_experts * mult * self.d_model * self.moe.expert_d_ff
        n_moe = sum(1 for k in self.layer_pattern if k == BlockKind.ATTN_MOE)
        return per_layer * n_moe

    def flops_per_token(self, seq_len: int = 1) -> int:
        """6*N_active*D style estimate (fwd+bwd=6x; fwd-only = 2x active params)."""
        return 2 * self.active_param_count()


def round_up(x: int, m: int) -> int:
    return m * math.ceil(x / m)

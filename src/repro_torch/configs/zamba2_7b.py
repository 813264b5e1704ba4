"""zamba2-7b [arXiv:2411.15242].

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Mamba2 backbone with shared attention blocks interleaved (1 shared-attn
block per 6 layers, Zamba2 style).
"""

from repro_torch.config import BlockKind, ModelConfig, SSMConfig, register_config

_PATTERN = tuple(
    BlockKind.HYBRID_SHARED_ATTN if (i + 1) % 6 == 0 else BlockKind.MAMBA2
    for i in range(81)
)

CONFIG = register_config(
    ModelConfig(
        name="zamba2-7b",
        source="arXiv:2411.15242",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        vocab_size=32000,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
        block_pattern=_PATTERN,
    )
)

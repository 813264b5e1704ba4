"""rwkv6-1.6b "Finch" [arXiv:2404.05892].

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536. Data-dependent
decay linear-attention recurrence (WKV6): 32 heads of N = V = 64, an O(1)
decode state per head.
"""

from repro_torch.config import AttentionKind, BlockKind, ModelConfig, SSMConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="rwkv6-1.6b",
        source="arXiv:2404.05892",
        family="ssm",
        num_layers=24,
        d_model=2048,
        vocab_size=65536,
        num_heads=0,
        attention_kind=AttentionKind.NONE,
        d_ff=7168,
        ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=256),
        block_pattern=tuple(BlockKind.RWKV6 for _ in range(24)),
    )
)

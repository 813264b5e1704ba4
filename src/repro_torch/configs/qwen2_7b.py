"""qwen2-7b [arXiv:2407.10671].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="qwen2-7b",
        source="arXiv:2407.10671",
        family="dense",
        num_layers=28,
        d_model=3584,
        vocab_size=152064,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
)

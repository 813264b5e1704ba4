"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="stablelm-1.6b",
        source="hf:stabilityai/stablelm-2-1_6b",
        family="dense",
        num_layers=24,
        d_model=2048,
        vocab_size=100352,
        num_heads=32,
        num_kv_heads=32,
        d_ff=5632,
        rope_theta=10_000.0,
    )
)

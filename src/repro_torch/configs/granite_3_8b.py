"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base family].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""

from repro_torch.config import ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="granite-3-8b",
        source="hf:ibm-granite/granite-3.0-2b-base",
        family="dense",
        num_layers=40,
        d_model=4096,
        vocab_size=49155,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        rope_theta=10_000.0,
    )
)

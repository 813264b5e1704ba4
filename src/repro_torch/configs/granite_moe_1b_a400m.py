"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155, MoE 32 experts
top-8. ~1.3B total params, ~400M active.
"""

from repro_torch.config import ModelConfig, MoEConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="granite-moe-1b-a400m",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        family="moe",
        num_layers=24,
        d_model=1024,
        vocab_size=49155,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,  # per-expert hidden width
        moe=MoEConfig(num_experts=32, experts_per_token=8, expert_d_ff=512),
        tie_embeddings=True,
        rope_theta=10_000.0,
    )
)

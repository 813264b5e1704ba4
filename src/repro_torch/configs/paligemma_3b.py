"""paligemma-3b [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216. SigLIP vision
encoder + gemma decoder; the SigLIP frontend is a STUB: callers supply 256
precomputed patch embeddings (siglip-so400m 14x14 patches on 224px ->
16x16=256 tokens, 1152-dim), which the model projects to d_model
(``frontend_proj``). Head dim 256.
"""

from repro_torch.config import Modality, ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="paligemma-3b",
        source="arXiv:2407.07726",
        family="vlm",
        num_layers=18,
        d_model=2048,
        vocab_size=257216,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        modality=Modality.VISION_TEXT,
        num_prefix_embeddings=256,
        frontend_embed_dim=1152,
        tie_embeddings=True,
        scale_embed=True,
        rope_theta=10_000.0,
    )
)

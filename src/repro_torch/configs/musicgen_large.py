"""musicgen-large [arXiv:2306.05284].

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048. Decoder-only LM over
EnCodec audio tokens. The EnCodec/conv frontend is a STUB: callers supply
precomputed frame embeddings (64 conditioning frames, 1024-dim), which the
model projects to d_model; the decoder consumes codec-token ids with a
2048-entry codebook vocabulary.
"""

from repro_torch.config import Modality, ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="musicgen-large",
        source="arXiv:2306.05284",
        family="audio",
        num_layers=48,
        d_model=2048,
        vocab_size=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        mlp_gated=False,  # musicgen uses plain (non-gated) FFN
        modality=Modality.AUDIO_TOKENS,
        num_prefix_embeddings=64,   # stubbed conditioning frames
        frontend_embed_dim=1024,
    )
)

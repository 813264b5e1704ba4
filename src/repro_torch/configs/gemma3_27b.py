"""gemma3-27b [hf:google/gemma-3-1b-pt family, 27B geometry].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144. 5:1
local(sliding-window-1024):global attention, 128k context, head_dim=128
per model card. Sliding layers keep ring caches of 1024 positions; the
final logits are softcapped at 30.
"""

from repro_torch.config import AttentionKind, ModelConfig, register_config

CONFIG = register_config(
    ModelConfig(
        name="gemma3-27b",
        source="hf:google/gemma-3-1b-pt",
        family="dense",
        num_layers=62,
        d_model=5376,
        vocab_size=262144,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        attention_kind=AttentionKind.SLIDING,
        sliding_window=1024,
        global_every=6,  # 5 local : 1 global
        logit_softcap=30.0,
        tie_embeddings=True,
        scale_embed=True,
        rope_theta=1_000_000.0,
    )
)

"""Architectures the port runs; each module registers its config on import."""

from repro_torch.configs import (  # noqa: F401
    gemma3_27b,
    granite_3_8b,
    granite_moe_1b_a400m,
    llama4_maverick_400b_a17b,
    musicgen_large,
    paligemma_3b,
    qwen2_7b,
    rwkv6_1_6b,
    stablelm_1_6b,
    zamba2_7b,
)

PORTED_ARCHS = (
    "stablelm-1.6b",
    "rwkv6-1.6b",
    "paligemma-3b",
    "musicgen-large",
    "qwen2-7b",
    "granite-3-8b",
    "gemma3-27b",
    "granite-moe-1b-a400m",
    "zamba2-7b",
    "llama4-maverick-400b-a17b",
)

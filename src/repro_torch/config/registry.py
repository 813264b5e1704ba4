"""Architecture config registry + smoke-variant derivation.

``repro_torch.configs`` modules register themselves on import; ``get_config``
imports the package lazily. Only the architectures the port can run are
registered (see ``ROADMAP.md`` for the block kinds still to port).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.config.model import BlockKind, ModelConfig, MoEConfig, SSMConfig

_REGISTRY: Dict[str, ModelConfig] = {}


def register_config(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY and _REGISTRY[cfg.name] != cfg:
        raise ValueError(f"conflicting re-registration of config {cfg.name!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    importlib.import_module("repro_torch.configs")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_REGISTRY)}")


def list_configs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests.

    Keeps the *structure* (block pattern family, GQA ratio, gating, MoE
    top-k, SSM chunking) while shrinking every width to laptop scale:
    <=2 layers, d_model<=512, <=4 experts. Same arithmetic as the JAX
    package's ``smoke_variant``, so both derive the identical config.
    """
    d_model = min(d_model, 512)
    if cfg.num_heads > 0:
        num_heads = min(cfg.num_heads, 4)
        # preserve GQA grouping where possible
        q_per_kv = max(1, cfg.q_per_kv)
        num_kv = max(1, num_heads // min(q_per_kv, num_heads))
    else:
        num_heads = 0
        num_kv = 0
    head_dim = (d_model // num_heads) if num_heads else 0

    moe = None
    if cfg.moe is not None:
        n_exp = min(cfg.moe.num_experts, 4)
        moe = MoEConfig(
            num_experts=n_exp,
            experts_per_token=min(cfg.moe.experts_per_token, n_exp),
            expert_d_ff=min(cfg.moe.expert_d_ff, 2 * d_model),
            router_aux_loss_weight=cfg.moe.router_aux_loss_weight,
            capacity_factor=cfg.moe.capacity_factor,
        )

    ssm = None
    if cfg.ssm is not None:
        ssm = SSMConfig(
            state_dim=min(cfg.ssm.state_dim, 16),
            head_dim=min(cfg.ssm.head_dim, 32),
            expand=cfg.ssm.expand,
            conv_width=cfg.ssm.conv_width,
            chunk_size=16,
        )

    pattern = None
    if cfg.block_pattern is not None:
        # keep the first occurrence of each distinct block kind, in order
        seen: List[BlockKind] = []
        for b in cfg.block_pattern:
            if b not in seen:
                seen.append(b)
        pattern = tuple((seen * num_layers)[:num_layers]) if seen else None
        num_layers = len(pattern) if pattern else num_layers

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=num_layers,
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, 1024),
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe=moe,
        ssm=ssm,
        block_pattern=pattern,
        num_prefix_embeddings=min(cfg.num_prefix_embeddings, 4),
        frontend_embed_dim=min(cfg.frontend_embed_dim, d_model)
        if cfg.frontend_embed_dim
        else 0,
        dtype="float32",
    )

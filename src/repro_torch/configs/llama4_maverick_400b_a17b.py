"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Scout-17B-16E family].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 (+1 shared expert, llama4 style). Maverick interleaves dense and MoE
FFN layers (interleave_moe_layer_step=2), which is what lands the total at
~400B with 128 experts. Early-fusion multimodal: the vision frontend is
stubbed; text-token path is exercised here.
"""

from repro_torch.config import BlockKind, ModelConfig, MoEConfig, register_config

_PATTERN = tuple(
    BlockKind.ATTN_MOE if i % 2 == 1 else BlockKind.ATTN_MLP for i in range(48)
)

CONFIG = register_config(
    ModelConfig(
        name="llama4-maverick-400b-a17b",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        family="moe",
        num_layers=48,
        d_model=5120,
        vocab_size=202048,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        moe=MoEConfig(
            num_experts=128,
            experts_per_token=1,
            expert_d_ff=8192,
            num_shared_experts=1,
        ),
        block_pattern=_PATTERN,
        rope_theta=500_000.0,
    )
)

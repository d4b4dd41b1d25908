"""Phi-3.5-MoE-42B (6.6B active) — GQA attention + 16-expert top-2 MoE FFN.

32L d_model=4096 32H (GQA kv=8) d_ff=6400 (per expert) vocab=32064
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi3.5-moe-42b-a6.6b")
def phi3_5_moe_42b() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        ffn_type="swiglu",
        n_experts=16,
        experts_per_token=2,
    )

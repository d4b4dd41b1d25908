"""Moonshot-v1-16B-A3B (Moonlight) — 64-expert top-6 MoE, MHA attention.

48L d_model=2048 16H (kv=16 => MHA) d_ff=1408 (per expert) vocab=163840
[hf:moonshotai/Moonlight-16B-A3B; hf]

n_kv_heads == n_heads => e == d, so the paper's KP/VP removal variants
(Fig 1c/d) are additionally legal for this arch, not just QP removal.
"""
from repro_torch.configs.base import ModelConfig, register


@register("moonshot-v1-16b-a3b")
def moonshot_v1_16b() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        ffn_type="swiglu",
        n_experts=64,
        experts_per_token=6,
    )

"""Qwen2.5-32B — dense GQA decoder with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family scaling; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2.5-32b")
def qwen2_5_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        source="[hf:Qwen/Qwen2.5-0.5B; hf]",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        ffn_type="swiglu",
    )

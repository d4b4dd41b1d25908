"""Phi-3-medium-14B — dense GQA decoder, RoPE + SwiGLU.

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("phi3-medium-14b")
def phi3_medium_14b() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        source="[arXiv:2404.14219; unverified]",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        ffn_type="swiglu",
    )

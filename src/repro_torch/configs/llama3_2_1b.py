"""Llama-3.2-1B — small llama3 dense GQA decoder.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.2-1b")
def llama3_2_1b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        source="[hf:meta-llama/Llama-3.2-1B; unverified]",
        n_layers=16,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500_000.0,
        ffn_type="swiglu",
        tie_embeddings=True,
    )

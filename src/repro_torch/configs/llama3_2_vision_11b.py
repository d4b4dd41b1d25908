"""Llama-3.2-Vision-11B — VLM: llama3 trunk with cross-attention image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Every 5th layer is a cross-attention layer attending to vision tokens.  The
modality frontend is a STUB, as in the reference: the caller supplies
precomputed patch embeddings of shape (batch, n_vision_tokens, d_model)
(``forward_seq(..., vision=)``, ``Engine.submit(req, vision=)``).
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3.2-vision-11b")
def llama3_2_vision_11b() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-vision-11b",
        family="vlm",
        source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        ffn_type="swiglu",
        cross_attn_every=5,
        n_vision_tokens=1600,
    )

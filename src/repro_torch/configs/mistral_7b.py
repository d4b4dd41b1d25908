"""Mistral-7B — the paper's §3 GQA example (serial block, SwiGLU).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096.
The port's main path: ``chip_smoke.py`` serves it at full width.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mistral-7b")
def mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b",
        family="dense",
        source="[paper §3; arXiv:2310.06825]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        sliding_window=4096,
        ffn_type="swiglu",
    )

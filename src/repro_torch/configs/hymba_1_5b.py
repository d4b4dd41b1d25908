"""Hymba-1.5B — hybrid: parallel attention + mamba(SSM) heads in each layer.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16
[arXiv:2411.13676; hf]

Each block runs attention heads and SSD (mamba2-style) heads in parallel on
the same input and mean-fuses their outputs (simplified from the paper's
learned per-head fusion).  Attention uses a sliding window so the KV cache is
bounded.  Q is square (25 x 64 = 1600), so the exact merge removes Q; P
stays, because the FFN reads the fused attention+SSM stream.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hymba-1.5b")
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="[arXiv:2411.13676; hf]",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=1024,
        ffn_type="swiglu",
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
    )

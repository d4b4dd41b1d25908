"""Mamba2-2.7B — attention-free SSD (state-space duality) stack.

64L d_model=2560 (attn-free) d_ff=0 vocab=50280 ssm_state=128
[arXiv:2405.21060; unverified]

The paper's QP-removal technique does not apply (no Q/K/V/P exist), so
it is served in its own ``standard`` block style.  It carries the SSD
scan at its widest state: 80 heads of P=64 over N=128.
"""
from repro_torch.configs.base import ModelConfig, register


@register("mamba2-2.7b")
def mamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        source="[arXiv:2405.21060; unverified]",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        rope_style="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_n_groups=1,
        ssm_conv_width=4,
        ssm_chunk=256,
        tie_embeddings=True,
    )

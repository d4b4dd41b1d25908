"""ChatGLM3-6B — dense GQA (kv=2) decoder with 2D (partial/interleaved) RoPE.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024
[arXiv:2406.12793; hf]

ChatGLM applies rotary embedding to only half of each head dimension in the
interleaved-pair layout ("chatglm2d"); the other half is passed through.
"""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def chatglm3_6b() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        source="[arXiv:2406.12793; hf]",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope_style="chatglm2d",
        rope_fraction=0.5,
        qkv_bias=True,  # chatglm uses add_qkv_bias
        ffn_type="swiglu",
    )

"""HuBERT-XLarge — encoder-only audio transformer (wav2vec2 arch).

48L d_model=1280 16H (kv=16 => MHA) d_ff=5120 vocab=504
[arXiv:2106.07447; unverified]

Encoder-only: ``causal=False``, so it runs through ``forward_seq`` only
(no cache, no engine).  The audio frontend (conv feature extractor) is a
STUB, as in the reference: the caller supplies precomputed frame
embeddings (batch, frames, d_model).  Positional information comes from a
depthwise-conv positional embedding (wav2vec2-style), not RoPE.  MHA (e==d)
means all three paper removal variants (QP/KP/VP) are legal.
"""
from repro_torch.configs.base import ModelConfig, register


@register("hubert-xlarge")
def hubert_xlarge() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        source="[arXiv:2106.07447; unverified]",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        rope_style="none",
        conv_pos_width=128,
        ffn_type="gelu_mlp",
    )

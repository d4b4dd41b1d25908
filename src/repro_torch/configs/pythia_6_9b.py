"""Pythia-6.9B — the paper's §3 MHA example (parallel attention/FFN).

32L d_model=4096 32H MHA d_ff=16384 vocab=50400, parallel block, GeLU MLP.
Served as a source model only: ``merge_skipless`` refuses a parallel block.
"""
from repro_torch.configs.base import ModelConfig, register


@register("pythia-6.9b")
def pythia_6_9b() -> ModelConfig:
    return ModelConfig(
        name="pythia-6.9b",
        family="dense",
        source="[paper §3; EleutherAI/pythia-6.9b]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=16384,
        vocab_size=50400,
        ffn_type="gelu_mlp",
        parallel_block=True,
    )

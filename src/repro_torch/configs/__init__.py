"""Config registry. Importing this package registers the port's archs.

A copy of ``repro.configs`` restricted to what the port serves: the dense
stacks Mistral-7B, Llama-3.2-1B, Phi-3-medium-14B, Qwen2.5-32B,
Pythia-6.9B and ChatGLM3-6B, the MoE stacks Phi-3.5-MoE and
Moonshot-v1-16B-A3B, the hybrid Hymba-1.5B, the SSM stack Mamba2-2.7B,
the VLM Llama-3.2-Vision-11B and the audio encoder HuBERT-XLarge: every
arch of the reference.  ``shapes.py`` stays out until the dry-run
analysis is ported.  The port never imports the JAX package.
"""
from repro_torch.configs.base import (
    ModelConfig,
    REGISTRY,
    get_config,
    list_archs,
    reduce_config,
    register,
)

# eagerly import every arch module so REGISTRY is complete
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    hubert_xlarge,
    hymba_1_5b,
    llama3_2_1b,
    llama3_2_vision_11b,
    mamba2_2_7b,
    mistral_7b,
    moonshot_v1_16b,
    phi3_5_moe_42b,
    phi3_medium_14b,
    pythia_6_9b,
    qwen2_5_32b,
)

__all__ = [
    "ModelConfig",
    "REGISTRY",
    "get_config",
    "list_archs",
    "reduce_config",
    "register",
]

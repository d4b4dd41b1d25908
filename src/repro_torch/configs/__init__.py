"""Config registry. Importing this package registers the port's archs.

A copy of ``repro.configs`` restricted to what the port serves (the
skipless Mistral-7B main path); the port never imports the JAX package.
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
from repro_torch.configs import mistral_7b  # noqa: F401

__all__ = [
    "ModelConfig",
    "REGISTRY",
    "get_config",
    "list_archs",
    "reduce_config",
    "register",
]

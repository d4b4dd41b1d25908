"""Config registry. Importing this package registers the port's archs.

A copy of ``repro.configs`` restricted to what the port serves (skipless
Mistral-7B, Hymba-1.5B and Mamba2-2.7B); the port never imports the JAX
package.
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
    hymba_1_5b,
    mamba2_2_7b,
    mistral_7b,
)

__all__ = [
    "ModelConfig",
    "REGISTRY",
    "get_config",
    "list_archs",
    "reduce_config",
    "register",
]

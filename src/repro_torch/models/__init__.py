from repro_torch.models import backends
from repro_torch.models.transformer import (
    DecodeCache,
    DensePrefillDest,
    cache_spec,
    count_params,
    forward_prefill,
    forward_seq,
    forward_step,
    init_cache,
    init_params,
    layer_plan,
    prefill_style_key,
    serving_style_key,
)

__all__ = [
    "DecodeCache",
    "DensePrefillDest",
    "backends",
    "cache_spec",
    "count_params",
    "forward_prefill",
    "forward_seq",
    "forward_step",
    "init_cache",
    "init_params",
    "layer_plan",
    "prefill_style_key",
    "serving_style_key",
]

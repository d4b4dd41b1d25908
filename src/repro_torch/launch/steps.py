"""The step functions and meta-device input stand-ins of every dry-run cell:
the counterpart of ``repro.launch.steps``.

``input_specs(cfg, shape)`` returns tensors on the ``meta`` device for
every model input (shapes and dtypes, no values, no allocation: the
counterpart of JAX's ``ShapeDtypeStruct``), ``param_specs`` /
``cache_specs`` / ``opt_specs`` the same for the parameter tree, a decode
cache and the AdamW state, and ``build_step(cfg, kind)`` the function a
cell runs:

  train    -> the train step (fwd + bwd + AdamW update)
  prefill  -> forward_prefill into a dense cache; encoder archs run the
              plain encode forward (no cache exists)
  decode   -> forward_step (one token against the cache) == serve_step

The reference's ``unroll`` (a JAX scan knob) has no counterpart: the port
loops over layers.  Its ``*_sharding`` arguments are specs here
(``distribution.sharding.P``), re-anchored by redistribution under a mesh
(``distribution.placed.reanchor``); on plain or meta tensors they change
nothing.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import (DecodeCache, DensePrefillDest, cache_spec,
                                forward_prefill, forward_seq, forward_step)
from repro_torch.models import mamba2 as m2
from repro_torch.models.transformer import param_shapes
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import make_train_step

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in: an empty tensor on the meta device."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def param_specs(cfg: ModelConfig):
    """The parameter tree on the meta device (no allocation)."""
    return param_shapes(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> DecodeCache:
    """An empty dense ``DecodeCache`` on the meta device."""
    spec = cache_spec(cfg, batch, max_len)

    def get(name, sub=spec):
        return sds(*sub[name]) if name in sub else None

    ssm = None if "ssm" not in spec else m2.SSMState(
        ssm=get("ssm", spec["ssm"]), conv=get("conv", spec["ssm"]))
    return DecodeCache(k=get("k"), v=get("v"), kv_pos=get("kv_pos"),
                       length=get("length"), ssm=ssm,
                       cross_k=get("cross_k"), cross_v=get("cross_v"))


def opt_specs(cfg: ModelConfig, optimizer):
    """The optimizer state of ``param_specs(cfg)`` on the meta device."""
    return optimizer.init(param_specs(cfg))


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model-input stand-ins for one (arch × shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            specs = {"inputs": sds((B, S, cfg.d_model), torch.float32)}
        else:
            specs = {"inputs": sds((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = sds((B, S), torch.int32)
        if cfg.family == "vlm":
            specs["vision"] = sds((B, cfg.n_vision_tokens, cfg.d_model),
                                  torch.float32)
        return specs
    if shape.kind == "decode":
        return {"token": sds((B,), torch.int32),
                "cache": cache_specs(cfg, B, S)}
    raise ValueError(shape.kind)


def build_step(cfg: ModelConfig, kind: str, *, grad_accum: int = 1,
               remat=True, impl: str = "torch", logits_sharding=None,
               stream_sharding=None, qkv_sharding=None):
    """Returns (fn, arg_names) for one cell's step."""
    if kind == "train":
        opt = make_optimizer("adamw", 3e-4, 100, 10_000)
        step = make_train_step(cfg, opt, grad_accum=grad_accum, remat=remat,
                               impl=impl, logits_sharding=logits_sharding,
                               stream_sharding=stream_sharding,
                               qkv_sharding=qkv_sharding)
        return step, ("params", "opt_state", "batch")
    if kind == "prefill":
        if cfg.is_encoder:
            def encode(params, batch):
                logits, _, _ = forward_seq(params, cfg, batch["inputs"],
                                           impl=impl,
                                           qkv_sharding=qkv_sharding)
                return logits
            return encode, ("params", "batch")

        def prefill(params, batch):
            # dispatches through the models.backends PREFILL registry:
            # merged qp configs run the stream-as-query fast path
            dest = DensePrefillDest(cache_len=batch["inputs"].shape[1])
            return forward_prefill(params, cfg, batch["inputs"], dest,
                                   vision=batch.get("vision"), impl=impl,
                                   qkv_sharding=qkv_sharding)
        return prefill, ("params", "batch")
    if kind == "decode":
        def serve_step(params, token, cache):
            return forward_step(params, cfg, token, cache, impl=impl,
                                qkv_sharding=qkv_sharding)
        return serve_step, ("params", "token", "cache")
    raise ValueError(kind)

"""Seeded weights for a configuration whose ``reference`` is ``qpfree``,
made on the device in the port's parameter-tree layout of the
``residual_qpfree`` block, and the check that the port's config is that
block at the file's widths.

Plain ``torch`` draws from one ``torch.Generator`` on the device, one
call per stacked leaf, in the type they are served in (bfloat16; the
MoE router in float32, as the port keeps it).  Nothing of the port makes
them: the engine and the reference are handed the same tensors.

Scales keep the pre-norm residual stream well scaled at full depth:
projections and FFN inputs ~ N(0, 1/d), FFN outputs ~ N(0, 1/d_ff), the
unembedding ~ N(0, 1/d) (logits of unit scale), norm gains 1 + N(0, 0.1)
so that a norm applied without its gain shows.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def shapes(spec: Dict) -> Dict:
    """The widths a configuration file states, under short names.  A
    number under ``assumed`` is the value run in place of the source's key
    of that name (the RMSNorm epsilon)."""
    d, h = spec["hidden_size"], spec["num_attention_heads"]
    eps = spec.get("assumed", {}).get("rms_norm_eps", spec["rms_norm_eps"])
    return dict(d=d, L=spec["num_hidden_layers"], H=h,
                Hkv=spec["num_key_value_heads"], D=d // h,
                f=spec["intermediate_size"], V=spec["vocab_size"],
                Vp=-(-spec["vocab_size"] // 128) * 128,
                E=spec.get("num_local_experts", 0),
                k=spec.get("num_experts_per_tok", 0),
                W=spec.get("sliding_window") or 0,
                theta=spec["rope_theta"], eps=eps)


def check_port(cfg, spec: Dict) -> None:
    """Raises unless the port's config ``cfg`` is the Q/P-free block at
    the widths and in the type the file states."""
    s = shapes(spec)
    have = dict(d=cfg.d_model, L=cfg.n_layers, H=cfg.n_heads,
                Hkv=cfg.n_kv_heads, D=cfg.d_head, f=cfg.d_ff,
                V=cfg.vocab_size, E=cfg.n_experts, k=cfg.experts_per_token,
                W=cfg.sliding_window, theta=cfg.rope_theta)
    bad = {k: (v, s[k]) for k, v in have.items() if v != s[k]}
    if bad or cfg.block_style != "residual_qpfree" \
            or cfg.dtype != spec["torch_dtype"] \
            or cfg.param_dtype != spec["torch_dtype"]:
        raise ValueError(f"{spec['name']}: the port's config differs from "
                         f"the file: {bad or cfg}")


def make(spec: Dict, seed: int, device) -> Dict:
    s = shapes(spec)
    d, L, f, E = s["d"], s["L"], s["f"], s["E"]
    kvd = s["Hkv"] * s["D"]
    dt = DTYPES[spec["torch_dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)

    def normal(shape, std, dtype=dt):
        x = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return x.mul_(std)

    def gain(shape):
        return normal(shape, 0.1).add_(1.0)

    layers = {"attn": {"wk": normal((L, d, kvd), d ** -0.5),
                       "wv": normal((L, d, kvd), d ** -0.5)},
              "norm1": {"scale": gain((L, d))},
              "norm2": {"scale": gain((L, d))}}
    if E:
        layers["moe"] = {
            "router": normal((L, d, E), d ** -0.5, torch.float32),
            "w_gate": normal((L, E, d, f), d ** -0.5),
            "w_up": normal((L, E, d, f), d ** -0.5),
            "w_down": normal((L, E, f, d), f ** -0.5)}
    else:
        layers["ffn"] = {"w_gate": normal((L, d, f), d ** -0.5),
                         "w_up": normal((L, d, f), d ** -0.5),
                         "w_down": normal((L, f, d), f ** -0.5)}
    return {"embed": {"table": normal((s["Vp"], d), 1.0)},
            "unembed": {"table": normal((s["Vp"], d), 1 / math.sqrt(d))},
            "layers": layers,
            "final_norm": {"scale": gain((d,))}}

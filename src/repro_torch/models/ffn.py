"""Feed-forward networks: SwiGLU / GEGLU / GeLU-MLP.

Counterpart of ``repro.models.ffn``.  The FFN input dimension is a
parameter because under the paper's merged form (Fig 1b) P is folded into
the FFN input matrices, whose input is then the attention concat
(attn_dim) rather than the block stream (d_model).
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu


def init_ffn(gen, d_in: int, d_ff: int, d_out: int, ffn_type: str,
             dtype, init_fn=dense_init, out_gain: float = 1.0):
    if ffn_type in ("swiglu", "geglu"):
        return {
            "w_gate": init_fn(gen, d_in, d_ff, dtype),
            "w_up": init_fn(gen, d_in, d_ff, dtype),
            "w_down": init_fn(gen, d_ff, d_out, dtype, scale=out_gain),
        }
    if ffn_type == "gelu_mlp":
        return {
            "w_in": init_fn(gen, d_in, d_ff, dtype),
            "w_out": init_fn(gen, d_ff, d_out, dtype, scale=out_gain),
        }
    raise ValueError(f"unknown ffn_type {ffn_type!r}")


def ffn_hidden(params, x, ffn_type: str):
    """First half of the FFN: input matmul(s) + nonlinearity -> (…, d_ff)."""
    if ffn_type in ("swiglu", "geglu"):
        act = F.silu if ffn_type == "swiglu" else gelu
        g = x @ params["w_gate"].to(x.dtype)
        u = x @ params["w_up"].to(x.dtype)
        return act(g) * u
    return gelu(x @ params["w_in"].to(x.dtype))


def ffn_out(params, h, ffn_type: str):
    w = params["w_down"] if ffn_type in ("swiglu", "geglu") else params["w_out"]
    return h @ w.to(h.dtype)


def apply_ffn(params, x, ffn_type: str):
    return ffn_out(params, ffn_hidden(params, x, ffn_type), ffn_type)

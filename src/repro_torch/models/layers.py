"""Shared layer primitives: dtypes, inits, norms, RoPE, embeddings.

Counterpart of ``repro.models.layers``: pure functions over nested dicts
of tensors, ``init_x(gen, ...) -> params`` and ``apply_x(params, x, ...)``.
Random inits draw from an explicit ``torch.Generator`` on the device the
parameters are made on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distribution.placed import rows_call, vocab_gather

# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initializers (on the generator's device)
# ---------------------------------------------------------------------------

class MetaGenerator:
    """Stands in for a ``torch.Generator`` where parameters are made on
    the ``meta`` device (shapes and dtypes only, no values): the shape
    helpers of ``launch.steps``."""

    device = torch.device("meta")


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen, fan_in: int, fan_out: int, dtype=torch.float32,
               scale: float = 1.0):
    """Lecun-normal style init, variance 1/fan_in (times scale^2)."""
    std = scale / np.sqrt(fan_in)
    return (_normal(gen, (fan_in, fan_out)) * std).to(dtype)


def orthogonal_init(gen, fan_in: int, fan_out: int, dtype=torch.float32,
                    scale: float = 1.0):
    """(Semi-)orthogonal init: exactly norm-preserving linear maps, so every
    Q/K/V is well-conditioned (cond ≈ 1) and the merged form stays
    numerically clean (the (u·Q)(Q⁻¹K) error scales with cond(Q)·eps)."""
    big = max(fan_in, fan_out)
    a = _normal(gen, (big, min(fan_in, fan_out)))
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]  # fix sign convention
    w = q[:fan_in, :fan_out] if fan_in >= fan_out else q[:fan_out, :fan_in].T
    return (w * scale).to(dtype).contiguous()


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32):
    return (_normal(gen, (vocab, dim)) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def apply_rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(d_rot: int, theta: float) -> np.ndarray:
    """inv_freq for a rotated sub-dimension of size d_rot (must be even)."""
    if d_rot % 2:
        raise ValueError(f"rotated dim must be even, got {d_rot}")
    return 1.0 / (theta ** (np.arange(0, d_rot, 2, dtype=np.float64) / d_rot))


@functools.lru_cache(maxsize=None)
def _inv_freq(d_rot: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` as a float32 tensor on ``device``, copied there
    once: a copy from pageable host memory per call would make the host
    wait for the device's queue (a sync per RoPE call of every step)."""
    return torch.as_tensor(rope_frequencies(d_rot, theta),
                           dtype=torch.float32, device=device)


def rope_cos_sin(positions: torch.Tensor, d_rot: int, theta: float):
    """positions (...,) int -> cos/sin of shape (..., d_rot//2), fp32."""
    inv_freq = _inv_freq(d_rot, float(theta), positions.device)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, style: str = "half",
               theta: float = 10_000.0, fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, n_heads, d_head); positions:
    broadcastable to (..., seq).  "half": llama layout (split-in-half
    pairs); "chatglm2d": interleaved pairs; "none": identity.  Only the
    first ``fraction`` of d_head rotates."""
    if style == "none":
        return x
    d_head = x.shape[-1]
    d_rot = int(d_head * fraction)
    d_rot -= d_rot % 2
    cos, sin = rope_cos_sin(positions, d_rot, theta)
    cos, sin = cos[..., None, :], sin[..., None, :]  # broadcast over heads
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    xr32 = xr.float()
    if style == "half":
        x1, x2 = torch.chunk(xr32, 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    elif style == "chatglm2d":
        x1, x2 = xr32[..., 0::2], xr32[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xr32.shape)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    out = out.to(x.dtype)
    return torch.cat([out, xp], dim=-1) if d_rot < d_head else out


# ---------------------------------------------------------------------------
# activations (jax.nn.gelu is the tanh approximation by default)
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab: int, dim: int, dtype=torch.float32):
    return {"table": embed_init(gen, vocab, dim, dtype)}


def apply_embedding(params, tokens: torch.Tensor,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    # gather, then cast the gathered rows (never a cast copy of the table);
    # a table split over a mesh's vocabulary axis is looked up where its
    # rows lie (``placed.vocab_gather``)
    return vocab_gather(params["table"], tokens).to(compute_dtype)


def apply_unembedding(params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 over the padded vocabulary (callers mask ids >=
    vocab_size).  The product runs in the table's dtype; a float32 table
    gives float32 products, a bfloat16 one is accumulated in float32 by
    the matmul and widened after."""
    t = params["table"]
    return torch.matmul(x.to(t.dtype), t.T).float()


# ---------------------------------------------------------------------------
# hubert-style depthwise conv positional embedding (encoder, rope_style none)
# ---------------------------------------------------------------------------

def init_conv_pos(gen, dim: int, width: int, dtype=torch.float32):
    """Depthwise conv kernel in the reference's layout (width, 1, dim)."""
    std = 1.0 / np.sqrt(width)
    return {"kernel": (_normal(gen, (width, 1, dim)) * std).to(dtype),
            "bias": torch.zeros((dim,), dtype=dtype, device=gen.device)}


def apply_conv_pos(params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> x + gelu(depthwise_conv(x)) (wav2vec2 positional conv),
    in float32.  Cross-correlation (no flip) as in both packages, padded
    (width // 2, width - 1 - width // 2): ``F.conv1d``'s symmetric
    ``padding=`` cannot pad an even width so, hence the explicit pad.  On
    the card the convolution is cuDNN's, which runs float32 in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off.  Under a mesh each rank
    pads and convolves its own batch rows, whole along the sequence
    (``placed.rows_call``): DTensor's planner need not see the pad."""
    return rows_call(_conv_pos, (x,), (params["kernel"], params["bias"]))


def _conv_pos(x, kernel, bias):
    width = kernel.shape[0]
    lo = width // 2
    w = kernel.float().permute(2, 1, 0)  # (D, 1, width)
    xp = F.pad(x.float().transpose(1, 2), (lo, width - 1 - lo))
    y = F.conv1d(xp, w, groups=x.shape[-1]).transpose(1, 2)
    return x + gelu(y + bias.float()).to(x.dtype)

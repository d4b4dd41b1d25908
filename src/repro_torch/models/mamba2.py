"""Mamba2 SSD (state-space duality) mixer: sequence mode, one-token step.

Counterpart of ``repro.models.mamba2``.  The chunked SSD scan runs on two
routes, the ``impl`` axis the attention cores take too:

  * ``impl="torch"`` — the plain chunked scan (``kernels.ref
    .ref_ssd_chunked``, the reference's XLA path), which also continues
    from an initial state;
  * ``impl="cuda"`` — the hand-written kernel through
    ``kernels.ops.ssd_scan`` (from a zero state, as the TPU kernel).

The depthwise causal conv and the decode step have no kernel in the
reference and none here: they are plain PyTorch on every route.

Block layout (mamba_ssm reference):
  in_proj -> [z (d_inner) | xBC (d_inner + 2·G·N) | dt (H)]
  causal depthwise conv over xBC, silu
  SSD(x, dt, A, B, C) + D·x
  gated RMSNorm: norm(y * silu(z))
  out_proj -> d_model
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.placed import (heads_call, local_call,
                                             model_split, on_shards)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_ssd_chunked
from repro_torch.models.layers import (_normal, apply_rmsnorm, dense_init,
                                       init_rmsnorm)


class SSMState(NamedTuple):
    ssm: torch.Tensor  # (B, H, P, N) float32
    conv: torch.Tensor  # (B, W-1, conv_channels) float32


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state


def init_mamba2(gen, cfg: ModelConfig, dtype=torch.float32):
    """One mixer's params from the seeded generator ``gen`` (on its
    device); ``dt_bias`` from numpy's RandomState(0), as the reference
    draws it, so that softplus(dt_bias) spans [1e-3, 1e-1]."""
    d, d_inner = cfg.d_model, cfg.ssm_d_inner
    H, G, N, W = (cfg.ssm_n_heads, cfg.ssm_n_groups, cfg.ssm_state,
                  cfg.ssm_conv_width)
    dev = gen.device
    d_in_proj = 2 * d_inner + 2 * G * N + H
    dt = np.exp(np.random.RandomState(0).uniform(np.log(1e-3), np.log(1e-1),
                                                 H))
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    kern = _normal(gen, (W, conv_channels(cfg)))
    return {
        "in_proj": dense_init(gen, d, d_in_proj, dtype),
        "conv_kernel": (kern / np.sqrt(W)).to(dtype),
        "conv_bias": torch.zeros((conv_channels(cfg),), dtype=dtype,
                                 device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dtype),
        "D": torch.ones((H,), dtype=dtype, device=dev),
        "dt_bias": torch.as_tensor(dt_bias, dtype=dtype, device=dev),
        "norm": init_rmsnorm(d_inner, dtype, dev),
        "out_proj": dense_init(gen, d_inner, d, dtype),
    }


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus, positive
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, H, N) — broadcast G->H
    Cm: torch.Tensor,  # (B, S, H, N)
    *,
    chunk: int,
    D: Optional[torch.Tensor] = None,  # (H,)
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    impl: str = "torch",
):
    """Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) float32).
    ``impl="cuda"`` launches the kernel or raises (a non-zero
    ``init_state`` raises there, as in the reference).  Under a mesh whose
    model axis is larger than 1 it runs on each rank's SSM heads (whole
    heads where the axis does not divide them; B and C come broadcast to
    every head of their group)."""
    S = x.shape[1]
    L = chunk if S % chunk == 0 else S
    if on_shards(impl, x, Bm, Cm):  # under a mesh: on local batch rows
        return local_call(
            lambda x, dt, Bm, Cm, st, A, D: ssd_chunked(
                x, dt, A, Bm, Cm, chunk=chunk, D=D, init_state=st,
                impl=impl),
            (x, dt, Bm, Cm, init_state), (A, D))
    if model_split(impl, x, Bm, Cm):  # the kernel on this rank's heads
        return heads_call(
            lambda x, dt, Bm, Cm, st, A, D: ssd_chunked(
                x, dt, A, Bm, Cm, chunk=chunk, D=D, init_state=st,
                impl=impl),
            [(x, True, 2, False), (dt, True, 2, False), (Bm, True, 2, False),
             (Cm, True, 2, False), (init_state, True, 1, False),
             (A, False, 0, False), (D, False, 0, False)],
            (2, 1), n_heads=x.shape[2])
    if impl == "cuda":
        return kops.ssd_scan(x, dt, A, Bm, Cm, chunk=L, D=D,
                             init_state=init_state)
    if impl != "torch":
        raise ValueError(f"unknown ssd impl {impl!r}; expected 'cuda' or "
                         "'torch'")
    return kops.ssd_apply(ref_ssd_chunked, x, dt, A, Bm, Cm, chunk=L, D=D,
                          init_state=init_state)


def ssd_step(
    x: torch.Tensor,  # (B, H, P)
    dt: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, H, N)
    Cm: torch.Tensor,  # (B, H, N)
    state: torch.Tensor,  # (B, H, P, N) float32
    D: Optional[torch.Tensor] = None,
):
    """Single decode step.  Returns (y (B,H,P), new_state)."""
    dt32 = dt.float()
    decay = torch.exp(dt32 * A)[:, :, None, None]
    dbx = torch.einsum("bh,bhn,bhp->bhpn", dt32, Bm.float(), x.float())
    new_state = state * decay + dbx
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), new_state)
    if D is not None:
        y = y + D[None, :, None] * x.float()
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full mixer (projections + conv + SSD + gate + norm)
# ---------------------------------------------------------------------------

def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner = cfg.ssm_d_inner
    gn = cfg.ssm_n_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, cfg.ssm_n_heads],
                       dim=-1)


def _broadcast_groups(t: torch.Tensor, cfg: ModelConfig):
    """(…, G, N) -> (…, H, N), each group repeated across its heads.  One
    group is broadcast as a view with a zero head stride (the kernel takes
    strides); several are copied, as ``jnp.repeat`` does."""
    H, G = cfg.ssm_n_heads, cfg.ssm_n_groups
    shape = t.shape[:-2] + (G, H // G, t.shape[-1])
    return t.unsqueeze(-2).expand(shape).reshape(*t.shape[:-2], H,
                                                 t.shape[-1])


def _activations(params, cfg: ModelConfig, xbc, dt_raw, lead):
    """Split the conv output into the scan's operands: x (…, H, P), B and
    C (…, H, N), dt = softplus(dt_raw + dt_bias) and A = -exp(A_log), both
    float32.  ``lead`` is the leading shape, (B, S) or (B,)."""
    H, P, N, G = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_n_groups)
    x_ssm, b_in, c_in = torch.split(xbc, [cfg.ssm_d_inner, G * N, G * N],
                                    dim=-1)
    x_h = x_ssm.reshape(*lead, H, P)
    bm = _broadcast_groups(b_in.reshape(*lead, G, N), cfg)
    cm = _broadcast_groups(c_in.reshape(*lead, G, N), cfg)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return x_h, bm, cm, dt, A


def _gate_norm_out(params, cfg: ModelConfig, y, z):
    y = y.reshape(*z.shape[:-1], cfg.ssm_d_inner)
    y = apply_rmsnorm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(y.dtype)


def apply_mamba2_seq(params, x: torch.Tensor, cfg: ModelConfig, *,
                     init_state: Optional[SSMState] = None,
                     return_state: bool = False, impl: str = "torch"):
    """Sequence mode (prefill).  x (B,S,d) -> (B,S,d), and with
    ``return_state`` also the ``SSMState`` after the last position: the
    scan's final state and the conv tail (the last W-1 conv inputs,
    float32)."""
    B, S, _ = x.shape
    W = cfg.ssm_conv_width
    z, xbc, dt_raw = _split_in_proj(cfg, x @ params["in_proj"].to(x.dtype))

    # causal depthwise conv over xBC
    kern = params["conv_kernel"].float()  # (W, C)
    if init_state is not None:
        xbc_in = torch.cat([init_state.conv.to(xbc.dtype), xbc], dim=1)
    else:
        xbc_in = F.pad(xbc, (0, 0, W - 1, 0))
    conv_tail = xbc_in[:, xbc_in.shape[1] - (W - 1):]
    xbc32 = xbc_in.float()
    conv = sum(xbc32[:, i:i + S] * kern[i] for i in range(W))
    xbc = F.silu(conv + params["conv_bias"].float()).to(x.dtype)

    x_h, bm, cm, dt, A = _activations(params, cfg, xbc, dt_raw, (B, S))
    y, fin = ssd_chunked(x_h, dt, A, bm, cm, chunk=cfg.ssm_chunk,
                         D=params["D"].float(),
                         init_state=None if init_state is None
                         else init_state.ssm, impl=impl)
    out = _gate_norm_out(params, cfg, y, z)
    if return_state:
        return out, SSMState(ssm=fin, conv=conv_tail.float())
    return out


def apply_mamba2_step(params, x: torch.Tensor, cfg: ModelConfig,
                      state: SSMState):
    """Decode mode: x (B, d) one token -> ((B, d), new ``SSMState``)."""
    B = x.shape[0]
    z, xbc, dt_raw = _split_in_proj(cfg, x @ params["in_proj"].to(x.dtype))
    window = torch.cat([state.conv, xbc.float()[:, None, :]], dim=1)
    conv = torch.einsum("bwc,wc->bc", window, params["conv_kernel"].float()) \
        + params["conv_bias"].float()
    xbc = F.silu(conv).to(x.dtype)
    x_h, bm, cm, dt, A = _activations(params, cfg, xbc, dt_raw, (B,))
    y, new_ssm = ssd_step(x_h, dt, A, bm, cm, state.ssm,
                          D=params["D"].float())
    return _gate_norm_out(params, cfg, y, z), \
        SSMState(ssm=new_ssm, conv=window[:, 1:])


def init_ssm_state(cfg: ModelConfig, batch: int, device="cpu") -> SSMState:
    return SSMState(
        ssm=torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1,
                          conv_channels(cfg)), dtype=torch.float32,
                         device=device))

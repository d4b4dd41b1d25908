"""Causal / sliding-window GQA flash attention: wrappers of
``csrc/flash_attention.cu``.

Counterparts of ``repro.kernels.flash_attention``'s fp pair:

  * ``flash_attention_bhsd`` — generic: head-major q (B, Hq, Sq, D) and
    k/v (B, Hkv, Sk, D);
  * ``flash_attention_merged_bsd`` — the paper's merged (Q/P-removed)
    prefill fast path: the RoPE'd residual stream viewed (B, Sq, Hq, D) is
    the query, K*/V* tiles are read in their native (B, Sk, Hkv, D) layout
    and the output lands as (B, Sq, Hq, D), a view of the FFN-input stream.

Positions are arange, as in the TPU kernel.  Any Sq / Sk runs: the kernel
masks ragged tails itself.  A tensor on the CPU runs the plain version
(``kernels.ref``); a tensor on a CUDA device launches the kernel (built at
first use) on the current stream, or raises — there is no fallback.
``launches`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_attention, ref_flash_attention_merged

launches = {"flash_attention_bhsd": 0, "flash_attention_merged_bsd": 0}


def _launch(name, q, k, v, *, B, Hq, Hkv, Sq, Sk, q_strides, k_strides,
            causal, sliding_window):
    D = q.shape[-1]
    code = _build.check_operands(name, (q, k, v))
    if Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads over {Hkv} kv heads")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.flash_attention_launch(
        code, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Sk, *q_strides, *k_strides, int(bool(causal)),
        int(sliding_window), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return out


def flash_attention_bhsd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic flash attention -> (B, Hq, Sq, D)."""
    name = "flash_attention_bhsd"
    if not _build.on_cuda(name, q, k, v):
        return ref_attention(q, k, v, causal=causal,
                             sliding_window=sliding_window)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Sk, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Hkv, Sk, D), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _launch(name, q, k, v, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
                   q_strides=(Hq * Sq * D, D, Sq * D),
                   k_strides=(Hkv * Sk * D, D, Sk * D),
                   causal=causal, sliding_window=sliding_window)


def flash_attention_merged_bsd(
    u: torch.Tensor,  # (B, Sq, Hq, D) — RoPE'd stream viewed as heads
    k: torch.Tensor,  # (B, Sk, Hkv, D) — K*, native layout
    v: torch.Tensor,  # (B, Sk, Hkv, D) — V*
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged flash prefill (stream-as-query) -> (B, Sq, Hq, D)."""
    name = "flash_attention_merged_bsd"
    if not _build.on_cuda(name, u, k, v):
        return ref_flash_attention_merged(u, k, v, causal=causal,
                                          sliding_window=sliding_window)
    B, Sq, Hq, D = u.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Sk, Hkv, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Sk, Hkv, D), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _launch(name, u, k, v, B=B, Hq=Hq, Hkv=Hkv, Sq=Sq, Sk=Sk,
                   q_strides=(Sq * Hq * D, Hq * D, D),
                   k_strides=(Sk * Hkv * D, Hkv * D, D),
                   causal=causal, sliding_window=sliding_window)

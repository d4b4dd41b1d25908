"""One-token GQA decode attention: wrappers of ``csrc/decode_attention.cu``.

Counterparts of ``repro.kernels.decode_attention``'s dense pair:

  * ``decode_attention_bhsd`` — generic: a separately-projected grouped
    query (B, Hkv, G, D) against a head-major (B, Hkv, S, D) cache;
  * ``decode_attention_merged_bsd`` — the paper's merged (Q/P-removed)
    fast path: the RoPE'd residual stream viewed (B, Hq, D) is the query,
    K*/V* are read in the serving cache's native (B, S, Hkv, D) layout and
    the output lands as (B, Hq, D), a view of the FFN-input stream.

A tensor on the CPU runs the plain version (``kernels.ref``); a tensor on
a CUDA device launches the kernel (built at first use) on the current
stream, or raises — there is no fallback.  ``launches`` counts kernel
launches per wrapper.  See the CUDA source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ref_decode_attention,
                                     ref_decode_attention_merged)

launches = {"decode_attention_bhsd": 0, "decode_attention_merged_bsd": 0}

MAX_G = 8  # query heads per kv head the kernel takes
_TILE = 64  # keys per tile in the kernel
_TARGET_BLOCKS = 2 * 132  # two blocks per H100 SM


def kv_split(B: int, Hkv: int, S: int):
    """(n_split, chunk): the kv axis is cut into ``n_split`` ranges of
    ``chunk`` whole tiles so that about ``_TARGET_BLOCKS`` blocks run."""
    want = max(1, -(-_TARGET_BLOCKS // max(B * Hkv, 1)))
    chunk = -(-max(S, 1) // want)
    chunk = -(-chunk // _TILE) * _TILE
    return -(-max(S, 1) // chunk), chunk


def _launch(name, q, k, v, kv_positions, q_position, *, q_strides,
            k_strides, Hkv, G, S, sliding_window):
    B, D = q.shape[0], q.shape[-1]
    code = _build.check_operands(name, (q, k, v), (kv_positions, q_position))
    if not 1 <= G <= MAX_G:
        raise ValueError(f"{name}: {G} query heads per kv head; the kernel "
                         f"takes 1..{MAX_G}")
    if tuple(kv_positions.shape) != (B, S) or \
            tuple(q_position.shape) != (B,):
        raise ValueError(f"{name}: positions must be (B, S) and (B,), got "
                         f"{tuple(kv_positions.shape)}, "
                         f"{tuple(q_position.shape)}")
    n_split, chunk = kv_split(B, Hkv, S)
    out = torch.empty_like(q)
    ws_acc = torch.empty((B, Hkv, n_split, G, D), dtype=torch.float32,
                         device=q.device)
    ws_ml = torch.empty((B, Hkv, n_split, G, 2), dtype=torch.float32,
                        device=q.device)
    lib = _build.library("decode_attention")
    err = lib.decode_attention_launch(
        code, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_positions.data_ptr(), q_position.data_ptr(), out.data_ptr(),
        ws_acc.data_ptr(), ws_ml.data_ptr(), B, Hkv, G, S, *q_strides,
        *k_strides, int(sliding_window), n_split, chunk,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return out


def decode_attention_bhsd(
    q: torch.Tensor,  # (B, Hkv, G, D) — grouped query heads
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    kv_positions: torch.Tensor,  # (B, S) int32; -1 marks empty slots
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic decode attention -> (B, Hkv, G, D)."""
    name = "decode_attention_bhsd"
    if not _build.on_cuda(name, q, k, v, kv_positions, q_position):
        return ref_decode_attention(q, k, v, kv_positions, q_position,
                                    sliding_window=sliding_window)
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, Hkv, S, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Hkv, S, D) = "
                         f"{(B, Hkv, S, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _launch(name, q, k, v, kv_positions, q_position,
                   q_strides=(Hkv * G * D, G * D),
                   k_strides=(Hkv * S * D, S * D, D),
                   Hkv=Hkv, G=G, S=S, sliding_window=sliding_window)


def decode_attention_merged_bsd(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd residual stream viewed as heads
    k: torch.Tensor,  # (B, S, Hkv, D) — K* cache, native serving layout
    v: torch.Tensor,  # (B, S, Hkv, D) — V* cache
    kv_positions: torch.Tensor,  # (B, S) int32; -1 marks empty slots
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged decode attention (stream-as-query) -> (B, Hq, D)."""
    name = "decode_attention_merged_bsd"
    if not _build.on_cuda(name, u, k, v, kv_positions, q_position):
        return ref_decode_attention_merged(u, k, v, kv_positions, q_position,
                                           sliding_window=sliding_window)
    B, Hq, D = u.shape
    S, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, Hkv, D) or k.shape != v.shape \
            or Hq % Hkv:
        raise ValueError(f"{name}: k/v must be (B, S, Hkv, D) with Hkv | "
                         f"{Hq}, got {tuple(k.shape)}, {tuple(v.shape)}")
    G = Hq // Hkv
    return _launch(name, u, k, v, kv_positions, q_position,
                   q_strides=(Hq * D, G * D),
                   k_strides=(S * Hkv * D, D, Hkv * D),
                   Hkv=Hkv, G=G, S=S, sliding_window=sliding_window)

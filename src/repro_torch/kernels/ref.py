"""Plain PyTorch versions of the four dense attention kernels.

Each function is the transparent O(S²) form of what its CUDA kernel
computes, in float32, returned in the input dtype.  The kernel wrappers
(``flash_attention``, ``decode_attention``) run these for tensors that lie
on the CPU; on the card ``chip_smoke.py`` and the GPU tests hold each
kernel against them on the same inputs.  Counterparts of
``repro.kernels.ref`` (same names, same masking semantics): masked scores
go to ``NEG`` before the softmax and their probabilities are then zeroed,
so a row with nothing to attend to is exactly zero.
"""
from __future__ import annotations

import torch

NEG = -1e30


def ref_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Causal/windowed GQA attention over arange positions (flash)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float() / (D ** 0.5)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if sliding_window > 0:
        mask &= rows - cols < sliding_window
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask, p, 0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def ref_flash_attention_merged(
    u: torch.Tensor,  # (B, Sq, Hq, D) — RoPE'd stream viewed as heads
    k: torch.Tensor,  # (B, Sk, Hkv, D) — native (sequence-major) layout
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged flash prefill: the stream is the query, K*/V* native; the
    output comes back as (B, Sq, Hq, D), the FFN-input stream's view."""
    o = ref_attention(u.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, sliding_window=sliding_window)
    return o.transpose(1, 2)


def ref_decode_attention(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
) -> torch.Tensor:
    """One-token GQA decode against position-tagged cache slots."""
    D = q.shape[-1]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) / (D ** 0.5)
    qpos = q_position.reshape(-1)[:, None]
    ok = (kv_positions >= 0) & (kv_positions <= qpos)
    if sliding_window > 0:
        ok &= qpos - kv_positions < sliding_window
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    p = torch.where(ok, p, 0.0)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return o.to(q.dtype)


def ref_decode_attention_merged(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd stream viewed as heads
    k: torch.Tensor,  # (B, S, Hkv, D) — native serving cache layout
    v: torch.Tensor,  # (B, S, Hkv, D)
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged decode: stream-as-query over the native cache, output as
    (B, Hq, D) in the FFN-input basis."""
    B, Hq, D = u.shape
    Hkv = k.shape[2]
    o = ref_decode_attention(
        u.reshape(B, Hkv, Hq // Hkv, D), k.transpose(1, 2), v.transpose(1, 2),
        kv_positions, q_position, sliding_window=sliding_window)
    return o.reshape(B, Hq, D)

"""Attention cores: GQA, causal & sliding-window, prefill & decode.

Counterpart of ``repro.models.attention``'s dense cores.  Projections live
in ``models.transformer`` (the paper's merged form changes which exist);
this module computes attention on projected, RoPE'd q/k/v.

Two implementations, the ``impl`` axis of the backend registries:
  * ``impl="torch"`` — plain PyTorch math (the port of the reference's XLA
    cores, query-chunked so the score buffer is O(chunk × Sk));
  * ``impl="cuda"`` — the hand-written kernels, fetched from
    ``kernels.ops.ATTENTION_KERNELS`` keyed (phase, cache_kind, style).

GQA is computed grouped (q reshaped to (…, n_kv, group, d)): KV heads are
never materialized repeated.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
IMPLS = ("cuda", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{IMPLS}")


def _mask_bias(
    q_pos: torch.Tensor,  # (B, Sq) int
    kv_pos: torch.Tensor,  # (B, Sk) int
    *,
    causal: bool,
    sliding_window: int,
    kv_valid: Optional[torch.Tensor],  # (B, Sk) bool
) -> torch.Tensor:
    """Additive bias (B, 1, Sq, Sk) fp32: 0 where attendable, NEG_INF else."""
    ok = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kv_pos[:, None, :] <= q_pos[:, :, None]
    if sliding_window > 0:
        ok &= q_pos[:, :, None] - kv_pos[:, None, :] < sliding_window
    if kv_valid is not None:
        ok &= kv_valid[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)[:, None, :, :]


def _attend_block(q, k, v, bias, scale):
    """q (B,Sq,Hkv,G,D) k/v (B,Sk,Hkv,D) bias (B,1,Sq,Sk) -> (B,Sq,Hkv,G,D)."""
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = scores * scale + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)


def attention_core(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    q_positions: torch.Tensor,  # (B, Sq) int
    kv_positions: torch.Tensor,  # (B, Sk) int
    causal: bool = True,
    sliding_window: int = 0,
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool (padded caches)
    query_chunk: int = 1024,
    impl: str = "torch",
) -> torch.Tensor:
    """Exact softmax attention; returns (B, Sq, Hq, D) in v.dtype."""
    _check_impl(impl)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads")
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)

    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.attention_kernel("prefill", "dense", "generic")(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, sliding_window=sliding_window, kv_valid=kv_valid)

    qg = q.reshape(B, Sq, Hkv, G, D)
    if Sq <= query_chunk or Sq % query_chunk != 0:
        bias = _mask_bias(q_positions, kv_positions, causal=causal,
                          sliding_window=sliding_window, kv_valid=kv_valid)
        return _attend_block(qg, k, v, bias, scale).reshape(B, Sq, Hq, D)

    # chunked over query blocks: the score buffer is (B, chunk, …)
    outs = []
    for c0 in range(0, Sq, query_chunk):
        sl = slice(c0, c0 + query_chunk)
        bias = _mask_bias(q_positions[:, sl], kv_positions, causal=causal,
                          sliding_window=sliding_window, kv_valid=kv_valid)
        outs.append(_attend_block(qg[:, sl], k, v, bias, scale))
    return torch.cat(outs, dim=1).reshape(B, Sq, Hq, D)


def attention_core_merged(
    u: torch.Tensor,  # (B, Sq, d_model) — RoPE'd stream (merged query)
    k: torch.Tensor,  # (B, Sk, Hkv, D) — K*, native layout
    v: torch.Tensor,  # (B, Sk, Hkv, D) — V*
    *,
    q_positions: torch.Tensor,  # (B, Sq) int
    kv_positions: torch.Tensor,  # (B, Sk) int
    n_kv_heads: int,
    causal: bool = True,
    sliding_window: int = 0,
    query_chunk: int = 1024,
    impl: str = "torch",
    cache_kind: str = "dense",
) -> torch.Tensor:
    """Merged (Q/P-removed, paper Fig 1b) full-sequence attention, the
    prefill sibling of ``decode_attention_core_merged``: the stream is the
    query (the grouped-head view is free) and the (B, Sq, d_model) result
    is the FFN-input stream.  Numerics equal ``attention_core`` on the
    head view."""
    _check_impl(impl)
    B, Sq, d = u.shape
    D = k.shape[3]
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.attention_kernel("prefill", cache_kind, "merged")(
            u, k, v, n_kv_heads=n_kv_heads, q_positions=q_positions,
            kv_positions=kv_positions, causal=causal,
            sliding_window=sliding_window)
    out = attention_core(
        u.reshape(B, Sq, d // D, D), k, v, q_positions=q_positions,
        kv_positions=kv_positions, causal=causal,
        sliding_window=sliding_window, query_chunk=query_chunk, impl=impl)
    return out.reshape(B, Sq, d)


def decode_attention_core_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream (merged query)
    k_cache: torch.Tensor,  # (B, S, Hkv, D) — K*, native serving layout
    v_cache: torch.Tensor,  # (B, S, Hkv, D) — V*
    *,
    kv_positions: torch.Tensor,  # (B, S) int; -1 marks empty slots
    q_position: torch.Tensor,  # (B,) int
    n_kv_heads: int,
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    """Merged (Q/P-removed) decode attention: the stream is the query, no q
    projection, and the (B, d_model) result is the FFN input.  Numerics
    equal ``decode_attention_core_positions`` on the head view."""
    _check_impl(impl)
    B, d = u.shape
    D = k_cache.shape[3]
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("dense", "merged")(
            u, k_cache, v_cache, kv_positions=kv_positions,
            q_position=q_position, n_kv_heads=n_kv_heads,
            sliding_window=sliding_window)
    out = decode_attention_core_positions(
        u.reshape(B, d // D, D), k_cache, v_cache, kv_positions=kv_positions,
        q_position=q_position, sliding_window=sliding_window, impl=impl)
    return out.reshape(B, d)


def decode_attention_core_positions(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    *,
    kv_positions: torch.Tensor,  # (B, S) int; -1 marks empty slots
    q_position: torch.Tensor,  # (B,) int
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    _check_impl(impl)
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("dense", "generic")(
            q, k_cache, v_cache, kv_positions=kv_positions,
            q_position=q_position, sliding_window=sliding_window)

    qg = q.reshape(B, Hkv, G, D)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                          k_cache.float()) * scale
    ok = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if sliding_window > 0:
        ok &= q_position[:, None] - kv_positions < sliding_window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(ok, zero, NEG_INF)  # (B, S)
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(B, Hq, D)

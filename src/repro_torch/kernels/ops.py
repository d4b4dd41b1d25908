"""Wrappers exposing the kernels in model-layer layouts, and the table of
which (phase, cache_kind, style) has a kernel.

Counterparts of ``repro.kernels.ops``' dense rows.  The generic wrappers
keep the reference's head-major transposes (``.contiguous()`` copies of
q/k/v, and of the whole cache at decode): they are part of what the
merged layout removes, so the generic/merged comparison measures it.  The
merged wrappers hand the stream and the native cache to the kernel as
views.  Unlike the TPU wrappers there is no block-size search: the CUDA
kernels mask ragged tails, so any prompt length runs at full tile size.

The serving path picks the plain PyTorch route by ``impl="torch"`` in the
attention cores (``models/attention.py``), never through these wrappers.
The kernel wrappers still take CPU tensors, running the plain version
(``kernels.ref``) on them, for one caller: the CPU tests
(``tests/test_torch_kernels_ref.py``), which hold each wrapper's layout
plumbing (the transposes and reshapes here) against the JAX package's
kernels where no card is present.  On a CUDA tensor a wrapper launches its
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import (decode_attention_bhsd,
                                                  decode_attention_merged_bsd)
from repro_torch.kernels.flash_attention import (flash_attention_bhsd,
                                                 flash_attention_merged_bsd)


def _no_kv_valid(kv_valid) -> None:
    if kv_valid is not None:
        raise ValueError("flash kernel: use the decode kernel for padded "
                         "caches (kv_valid is not supported)")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    q_positions=None,  # accepted for API parity; the kernel assumes arange
    kv_positions=None,
    causal: bool = True,
    sliding_window: int = 0,
    kv_valid=None,
) -> torch.Tensor:
    _no_kv_valid(kv_valid)
    out = flash_attention_bhsd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal=causal,
        sliding_window=sliding_window)
    return out.transpose(1, 2)  # back to (B, Sq, Hq, D)


def flash_attention_merged(
    u: torch.Tensor,  # (B, Sq, d_model) — RoPE'd stream = merged query
    k: torch.Tensor,  # (B, Sk, Hkv, D) — K*, native layout
    v: torch.Tensor,  # (B, Sk, Hkv, D) — V*
    *,
    n_kv_heads: int,
    q_positions=None,  # accepted for API parity; the kernel assumes arange
    kv_positions=None,
    causal: bool = True,
    sliding_window: int = 0,
    kv_valid=None,
) -> torch.Tensor:
    """Merged (Q/P-removed) flash prefill -> (B, Sq, d_model) FFN-input
    stream; the (B, Sq, Hq, D) view of the stream is free."""
    _no_kv_valid(kv_valid)
    B, Sq, d = u.shape
    Hkv, D = k.shape[2], k.shape[3]
    if Hkv != n_kv_heads or d % D or (d // D) % Hkv:
        raise ValueError(f"flash_attention_merged: d_model {d}, kv heads "
                         f"{Hkv} (expected {n_kv_heads}), head dim {D}")
    out = flash_attention_merged_bsd(
        u.reshape(B, Sq, d // D, D), k.contiguous(), v.contiguous(),
        causal=causal, sliding_window=sliding_window)
    return out.reshape(B, Sq, d)


def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    *,
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    sliding_window: int = 0,
) -> torch.Tensor:
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    out = decode_attention_bhsd(
        q.reshape(B, Hkv, Hq // Hkv, D).contiguous(),
        k_cache.transpose(1, 2).contiguous(),
        v_cache.transpose(1, 2).contiguous(),
        kv_positions.to(torch.int32).contiguous(),
        q_position.to(torch.int32).contiguous(),
        sliding_window=sliding_window)
    return out.reshape(B, Hq, D)


def decode_attention_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream = merged query
    k_cache: torch.Tensor,  # (B, S, Hkv, D) — K*, native serving layout
    v_cache: torch.Tensor,  # (B, S, Hkv, D) — V*
    *,
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    n_kv_heads: int,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged (Q/P-removed) decode -> (B, d_model) FFN-input stream; the
    (B, Hq, D) view of the stream is free and the cache is read as is."""
    B, d = u.shape
    Hkv, D = k_cache.shape[2], k_cache.shape[3]
    if Hkv != n_kv_heads or d % D or (d // D) % Hkv:
        raise ValueError(f"decode_attention_merged: d_model {d}, kv heads "
                         f"{Hkv} (expected {n_kv_heads}), head dim {D}")
    out = decode_attention_merged_bsd(
        u.reshape(B, d // D, D).contiguous(), k_cache.contiguous(),
        v_cache.contiguous(), kv_positions.to(torch.int32).contiguous(),
        q_position.to(torch.int32).contiguous(),
        sliding_window=sliding_window)
    return out.reshape(B, d)


# ---------------------------------------------------------------------------
# attention-kernel table: the kernel-layer face of the serving registries
# ---------------------------------------------------------------------------

# keyed (phase, cache_kind, style) like models.backends plus the phase axis,
# minus the impl axis (every wrapper here IS the "cuda" route; on CPU
# tensors it runs the plain version).  Paged and int8 caches are later
# slices of the port.
ATTENTION_KERNELS = {
    ("decode", "dense", "generic"): decode_attention,
    ("decode", "dense", "merged"): decode_attention_merged,
    ("prefill", "dense", "generic"): flash_attention,
    ("prefill", "dense", "merged"): flash_attention_merged,
}


def attention_kernel(phase: str, cache_kind: str, style: str):
    """Kernel wrapper for one (phase, cache_kind, style) combo; unknown
    combos raise KeyError naming the registered ones."""
    try:
        return ATTENTION_KERNELS[(phase, cache_kind, style)]
    except KeyError:
        raise KeyError(
            f"no attention kernel for (phase={phase!r}, cache_kind="
            f"{cache_kind!r}, style={style!r}); available: "
            f"{sorted(ATTENTION_KERNELS)}") from None


# the decode view of the unified table
DECODE_KERNELS = {(ck, st): fn for (ph, ck, st), fn in ATTENTION_KERNELS.items()
                  if ph == "decode"}


def decode_kernel(cache_kind: str, style: str):
    """Decode kernel wrapper for one (cache_kind, style) combo; unknown
    combos raise KeyError naming the registered ones."""
    try:
        return DECODE_KERNELS[(cache_kind, style)]
    except KeyError:
        raise KeyError(
            f"no decode kernel for (cache_kind={cache_kind!r}, style="
            f"{style!r}); available: {sorted(DECODE_KERNELS)}") from None

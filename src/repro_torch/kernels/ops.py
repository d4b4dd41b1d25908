"""Wrappers exposing the kernels in model-layer layouts, and the table of
which (phase, cache_kind, style) has a kernel.

Counterparts of ``repro.kernels.ops``' dense, paged and paged_q8 rows and
of its SSD scan (``ssd_scan``).
The generic flash wrapper hands the sequence-major q/k/v to the
``flash_attention_bhsd`` kernel with their own strides
(``flash_attention_bshd``: no copies); the generic dense decode wrapper
keeps the reference's head-major transposes (``.contiguous()`` copies of
q and of the whole cache), part of what the merged layout removes.  A
VLM's cross K/V, written once by the prefill and read every step, go to
the same decode kernel in place (``decode_attention_native``).  The
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
kernel or raises.  Each kernel is one operator of the ``repro_torch``
namespace (``_build.define_op``), whose dispatcher makes that choice by
device; the plumbing here stays ordinary aten ops around it, so a traced
program shows it, and the kernel call as one node.

The paged wrappers hand the pools (NB, bs, Hkv, D) and the block table to
the kernel as they are (generic and merged alike: the pool is never
transposed) and derive ring addressing from the window and the table
width (``kernels.paging``), so callers never pass a ring flag.  The q8
wrappers take the int8 pools (or the int8 prompt K*/V*) with their float32
scales as keywords, as the reference does.

Each decode wrapper but the native one has a partial-state twin
(``*_states``: the same operands and the same plumbing helper): it
returns the float32 softmax state (m, l, o) of the keys or pages it is
given, m and l (B, Hq), o (B, Hq, D), from the decode kernel's
partial-state mode.  A rank of a mesh whose model axis
splits the cache's sequence (or the pool's pages) calls it on its slice
(a paged table whose other ranks' pages are -1, ``placed.own_pages``,
keeping the global width) and the states are combined across the axis
(``placed.combine_softmax``).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (
    decode_attention_bhsd, decode_attention_bshd, decode_attention_merged_bsd,
    decode_attention_paged_bhsd, decode_attention_paged_merged_bsd,
    decode_attention_paged_q8_bhsd, decode_attention_paged_q8_merged_bsd,
    decode_states)
from repro_torch.kernels.flash_attention import (
    flash_attention_bshd, flash_attention_merged_bsd,
    flash_attention_merged_q8_bsd)
from repro_torch.kernels.paging import paged_ring_active
from repro_torch.kernels.ssd_scan import ssd_chunk_scan


def _plain_only(fn):
    """A wrapper given a DTensor raises TypeError before any reshape
    (``_build.refuse_placed``)."""
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        _build.refuse_placed(fn.__name__, *args, *kw.values())
        return fn(*args, **kw)
    return wrapper


def _no_kv_valid(kv_valid) -> None:
    if kv_valid is not None:
        raise ValueError("flash kernel: use the decode kernel for padded "
                         "caches (kv_valid is not supported)")


def _merged_heads(name, d, Hkv, D, n_kv_heads):
    if Hkv != n_kv_heads or d % D or (d // D) % Hkv:
        raise ValueError(f"{name}: d_model {d}, kv heads {Hkv} (expected "
                         f"{n_kv_heads}), head dim {D}")


@_plain_only
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
    return flash_attention_bshd(q, k, v, causal=causal,
                                sliding_window=sliding_window)


@_plain_only
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
    _merged_heads("flash_attention_merged", d, Hkv, D, n_kv_heads)
    out = flash_attention_merged_bsd(
        u.reshape(B, Sq, d // D, D), k.contiguous(), v.contiguous(),
        causal=causal, sliding_window=sliding_window)
    return out.reshape(B, Sq, d)


# ---------------------------------------------------------------------------
# decode wrappers and their partial-state twins
# ---------------------------------------------------------------------------
#
# One plumbing helper per layout (dense, merged, paged) hands a wrapper's
# operands to ``run``: the kernel's entry point (the whole wrapper) or
# ``_twin(name)``, its partial-state mode (the twin), which returns the
# float32 state (m, l, o) of the keys or pages it is given in place of
# the normalised output.

def _twin(name):
    """``run`` for a partial-state twin: ``decode_states`` of the entry
    point ``name``."""
    return functools.partial(decode_states, name)


def _name(run) -> str:
    return getattr(run, "__name__", None) or run.args[0]


def _heads(states, B, Hq, D):
    m, l, o = states
    return m.reshape(B, Hq), l.reshape(B, Hq), o.reshape(B, Hq, D)


def _dense(run, q, k_cache, v_cache, kv_positions, q_position,
           sliding_window):
    """The generic dense decode's plumbing: the grouped query and the
    reference's head-major copies of the cache."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    return run(q.reshape(B, Hkv, Hq // Hkv, D).contiguous(),
               k_cache.transpose(1, 2).contiguous(),
               v_cache.transpose(1, 2).contiguous(),
               kv_positions.to(torch.int32).contiguous(),
               q_position.to(torch.int32).contiguous(),
               sliding_window=sliding_window)


def _merged(run, u, k_cache, v_cache, kv_positions, q_position, n_kv_heads,
            sliding_window):
    """The merged dense decode's plumbing: the stream viewed (B, Hq, D),
    the native cache as is."""
    B, d = u.shape
    Hkv, D = k_cache.shape[2], k_cache.shape[3]
    _merged_heads(_name(run), d, Hkv, D, n_kv_heads)
    return run(u.reshape(B, d // D, D).contiguous(), k_cache.contiguous(),
               v_cache.contiguous(), kv_positions.to(torch.int32).contiguous(),
               q_position.to(torch.int32).contiguous(),
               sliding_window=sliding_window)


def _paged(run, q, pools, block_tables, q_position, sliding_window,
           n_kv_heads=None):
    """The paged decodes' plumbing: ``pools`` (k, v) or (k, v, k_scale,
    v_scale); ``n_kv_heads`` given, ``q`` is the merged stream (B,
    d_model) viewed (B, Hq, D), else the grouped query; ring addressing
    from the window and the table width."""
    B = q.shape[0]
    Hkv, D = pools[0].shape[2], pools[0].shape[3]
    if n_kv_heads is None:
        query = q.reshape(B, Hkv, q.shape[1] // Hkv, D)
    else:
        _merged_heads(_name(run), q.shape[1], Hkv, D, n_kv_heads)
        query = q.reshape(B, q.shape[1] // D, D)
    ring = paged_ring_active(sliding_window, pools[0].shape[1],
                             block_tables.shape[1])
    return run(query.contiguous(), *[p.contiguous() for p in pools[:2]],
               *[s.float().contiguous() for s in pools[2:]],
               block_tables.to(torch.int32).contiguous(),
               q_position.to(torch.int32).contiguous(),
               sliding_window=sliding_window, ring_blocks=ring)


@_plain_only
def decode_attention(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    *,
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    sliding_window: int = 0,
) -> torch.Tensor:
    return _dense(decode_attention_bhsd, q, k_cache, v_cache, kv_positions,
                  q_position, sliding_window).reshape(q.shape)


@_plain_only
def decode_attention_states(q, k_cache, v_cache, *, kv_positions,
                            q_position, sliding_window: int = 0):
    """``decode_attention``'s state over a slice of the cache: q (B, Hq,
    D), k/v (B, S, Hkv, D) with their positions (B, S)."""
    return _heads(_dense(_twin("decode_attention_bhsd"), q, k_cache,
                         v_cache, kv_positions, q_position, sliding_window),
                  *q.shape)


@_plain_only
def decode_attention_native(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D), read in place
    v_cache: torch.Tensor,  # (B, S, Hkv, D)
    *,
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    sliding_window: int = 0,
) -> torch.Tensor:
    """``decode_attention`` without the head-major copies: the kernel reads
    the contiguous (B, S, Hkv, D) cache on its own strides."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    out = decode_attention_bshd(
        q.reshape(B, Hkv, Hq // Hkv, D).contiguous(), k_cache, v_cache,
        kv_positions.to(torch.int32).contiguous(),
        q_position.to(torch.int32).contiguous(),
        sliding_window=sliding_window)
    return out.reshape(B, Hq, D)


@_plain_only
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
    return _merged(decode_attention_merged_bsd, u, k_cache, v_cache,
                   kv_positions, q_position, n_kv_heads,
                   sliding_window).reshape(u.shape)


@_plain_only
def decode_attention_merged_states(u, k_cache, v_cache, *, kv_positions,
                                   q_position, n_kv_heads: int,
                                   sliding_window: int = 0):
    """``decode_attention_merged``'s state: u (B, d_model), the native
    cache slice."""
    return _merged(_twin("decode_attention_merged_bsd"), u, k_cache, v_cache,
                   kv_positions, q_position, n_kv_heads, sliding_window)


@_plain_only
def decode_attention_paged(
    q: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — physical page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic decode attention over a paged KV pool -> (B, Hq, D)."""
    return _paged(decode_attention_paged_bhsd, q, (k_pool, v_pool),
                  block_tables, q_position, sliding_window).reshape(q.shape)


@_plain_only
def decode_attention_paged_states(q, k_pool, v_pool, *, block_tables,
                                  q_position, sliding_window: int = 0):
    """``decode_attention_paged``'s state over the pages the table maps."""
    return _heads(_paged(_twin("decode_attention_paged_bhsd"), q,
                         (k_pool, v_pool), block_tables, q_position,
                         sliding_window), *q.shape)


@_plain_only
def decode_attention_paged_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream = merged query
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — K* page pool, native layout
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) — V* page pool
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    n_kv_heads: int,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged (Q/P-removed) decode over a paged KV pool -> (B, d_model)
    FFN-input stream."""
    return _paged(decode_attention_paged_merged_bsd, u, (k_pool, v_pool),
                  block_tables, q_position, sliding_window,
                  n_kv_heads).reshape(u.shape)


@_plain_only
def decode_attention_paged_merged_states(u, k_pool, v_pool, *, block_tables,
                                         q_position, n_kv_heads: int,
                                         sliding_window: int = 0):
    """``decode_attention_paged_merged``'s state: u (B, d_model)."""
    return _paged(_twin("decode_attention_paged_merged_bsd"), u,
                  (k_pool, v_pool), block_tables, q_position, sliding_window,
                  n_kv_heads)


# ---------------------------------------------------------------------------
# int8 (paged_q8) wrappers: int8 pools + per-(page, head) float32 scales
# ---------------------------------------------------------------------------

@_plain_only
def decode_attention_paged_q8(
    q: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8
    *,
    k_scale: torch.Tensor,  # (NB, Hkv) float32
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic decode attention over an int8 paged pool -> (B, Hq, D): the
    table gather and ring rule of ``decode_attention_paged``, each page
    dequantized in the kernel from its (page, head) scale."""
    return _paged(decode_attention_paged_q8_bhsd, q,
                  (k_pool, v_pool, k_scale, v_scale), block_tables,
                  q_position, sliding_window).reshape(q.shape)


@_plain_only
def decode_attention_paged_q8_states(q, k_pool, v_pool, *, k_scale, v_scale,
                                     block_tables, q_position,
                                     sliding_window: int = 0):
    """``decode_attention_paged_q8``'s state over the int8 pages mapped."""
    return _heads(_paged(_twin("decode_attention_paged_q8_bhsd"), q,
                         (k_pool, v_pool, k_scale, v_scale), block_tables,
                         q_position, sliding_window), *q.shape)


@_plain_only
def decode_attention_paged_q8_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream = merged query
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 K* page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 V* page pool
    *,
    k_scale: torch.Tensor,  # (NB, Hkv) float32
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    n_kv_heads: int,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged (Q/P-removed) decode over an int8 paged pool -> (B, d_model)
    FFN-input stream: one byte per attended pooled element."""
    return _paged(decode_attention_paged_q8_merged_bsd, u,
                  (k_pool, v_pool, k_scale, v_scale), block_tables,
                  q_position, sliding_window, n_kv_heads).reshape(u.shape)


@_plain_only
def decode_attention_paged_q8_merged_states(u, k_pool, v_pool, *, k_scale,
                                            v_scale, block_tables,
                                            q_position, n_kv_heads: int,
                                            sliding_window: int = 0):
    """``decode_attention_paged_q8_merged``'s state: u (B, d_model)."""
    return _paged(_twin("decode_attention_paged_q8_merged_bsd"), u,
                  (k_pool, v_pool, k_scale, v_scale), block_tables,
                  q_position, sliding_window, n_kv_heads)


@_plain_only
def flash_attention_merged_q8(
    u: torch.Tensor,  # (B, Sq, d_model) — RoPE'd stream = merged query
    k: torch.Tensor,  # (B, Sk, Hkv, D) int8 — K* at pool quantization
    v: torch.Tensor,  # (B, Sk, Hkv, D) int8 — V*
    *,
    k_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32
    v_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32
    n_kv_heads: int,
    q_positions=None,  # accepted for API parity; the kernel assumes arange
    kv_positions=None,
    causal: bool = True,
    sliding_window: int = 0,
    kv_valid=None,
) -> torch.Tensor:
    """Merged (Q/P-removed) flash prefill over int8 K*/V* -> (B, Sq,
    d_model) FFN-input stream; each tile is dequantized in the kernel (no
    float K*/V* buffer exists).  Unlike the TPU tile, the CUDA tile need
    not be a whole number of pages: each key row finds its own page's
    scale."""
    _no_kv_valid(kv_valid)
    B, Sq, d = u.shape
    Hkv, D = k.shape[2], k.shape[3]
    _merged_heads("flash_attention_merged_q8", d, Hkv, D, n_kv_heads)
    out = flash_attention_merged_q8_bsd(
        u.reshape(B, Sq, d // D, D), k.contiguous(), v.contiguous(),
        k_scale.float().contiguous(), v_scale.float().contiguous(),
        causal=causal, sliding_window=sliding_window)
    return out.reshape(B, Sq, d)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------

def ssd_apply(scan, x, dt, A, Bm, Cm, *, chunk, D=None, **scan_kw):
    """The SSD scan's pre- and post-processing, shared by both routes of
    ``models.mamba2.ssd_chunked``: a = dt·A in float32, ``scan(x, dt, a,
    Bm, Cm, chunk=min(chunk, S), **scan_kw)`` -> (y, final state float32),
    then the D skip added in float32 and y cast back to x's dtype."""
    dt = dt.float().contiguous()
    y, fin = scan(x, dt, dt * A.float(), Bm, Cm,
                  chunk=min(chunk, x.shape[1]), **scan_kw)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), fin


@_plain_only
def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N)
    *,
    chunk: int,
    D=None,  # (H,) skip weight
    init_state=None,
):
    """The SSD scan from a zero state -> (y (B,S,H,P) in x's dtype, final
    state (B,H,P,N) float32), through ``ssd_apply`` around the kernel.
    An initial state (mid-sequence continuation) is not what the kernel
    computes: it raises, as the reference asserts."""
    if init_state is not None:
        raise ValueError("the ssd kernel starts from a zero state; use "
                         "impl='torch' for mid-sequence continuation")
    return ssd_apply(ssd_chunk_scan, x, dt, A, Bm, Cm, chunk=chunk, D=D)


# ---------------------------------------------------------------------------
# attention-kernel table: the kernel-layer face of the serving registries
# ---------------------------------------------------------------------------

# keyed (phase, cache_kind, style) like models.backends plus the phase axis,
# minus the impl axis (every wrapper here IS the "cuda" route; on CPU
# tensors it runs the plain version).  Prefill compute is cache-kind
# independent (paging moves only where the prompt's KV is written,
# ``models.transformer``), so both fp prefill cache kinds map to the same
# flash wrapper.  On the int8 pool decode dequantizes pool pages in the
# kernel and merged prefill the int8 prompt tiles; generic q8 prefill
# dequantizes upstream (``models.transformer``) and runs the fp flash
# kernel, as the reference routes it.
ATTENTION_KERNELS = {
    ("decode", "dense", "generic"): decode_attention,
    ("decode", "dense", "merged"): decode_attention_merged,
    ("decode", "paged", "generic"): decode_attention_paged,
    ("decode", "paged", "merged"): decode_attention_paged_merged,
    ("prefill", "dense", "generic"): flash_attention,
    ("prefill", "dense", "merged"): flash_attention_merged,
    ("prefill", "paged", "generic"): flash_attention,
    ("prefill", "paged", "merged"): flash_attention_merged,
    ("decode", "paged_q8", "generic"): decode_attention_paged_q8,
    ("decode", "paged_q8", "merged"): decode_attention_paged_q8_merged,
    ("prefill", "paged_q8", "generic"): flash_attention,
    ("prefill", "paged_q8", "merged"): flash_attention_merged_q8,
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

# the partial-state twin of each paged decode entry, keyed (cache_kind,
# style) like ``DECODE_KERNELS`` (the dense cores call their twins by name)
DECODE_STATES = {
    ("paged", "generic"): decode_attention_paged_states,
    ("paged", "merged"): decode_attention_paged_merged_states,
    ("paged_q8", "generic"): decode_attention_paged_q8_states,
    ("paged_q8", "merged"): decode_attention_paged_q8_merged_states,
}


def decode_kernel(cache_kind: str, style: str):
    """Decode kernel wrapper for one (cache_kind, style) combo; unknown
    combos raise KeyError naming the registered ones."""
    try:
        return DECODE_KERNELS[(cache_kind, style)]
    except KeyError:
        raise KeyError(
            f"no decode kernel for (cache_kind={cache_kind!r}, style="
            f"{style!r}); available: {sorted(DECODE_KERNELS)}") from None

"""Attention cores: GQA, causal & sliding-window, prefill & decode, over
the dense cache, a paged pool or an int8 paged pool.

Counterpart of ``repro.models.attention``'s dense, paged and paged_q8
cores.  Projections live in ``models.transformer`` (the paper's merged
form changes which exist); this module computes attention on projected,
RoPE'd q/k/v.

Two implementations, the ``impl`` axis of the backend registries:
  * ``impl="torch"`` — plain PyTorch math (the port of the reference's XLA
    cores, query-chunked so the score buffer is O(chunk × Sk));
  * ``impl="cuda"`` — the hand-written kernels, fetched from
    ``kernels.ops.ATTENTION_KERNELS`` keyed (phase, cache_kind, style).

On the int8 pool the "cuda" route hands the int8 pages (or prompt K/V)
and their scales to kernels that dequantize in place; the "torch" route
dequantizes into the query's dtype, as the reference's XLA route does,
and defers to the fp core.

GQA is computed grouped (q reshaped to (…, n_kv, group, d)): KV heads are
never materialized repeated.

Under a device mesh the operands are DTensors.  Where the mesh's model
axis has size 1 every rank holds whole heads and sequences, so each core
runs on its rank's local shards (``distribution.placed.local_call``: the
batch rows of every dp rank; a paged pool goes in as it lies, whole on
every rank), through the kernels on the card; a kernel never sees a
DTensor.  A larger model axis splits heads or sequences: the "torch"
route then runs on the DTensors, which propagate the sharding and insert
the collectives.  The "cuda" route runs the kernels on each rank's local
tensors there too: a prefill and a VLM's cross decode on the rank's
query heads and the kv heads they read (``placed.heads_call``); a dense
decode step over the rank's slice of the cache's sequence, the decode
kernel's partial softmax states combined across the model axis
(``placed.split_k_call``, the reference's flash-decoding split-K).  The
paged pools split their PAGES over it instead: each rank attends over the
pages it holds (table entries for other ranks' pages are masked after
the positions are derived from the table of global width: the partial-
state twin of the paged decode kernel, its plain version on either
route's CPU tensors) and the partial softmax states are combined across
the model axis (``distribution.placed.combine_softmax``), as in the
reference.  No step gathers a cache or a pool.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distribution.placed import (combine_softmax, heads_call,
                                             is_placed, local_call,
                                             model_split, on_shards,
                                             own_pages, shard_box,
                                             split_group, split_k_call)
from repro_torch.kernels import quant
from repro_torch.kernels.paging import paged_ring_active
from repro_torch.kernels.ref import ref_paged_gather as _paged_gather
from repro_torch.kernels.ref import ref_paged_positions as paged_kv_positions

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
    """Additive bias (B, 1, Sq, Sk) fp32: 0 where attendable, NEG_INF else.
    Out of place: ``kv_pos`` may be a DTensor whose keys the model axis
    splits (a chunk over a sequence-split cache), which an in-place ``&=``
    into the plain mask cannot take."""
    ok = torch.ones((q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1]),
                    dtype=torch.bool, device=q_pos.device)
    if causal:
        ok = ok & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if sliding_window > 0:
        ok = ok & (q_pos[:, :, None] - kv_pos[:, None, :] < sliding_window)
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
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
    if on_shards(impl, q, k, v):
        return local_call(
            lambda q, k, v, qp, kp, kvv: attention_core(
                q, k, v, q_positions=qp, kv_positions=kp, causal=causal,
                sliding_window=sliding_window, kv_valid=kvv,
                query_chunk=query_chunk, impl=impl),
            (q, k, v, q_positions, kv_positions, kv_valid))
    if model_split(impl, q, k, v):  # the kernel on this rank's heads
        return heads_call(
            lambda q, k, v, qp, kp, kvv: attention_core(
                q, k, v, q_positions=qp, kv_positions=kp, causal=causal,
                sliding_window=sliding_window, kv_valid=kvv,
                query_chunk=query_chunk, impl=impl),
            [(q, True, 2, False), (k, True, 2, True), (v, True, 2, True),
             (q_positions, True, None, False),
             (kv_positions, True, None, False),
             (kv_valid, True, None, False)],
            2, n_heads=q.shape[2], group=q.shape[2] // k.shape[2])
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
    k_scale: Optional[torch.Tensor] = None,  # (B, Sk//sg, Hkv) f32 (q8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Merged (Q/P-removed, paper Fig 1b) full-sequence attention, the
    prefill sibling of ``decode_attention_core_merged``: the stream is the
    query (the grouped-head view is free) and the (B, Sq, d_model) result
    is the FFN-input stream.  Numerics equal ``attention_core`` on the
    head view.

    ``k_scale``/``v_scale`` switch to the int8 pool's prefill: k/v arrive
    as int8 at the pool's quantization with per-(page, head) scales; the
    "cuda" route hands them to the dequantizing flash kernel, the "torch"
    route dequantizes the sequence into u's dtype and falls through."""
    _check_impl(impl)
    if on_shards(impl, u, k, v):
        return local_call(
            lambda u, k, v, qp, kp, ks, vs: attention_core_merged(
                u, k, v, q_positions=qp, kv_positions=kp,
                n_kv_heads=n_kv_heads, causal=causal,
                sliding_window=sliding_window, query_chunk=query_chunk,
                impl=impl, cache_kind=cache_kind, k_scale=ks, v_scale=vs),
            (u, k, v, q_positions, kv_positions, k_scale, v_scale))
    B, Sq, d = u.shape
    D = k.shape[3]
    if model_split(impl, u, k, v):  # the kernel on this rank's heads
        Hq = d // D
        out = heads_call(
            lambda u, k, v, qp, kp, ks, vs: attention_core_merged(
                u.reshape(u.shape[0], Sq, -1), k, v, q_positions=qp,
                kv_positions=kp, n_kv_heads=k.shape[2], causal=causal,
                sliding_window=sliding_window, query_chunk=query_chunk,
                impl=impl, cache_kind=cache_kind, k_scale=ks,
                v_scale=vs).reshape(u.shape),
            [(u.reshape(B, Sq, Hq, D), True, 2, False), (k, True, 2, True),
             (v, True, 2, True), (q_positions, True, None, False),
             (kv_positions, True, None, False), (k_scale, True, 2, True),
             (v_scale, True, 2, True)],
            2, n_heads=Hq, group=Hq // k.shape[2])
        return out.reshape(B, Sq, d)
    kw = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.attention_kernel("prefill", cache_kind, "merged")(
            u, k, v, n_kv_heads=n_kv_heads, q_positions=q_positions,
            kv_positions=kv_positions, causal=causal,
            sliding_window=sliding_window, **kw)
    if kw:
        k = quant.q8_dequant_seq(k, k_scale, u.dtype)
        v = quant.q8_dequant_seq(v, v_scale, u.dtype)
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
    if on_shards(impl, u, k_cache, v_cache):
        return local_call(
            lambda u, k, v, kp, qp: decode_attention_core_merged(
                u, k, v, kv_positions=kp, q_position=qp,
                n_kv_heads=n_kv_heads, sliding_window=sliding_window,
                impl=impl),
            (u, k_cache, v_cache, kv_positions, q_position))
    if model_split(impl, u, k_cache, v_cache):  # split-K over the sequence
        from repro_torch.kernels import ops as kops

        return split_k_call(
            lambda u, k, v, kp, qp: kops.decode_attention_merged_states(
                u, k, v, kv_positions=kp, q_position=qp,
                n_kv_heads=n_kv_heads, sliding_window=sliding_window),
            lambda u, k, v, kp, qp: decode_attention_core_merged(
                u, k, v, kv_positions=kp, q_position=qp,
                n_kv_heads=n_kv_heads, sliding_window=sliding_window,
                impl=impl),
            u, (k_cache, v_cache, kv_positions), (q_position,), u.dtype)
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
    if on_shards(impl, q, k_cache, v_cache):
        return local_call(
            lambda q, k, v, kp, qp: decode_attention_core_positions(
                q, k, v, kv_positions=kp, q_position=qp,
                sliding_window=sliding_window, impl=impl),
            (q, k_cache, v_cache, kv_positions, q_position))
    if model_split(impl, q, k_cache, v_cache):  # split-K over the sequence
        from repro_torch.kernels import ops as kops

        return split_k_call(
            lambda q, k, v, kp, qp: kops.decode_attention_states(
                q, k, v, kv_positions=kp, q_position=qp,
                sliding_window=sliding_window),
            lambda q, k, v, kp, qp: decode_attention_core_positions(
                q, k, v, kv_positions=kp, q_position=qp,
                sliding_window=sliding_window, impl=impl),
            q, (k_cache, v_cache, kv_positions), (q_position,), q.dtype)
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


def decode_attention_core_cross(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, nv, Hkv, D) — a VLM's cross K/V
    v_cache: torch.Tensor,  # (B, nv, Hkv, D)
    *,
    kv_positions: torch.Tensor,  # (B, nv) int
    q_position: torch.Tensor,  # (B,) int
    impl: str = "torch",
) -> torch.Tensor:
    """One token's cross-attention over a VLM's vision K/V -> (B, Hq, D):
    what ``decode_attention_core_positions`` computes.  ``impl="cuda"``
    hands the cross cache to the generic decode kernel in place
    (``kernels.ops.decode_attention_native``): it never changes after
    prefill, so a head-major copy per step would be pure traffic."""
    _check_impl(impl)
    if on_shards(impl, q, k_cache, v_cache):
        return local_call(
            lambda q, k, v, kp, qp: decode_attention_core_cross(
                q, k, v, kv_positions=kp, q_position=qp, impl=impl),
            (q, k_cache, v_cache, kv_positions, q_position))
    if model_split(impl, q, k_cache, v_cache):  # this rank's heads
        return heads_call(
            lambda q, k, v, kp, qp: decode_attention_core_cross(
                q, k, v, kv_positions=kp, q_position=qp, impl=impl),
            [(q, True, 1, False), (k_cache, True, 2, True),
             (v_cache, True, 2, True), (kv_positions, True, None, False),
             (q_position, True, None, False)],
            1, n_heads=q.shape[1], group=q.shape[1] // k_cache.shape[2])
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_attention_native(
            q, k_cache, v_cache, kv_positions=kv_positions,
            q_position=q_position)
    return decode_attention_core_positions(
        q, k_cache, v_cache, kv_positions=kv_positions,
        q_position=q_position, impl=impl)


# ---------------------------------------------------------------------------
# partial softmax states (key ranges held by different ranks)
# ---------------------------------------------------------------------------

def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      bias: torch.Tensor):
    """Softmax state of q (B, Sq, Hq, D) over k/v (B, Sk, Hkv, D) under the
    additive ``bias`` (B, 1, Sq, Sk) (0 or ``NEG_INF``): (m, l, o) in
    float32, m and l (B, Hkv, G, Sq), o (B, Hkv, G, Sq, D) unnormalised,
    for ``placed.combine_softmax``.  The scores are ``attention_core``'s."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (1.0 / (D ** 0.5)) + bias[:, :, None]
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())


def combined_heads(states, group=None) -> torch.Tensor:
    """``placed.combine_softmax`` of ``attention_partial`` states (stacked
    on a leading dim without ``group``) -> (B, Sq, Hq, D) float32."""
    o = combine_softmax(*states, group=group)
    B, Hkv, G, Sq, D = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G, D)


def _paged_on_mesh(core, q, pools, block_tables, q_position, kw):
    """A paged decode ``core`` whose pool is a DTensor.  Model axis 1:
    ``core`` on this rank's batch rows (``local_call``; the pool, whole
    on every rank, goes in as an ``other`` operand), so the kernels see
    local tensors.  A larger model axis: this rank's rows with whole
    heads attend over the pages it holds, and the states are combined
    across the model axis: the partial-state twin of the decode kernel
    (``kernels.ops.DECODE_STATES``; on CPU tensors, either route's, its
    plain version) over the rank's pool and the table of global width
    whose other ranks' pages are -1.  Where no mesh dim splits the pages
    (``sharding.evenly`` keeps a pool whole whose page count the model
    axis does not divide), ``core`` runs on the local tensors.  ``pools``:
    (k, v) or (k, v, k_scale, v_scale)."""
    if on_shards(kw["impl"], q, *pools):
        return local_call(
            lambda q, bt, qp, *p: core(q, *p, block_tables=bt,
                                       q_position=qp, **kw),
            (q, block_tables, q_position), pools)
    from torch.distributed.tensor import DTensor

    mesh, place = pools[0].device_mesh, block_tables.placements
    ql = q.redistribute(mesh, place).to_local()
    local = [p.to_local() for p in pools]
    bt, qp = block_tables.to_local(), q_position.to_local()
    group = split_group(pools[0], 0)
    if group is None:
        out = core(ql, *local, block_tables=bt, q_position=qp, **kw)
        return DTensor.from_local(out, mesh, place, run_check=False)
    scales = {} if len(local) == 2 else dict(k_scale=local[2],
                                              v_scale=local[3])
    from repro_torch.kernels import ops as kops

    merged = "n_kv_heads" in kw
    twin = kops.DECODE_STATES[("paged_q8" if scales else "paged",
                               "merged" if merged else "generic")]
    heads = {"n_kv_heads": kw["n_kv_heads"]} if merged else {}
    out = combine_softmax(*twin(
        ql, local[0], local[1], **scales,
        block_tables=own_pages(bt, shard_box(pools[0])[0][0],
                               local[0].shape[0]),
        q_position=qp, sliding_window=kw["sliding_window"], **heads),
        group=group)
    dtype = ql.dtype if scales else local[1].dtype
    return DTensor.from_local(out.to(dtype).reshape(ql.shape), mesh, place,
                              run_check=False)


# ---------------------------------------------------------------------------
# paged decode cores (block-table gather over a physical page pool)
# ---------------------------------------------------------------------------
#
# ``paged_kv_positions`` and ``_paged_gather`` are the plain versions'
# (``kernels.ref``): one definition of the gather and of the ring
# positions for the oracle and this route.  A DTensor pool (a mesh) goes
# through ``_paged_on_mesh``.

def decode_attention_core_paged(
    q: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — physical page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    """One-token attention against a paged KV pool -> (B, Hq, D).

    ``impl="cuda"`` hands the pool and table to the paged kernel (pages
    are gathered row by row inside it); ``impl="torch"`` densifies the
    slot's logical view and defers to the dense positions core.  Ring
    addressing is derived from the window and the table width
    (``kernels.paging``)."""
    _check_impl(impl)
    if is_placed(k_pool):
        return _paged_on_mesh(decode_attention_core_paged, q,
                              (k_pool, v_pool), block_tables, q_position,
                              dict(sliding_window=sliding_window, impl=impl))
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("paged", "generic")(
            q, k_pool, v_pool, block_tables=block_tables,
            q_position=q_position, sliding_window=sliding_window)
    bs = k_pool.shape[1]
    ring = paged_ring_active(sliding_window, bs, block_tables.shape[1])
    return decode_attention_core_positions(
        q, _paged_gather(k_pool, block_tables),
        _paged_gather(v_pool, block_tables),
        kv_positions=paged_kv_positions(block_tables, bs, q_position, ring),
        q_position=q_position, sliding_window=sliding_window, impl=impl)


def decode_attention_core_paged_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream (merged query)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — K* page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) — V* page pool
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int
    n_kv_heads: int,
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    """Merged (Q/P-removed) decode attention over a paged KV pool: the
    stream is the query and the (B, d_model) output is the FFN input."""
    _check_impl(impl)
    if is_placed(k_pool):
        return _paged_on_mesh(decode_attention_core_paged_merged, u,
                              (k_pool, v_pool), block_tables, q_position,
                              dict(n_kv_heads=n_kv_heads,
                                   sliding_window=sliding_window, impl=impl))
    B, d = u.shape
    D = k_pool.shape[3]
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("paged", "merged")(
            u, k_pool, v_pool, block_tables=block_tables,
            q_position=q_position, n_kv_heads=n_kv_heads,
            sliding_window=sliding_window)
    out = decode_attention_core_paged(
        u.reshape(B, d // D, D), k_pool, v_pool, block_tables=block_tables,
        q_position=q_position, sliding_window=sliding_window, impl=impl)
    return out.reshape(B, d)


# ---------------------------------------------------------------------------
# int8 (paged_q8) decode cores: int8 pools + per-(page, head) scales
# ---------------------------------------------------------------------------

def _paged_gather_q8(pool: torch.Tensor, scale: torch.Tensor,
                     block_tables: torch.Tensor, out_dtype) -> torch.Tensor:
    """Densify and dequantize a slot's logical view of an int8 pool:
    (NB, bs, Hkv, D) int8 + (NB, Hkv) float32 scales + (B, MB) tables ->
    (B, MB*bs, Hkv, D) ``out_dtype`` (dequantized in float32).  Unmapped
    blocks gather page 0, masked by their -1 positions as in
    ``_paged_gather``."""
    B, MB = block_tables.shape
    bt = block_tables.long().clamp(min=0)
    g = pool[bt].float() * scale[bt][:, :, None, :, None]
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:]).to(out_dtype)


def decode_attention_core_paged_q8(
    q: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8
    k_scale: torch.Tensor,  # (NB, Hkv) float32 per-(page, head) scales
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    """One-token attention against an int8 paged pool -> (B, Hq, D).

    ``impl="cuda"`` hands pools and scales to the dequantizing paged
    kernel (no float view of the pool exists); ``impl="torch"`` densifies
    the slot's view dequantized page by page into q's dtype and defers to
    the dense positions core, as ``decode_attention_core_paged`` does."""
    _check_impl(impl)
    if is_placed(k_pool):
        return _paged_on_mesh(decode_attention_core_paged_q8, q,
                              (k_pool, v_pool, k_scale, v_scale),
                              block_tables, q_position,
                              dict(sliding_window=sliding_window, impl=impl))
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("paged_q8", "generic")(
            q, k_pool, v_pool, k_scale=k_scale, v_scale=v_scale,
            block_tables=block_tables, q_position=q_position,
            sliding_window=sliding_window)
    bs = k_pool.shape[1]
    ring = paged_ring_active(sliding_window, bs, block_tables.shape[1])
    return decode_attention_core_positions(
        q, _paged_gather_q8(k_pool, k_scale, block_tables, q.dtype),
        _paged_gather_q8(v_pool, v_scale, block_tables, q.dtype),
        kv_positions=paged_kv_positions(block_tables, bs, q_position, ring),
        q_position=q_position, sliding_window=sliding_window, impl=impl)


def decode_attention_core_paged_q8_merged(
    u: torch.Tensor,  # (B, d_model) — RoPE'd stream (merged query)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 K* page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 V* page pool
    k_scale: torch.Tensor,  # (NB, Hkv) float32
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    *,
    block_tables: torch.Tensor,  # (B, MB) int32 page ids, -1 unmapped
    q_position: torch.Tensor,  # (B,) int
    n_kv_heads: int,
    sliding_window: int = 0,
    impl: str = "torch",
) -> torch.Tensor:
    """Merged (Q/P-removed) decode attention over an int8 paged pool: the
    stream is the query and the (B, d_model) output is the FFN input."""
    _check_impl(impl)
    if is_placed(k_pool):
        return _paged_on_mesh(decode_attention_core_paged_q8_merged, u,
                              (k_pool, v_pool, k_scale, v_scale),
                              block_tables, q_position,
                              dict(n_kv_heads=n_kv_heads,
                                   sliding_window=sliding_window, impl=impl))
    B, d = u.shape
    D = k_pool.shape[3]
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.decode_kernel("paged_q8", "merged")(
            u, k_pool, v_pool, k_scale=k_scale, v_scale=v_scale,
            block_tables=block_tables, q_position=q_position,
            n_kv_heads=n_kv_heads, sliding_window=sliding_window)
    out = decode_attention_core_paged_q8(
        u.reshape(B, d // D, D), k_pool, v_pool, k_scale, v_scale,
        block_tables=block_tables, q_position=q_position,
        sliding_window=sliding_window, impl=impl)
    return out.reshape(B, d)

"""Plain PyTorch versions of the attention kernels and the SSD scan.

Each function is the transparent O(S²) form of what its CUDA kernel
computes, in float32, returned in the input dtype.  The kernel wrappers
(``flash_attention``, ``decode_attention``) run these for tensors that lie
on the CPU; on the card ``chip_smoke.py`` and the GPU tests hold each
kernel against them on the same inputs.  Counterparts of
``repro.kernels.ref`` (same names, same masking semantics): masked scores
go to ``NEG`` before the softmax and their probabilities are then zeroed,
so a row with nothing to attend to is exactly zero.  The paged versions
gather a slot's pages into a dense view and defer to the dense decode
version (``ref_decode_attention_paged*``); the int8 versions dequantize
in float32 (``ints * scale``) and defer to the fp ones.  Each decode
version has a partial-state twin (``ref_decode_states*``): the float32
softmax state (max, sum, unnormalised output) of the keys it is given,
what the decode kernel writes in its partial-state mode for a rank's
slice of the sequence or the pages.  The SSD scan has two: the sequential recurrence ``ref_ssd`` (the ground truth) and the
chunked scan ``ref_ssd_chunked`` (what the CUDA kernel computes, tiled as
the reference's XLA path tiles it).
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


def ref_decode_states(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
):
    """``ref_decode_attention``'s softmax state over the keys given,
    unnormalised, in float32: m (B, Hkv, G) the max of the attendable
    scores, l (B, Hkv, G) the sum of exp(score - m) over them, o (B, Hkv,
    G, D) the sum of exp(score - m) v.  With nothing to attend (S may be
    0): m = ``NEG``, l = 0, o = 0.  ``o / l`` is the decode output where
    l > 0; ``distribution.placed.combine_softmax`` combines the states of
    disjoint key ranges."""
    B, Hkv, G, D = q.shape
    if k.shape[2] == 0:
        z = q.new_zeros((B, Hkv, G), dtype=torch.float32)
        return z + NEG, z, q.new_zeros(q.shape, dtype=torch.float32)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) / (D ** 0.5)
    qpos = q_position.reshape(-1)[:, None]
    ok = (kv_positions >= 0) & (kv_positions <= qpos)
    if sliding_window > 0:
        ok &= qpos - kv_positions < sliding_window
    ok = ok[:, None, None, :]
    s = torch.where(ok, s, NEG)
    m = s.amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhgk,bhkd->bhgd", p, v.float())


def _stream_states(states, B, Hq, D):
    """Grouped (B, Hkv, G[, D]) states as the stream's (B, Hq[, D])."""
    m, l, o = states
    return m.reshape(B, Hq), l.reshape(B, Hq), o.reshape(B, Hq, D)


def ref_decode_states_merged(
    u: torch.Tensor,  # (B, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    kv_positions: torch.Tensor,  # (B, S) int32, -1 empty
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
):
    """``ref_decode_states`` of the merged query over the native cache:
    m, l (B, Hq), o (B, Hq, D)."""
    B, Hq, D = u.shape
    Hkv = k.shape[2]
    return _stream_states(ref_decode_states(
        u.reshape(B, Hkv, Hq // Hkv, D), k.transpose(1, 2),
        v.transpose(1, 2), kv_positions, q_position,
        sliding_window=sliding_window), B, Hq, D)


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


# ---------------------------------------------------------------------------
# paged decode: block-table gather over a physical page pool
# ---------------------------------------------------------------------------

def ref_paged_gather(
    pool: torch.Tensor,  # (NB, bs, Hkv, D) physical page pool
    block_tables: torch.Tensor,  # (B, MB) int page ids, -1 unmapped
) -> torch.Tensor:
    """Densify each slot's logical view: -> (B, MB*bs, Hkv, D).  Unmapped
    blocks gather page 0; ``ref_paged_positions`` marks them -1."""
    B, MB = block_tables.shape
    g = pool[block_tables.long().clamp(min=0)]  # (B, MB, bs, Hkv, D)
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:])


def ref_paged_positions(block_tables: torch.Tensor, block_size: int,
                        q_position: torch.Tensor = None,
                        ring_blocks: int = 0) -> torch.Tensor:
    """kv positions (B, MB*bs) int32 of the densified view; unmapped
    blocks are -1 (the empty-slot convention).

    Absolute addressing (``ring_blocks`` = 0): logical block j covers
    [j*bs, (j+1)*bs).  Ring addressing (``kernels.paging``): slot j holds
    the latest absolute block b = j (mod ring) not beyond the query's
    block, b = lb - ((lb + ring - j) % ring) with lb = q_position // bs;
    never-entered slots (b < 0) are -1."""
    B, MB = block_tables.shape
    dev = block_tables.device
    off = torch.arange(block_size, dtype=torch.int32, device=dev)
    j = torch.arange(MB, dtype=torch.int32, device=dev)[None, :]
    mapped = block_tables >= 0
    if ring_blocks:
        lb = (q_position.to(torch.int32) // block_size).reshape(B, 1)
        blk = lb - torch.remainder(lb + ring_blocks - j, ring_blocks)
        mapped = mapped & (blk >= 0)
    else:
        blk = j.expand(B, MB)
    pos = blk[:, :, None] * block_size + off  # (B, MB, bs)
    pos = torch.where(mapped[:, :, None], pos, -1)
    return pos.reshape(B, MB * block_size).to(torch.int32)


def ref_decode_attention_paged(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Generic paged decode: gather the slot's pages into a dense view and
    defer to ``ref_decode_attention`` -> (B, Hkv, G, D)."""
    bs = k_pool.shape[1]
    k = ref_paged_gather(k_pool, block_tables).transpose(1, 2)
    v = ref_paged_gather(v_pool, block_tables).transpose(1, 2)
    kv_pos = ref_paged_positions(block_tables, bs, q_position, ring_blocks)
    return ref_decode_attention(q, k, v, kv_pos, q_position,
                                sliding_window=sliding_window)


def ref_decode_states_paged(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
):
    """``ref_decode_states`` over the pages a table maps: a rank's pool
    and its table of the GLOBAL width, other ranks' pages marked -1
    (``placed.own_pages``), so that positions, ring positions included,
    come from the table slot as on the whole pool."""
    bs = k_pool.shape[1]
    k = ref_paged_gather(k_pool, block_tables).transpose(1, 2)
    v = ref_paged_gather(v_pool, block_tables).transpose(1, 2)
    kv_pos = ref_paged_positions(block_tables, bs, q_position, ring_blocks)
    return ref_decode_states(q, k, v, kv_pos, q_position,
                             sliding_window=sliding_window)


def ref_decode_states_paged_merged(
    u: torch.Tensor,  # (B, Hq, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
):
    """``ref_decode_states_paged`` of the merged query -> (B, Hq) states."""
    B, Hq, D = u.shape
    Hkv = k_pool.shape[2]
    return _stream_states(ref_decode_states_paged(
        u.reshape(B, Hkv, Hq // Hkv, D), k_pool, v_pool, block_tables,
        q_position, sliding_window=sliding_window, ring_blocks=ring_blocks),
        B, Hq, D)


def ref_decode_attention_paged_merged(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd stream viewed as heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — K* page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) — V* page pool
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Merged paged decode: stream-as-query over the page pool, output as
    (B, Hq, D) in the FFN-input basis."""
    B, Hq, D = u.shape
    Hkv = k_pool.shape[2]
    o = ref_decode_attention_paged(
        u.reshape(B, Hkv, Hq // Hkv, D), k_pool, v_pool, block_tables,
        q_position, sliding_window=sliding_window, ring_blocks=ring_blocks)
    return o.reshape(B, Hq, D)


# ---------------------------------------------------------------------------
# int8 (paged_q8) versions: dequantize in float32, defer to the fp versions
# ---------------------------------------------------------------------------

def ref_q8_dequant_pool(pool: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """(NB, bs, Hkv, D) int8 + (NB, Hkv) float32 -> (NB, bs, Hkv, D)
    float32."""
    return pool.float() * scale[:, None, :, None]


def ref_decode_attention_paged_q8(
    q: torch.Tensor,  # (B, Hkv, G, D)
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8
    k_scale: torch.Tensor,  # (NB, Hkv) float32
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Generic q8 paged decode: dequantize the whole pool in float32 (what
    the kernel avoids) and defer to ``ref_decode_attention_paged``."""
    return ref_decode_attention_paged(
        q, ref_q8_dequant_pool(k_pool, k_scale),
        ref_q8_dequant_pool(v_pool, v_scale), block_tables, q_position,
        sliding_window=sliding_window, ring_blocks=ring_blocks)


def ref_decode_attention_paged_q8_merged(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd stream viewed as heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 K* pages
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 V* pages
    k_scale: torch.Tensor,  # (NB, Hkv) float32
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32, -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Merged q8 paged decode -> (B, Hq, D)."""
    return ref_decode_attention_paged_merged(
        u, ref_q8_dequant_pool(k_pool, k_scale),
        ref_q8_dequant_pool(v_pool, v_scale), block_tables, q_position,
        sliding_window=sliding_window, ring_blocks=ring_blocks)


def ref_decode_states_paged_q8(q, k_pool, v_pool, k_scale, v_scale,
                               block_tables, q_position, *,
                               sliding_window: int = 0, ring_blocks: int = 0):
    """``ref_decode_states_paged`` over int8 pages (dequantized in
    float32)."""
    return ref_decode_states_paged(
        q, ref_q8_dequant_pool(k_pool, k_scale),
        ref_q8_dequant_pool(v_pool, v_scale), block_tables, q_position,
        sliding_window=sliding_window, ring_blocks=ring_blocks)


def ref_decode_states_paged_q8_merged(u, k_pool, v_pool, k_scale, v_scale,
                                      block_tables, q_position, *,
                                      sliding_window: int = 0,
                                      ring_blocks: int = 0):
    """``ref_decode_states_paged_merged`` over int8 pages."""
    return ref_decode_states_paged_merged(
        u, ref_q8_dequant_pool(k_pool, k_scale),
        ref_q8_dequant_pool(v_pool, v_scale), block_tables, q_position,
        sliding_window=sliding_window, ring_blocks=ring_blocks)


def ref_flash_attention_merged_q8(
    u: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D) int8
    v: torch.Tensor,  # (B, Sk, Hkv, D) int8
    k_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32, sg = page size
    v_scale: torch.Tensor,  # (B, Sk // sg, Hkv) float32
    *,
    causal: bool = True,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Merged q8 flash prefill: expand each page's scale over its ``sg``
    rows, dequantize in float32, defer to ``ref_flash_attention_merged``;
    the output takes ``u``'s dtype."""
    sg = k.shape[1] // k_scale.shape[1]
    ks = torch.repeat_interleave(k_scale, sg, dim=1)[..., None]
    vs = torch.repeat_interleave(v_scale, sg, dim=1)[..., None]
    return ref_flash_attention_merged(u, k.float() * ks, v.float() * vs,
                                      causal=causal,
                                      sliding_window=sliding_window)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan: the sequential oracle and the chunked plain version
# ---------------------------------------------------------------------------

def ref_ssd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a: torch.Tensor,  # (B, S, H) = dt * A
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N)
):
    """Sequential (step-by-step) SSD recurrence from a zero state — the
    ground truth.  Returns (y (B,S,H,P) fp32, final_state (B,H,P,N))."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    x, dt, a, Bm, Cm = (t.float() for t in (x, dt, a, Bm, Cm))
    state = x.new_zeros((B, H, P, N))
    ys = []
    for t in range(S):
        dBx = torch.einsum("bh,bhn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        state = state * torch.exp(a[:, t])[..., None, None] + dBx
        ys.append(torch.einsum("bhn,bhpn->bhp", Cm[:, t], state))
    return torch.stack(ys, dim=1), state


def ref_ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a: torch.Tensor,  # (B, S, H) = dt * A, <= 0
    Bm: torch.Tensor,  # (B, S, H, N)
    Cm: torch.Tensor,  # (B, S, H, N)
    *,
    chunk: int,
    init_state=None,  # (B, H, P, N) or None (zeros)
):
    """The chunked SSD scan of ``repro.models.mamba2.ssd_chunked``'s XLA
    path: chunks of L = ``chunk`` rows if that divides S, else one chunk
    of S; within a chunk the masked, decay-weighted (L, L) products, across
    chunks the carried (P, N) state.  Returns (y (B,S,H,P) fp32,
    final_state (B,H,P,N) fp32), without the D skip."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = chunk if S % chunk == 0 else S
    state = (x.new_zeros((B, H, P, N), dtype=torch.float32)
             if init_state is None else init_state.float())
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        xc, dtc, ac = x[:, sl].float(), dt[:, sl].float(), a[:, sl].float()
        Bc, Cc = Bm[:, sl].float(), Cm[:, sl].float()
        a_cum = torch.cumsum(ac, dim=1)  # (B, L, H)
        a_sum = a_cum[:, -1, :]  # (B, H)
        decay_out = torch.exp(a_cum)
        decay_end = torch.exp(a_sum[:, None, :] - a_cum)
        cb = torch.einsum("blhn,bmhn->blmh", Cc, Bc)
        seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # (B, L, M, H)
        kern = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0) \
            * cb * dtc[:, None, :, :]
        y = torch.einsum("blmh,bmhp->blhp", kern, xc)
        y = y + torch.einsum("blhn,bhpn->blhp", Cc, state) \
            * decay_out[..., None]
        dbx = torch.einsum("blhn,blhp->bhpn",
                           Bc * (decay_end * dtc)[..., None], xc)
        state = state * torch.exp(a_sum)[:, :, None, None] + dbx
        ys.append(y)
    return torch.cat(ys, dim=1), state

"""One-token GQA decode attention: wrappers of ``csrc/decode_attention.cu``.

Counterparts of ``repro.kernels.decode_attention``'s dense and paged
pairs:

  * ``decode_attention_bhsd`` — generic: a separately-projected grouped
    query (B, Hkv, G, D) against a head-major (B, Hkv, S, D) cache;
    ``decode_attention_bshd`` launches the same kernel on a
    sequence-major (B, S, Hkv, D) cache read in place (a VLM's cross
    K/V);
  * ``decode_attention_merged_bsd`` — the paper's merged (Q/P-removed)
    fast path: the RoPE'd residual stream viewed (B, Hq, D) is the query,
    K*/V* are read in the serving cache's native (B, S, Hkv, D) layout and
    the output lands as (B, Hq, D), a view of the FFN-input stream;
  * ``decode_attention_paged_bhsd`` / ``decode_attention_paged_merged_bsd``
    — the same two queries over a page pool (NB, bs, Hkv, D) behind a
    block table (B, MB) int32 (-1 unmapped), with absolute or ring
    addressing (``ring_blocks``, ``kernels.paging``); key positions are
    rebuilt in the kernel from the table and ``q_position``;
  * ``decode_attention_paged_q8_bhsd`` /
    ``decode_attention_paged_q8_merged_bsd`` — the paged pair over int8
    pages with float32 scales (NB, Hkv) (``kernels.quant``), dequantized
    in the kernel as each row is loaded; the output takes the query's
    dtype.

Each entry point but ``decode_attention_bshd`` (whose caller, the VLM's
cross decode, splits heads and not keys) has a partial-state twin,
``<name>_states`` (the operator ``torch.ops.repro_torch.<name>_states``):
the same launch in the kernel's partial-state mode, which returns the
float32 softmax state of the keys it is given, (m, l, o): m and l of the
query's shape without its head dim, o of the query's shape.  A rank of a mesh whose model axis
splits the cache's sequence or the pool's pages launches it on its slice
(``models.attention``), and the states are combined across the axis
(``distribution.placed.combine_softmax``).  It counts under its twin's
name in ``launches``.

Each entry point is an operator ``torch.ops.repro_torch.<name>``
(``_build.define_op``): on CPU tensors it runs the plain version
(``kernels.ref``); on a CUDA device it launches the kernel (built at first
use) on the current stream, or raises — there is no fallback.  Each call
on the card is one kernel launch; ``launches`` counts them per kernel.
See the CUDA source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ref_decode_attention,
                                     ref_decode_attention_merged,
                                     ref_decode_attention_paged,
                                     ref_decode_attention_paged_merged,
                                     ref_decode_attention_paged_q8,
                                     ref_decode_attention_paged_q8_merged,
                                     ref_decode_states,
                                     ref_decode_states_merged,
                                     ref_decode_states_paged,
                                     ref_decode_states_paged_merged,
                                     ref_decode_states_paged_q8,
                                     ref_decode_states_paged_q8_merged)

launches = {"decode_attention_bhsd": 0, "decode_attention_merged_bsd": 0,
            "decode_attention_paged_bhsd": 0,
            "decode_attention_paged_merged_bsd": 0,
            "decode_attention_paged_q8_bhsd": 0,
            "decode_attention_paged_q8_merged_bsd": 0}

MAX_G = 16  # query heads per kv head the kernel takes
PART_G = 8  # query heads of one block: a group is cut into parts of PART_G
TILE = 64  # keys per tile of the plan (the kernel's: 64, or 32 for float32
# at D 128, which divides it)
MAX_SPLIT = 8  # kv splits of one (batch, kv head): one thread-block cluster
_TARGET_BLOCKS = 2 * 132  # two blocks per H100 SM


def group_parts(G: int) -> int:
    """Blocks that share one (batch, kv head, kv split): its ``G`` query
    heads cut into parts of at most ``PART_G`` consecutive heads."""
    return -(-G // PART_G)


def kv_split(B: int, Hkv: int, S: int, G: int = 1):
    """(n_split, chunk): the kv axis is cut into ``n_split`` ranges of
    ``chunk`` whole tiles so that about ``_TARGET_BLOCKS`` blocks run, at
    most ``MAX_SPLIT`` per (batch, kv head, group part): the splits of one
    (batch, kv head, part) form a cluster that combines them in the
    kernel.  ``G`` (query heads per kv head) counts the parts."""
    want = min(MAX_SPLIT, max(1, -(-_TARGET_BLOCKS
                                   // max(B * Hkv * group_parts(G), 1))))
    chunk = -(-max(S, 1) // want)
    chunk = -(-chunk // TILE) * TILE
    return -(-max(S, 1) // chunk), chunk


def occupancy(dtype: torch.dtype, D: int, kind: str, n_split: int,
              chunk: int):
    """Residency on the card of the kernel that a call with ``n_split``
    splits of ``chunk`` keys launches, for query ``dtype``, head dim ``D``
    and ``kind`` "dense", "paged" or "paged_q8": (blocks per SM, clusters
    resident at once, dynamic shared memory bytes per block).  A block
    takes at most ``PART_G`` query heads whatever G is, so this does not
    depend on G; a launch has ``group_parts(G)`` clusters per (batch, kv
    head)."""
    res = (ctypes.c_int * 3)()
    lib = _build.library("decode_attention")
    err = lib.decode_attention_occupancy(
        _build.DTYPE_CODES[str(dtype)], D,
        ("dense", "paged", "paged_q8").index(kind), n_split, chunk,
        ctypes.addressof(res))
    _build.check_launch("decode_attention_occupancy", err)
    return tuple(res)


def _checks(name, q, data, ints, *, G, index, index_shape, scales=()):
    """Operand checks shared by the dense and paged launches; returns
    the dtype code.  ``index`` is the position or table operand; with
    ``scales`` the K/V operands in ``data[1:]`` are an int8 pool."""
    B = q.shape[0]
    if scales:
        code = _build.check_q8_operands(name, q, data[1:], scales, ints)
    else:
        code = _build.check_operands(name, data, ints)
    if not 1 <= G <= MAX_G:
        raise ValueError(f"{name}: {G} query heads per kv head; the kernel "
                         f"takes 1..{MAX_G}")
    q_position = ints[-1]
    if tuple(index.shape) != index_shape or \
            tuple(q_position.shape) != (B,):
        raise ValueError(f"{name}: positions/table must be {index_shape} "
                         f"and ({B},), got {tuple(index.shape)}, "
                         f"{tuple(q_position.shape)}")
    return code


def _state_buffers(q):
    """The partial-state mode's outputs (m, l, o), float32: m and l of
    ``q``'s shape without its last dim, o of ``q``'s shape."""
    return (q.new_empty(q.shape[:-1], dtype=torch.float32),
            q.new_empty(q.shape[:-1], dtype=torch.float32),
            q.new_empty(q.shape, dtype=torch.float32))


def _outputs(q, states: bool):
    """(result, out pointer, state pointers) of a launch: the normalised
    output, like ``q``; or, in the partial-state mode, the state buffers
    and no normalised output (a null pointer)."""
    if not states:
        out = torch.empty_like(q)
        return out, out.data_ptr(), (None, None, None)
    res = _state_buffers(q)
    return res, None, tuple(t.data_ptr() for t in res)


def _launch(name, q, k, v, kv_positions, q_position, *, q_strides,
            k_strides, Hkv, G, S, sliding_window, states=False):
    B, D = q.shape[0], q.shape[-1]
    code = _checks(name, q, (q, k, v), (kv_positions, q_position), G=G,
                   index=kv_positions, index_shape=(B, S))
    _build.check_aligned(name, (k, v))
    n_split, chunk = kv_split(B, Hkv, S, G)
    res, out, st = _outputs(q, states)
    lib = _build.library("decode_attention")
    err = lib.decode_attention_launch(
        code, D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_positions.data_ptr(), q_position.data_ptr(), out,
        B, Hkv, G, S, *q_strides, *k_strides, int(sliding_window), n_split,
        chunk, *st, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return res


def _launch_paged(name, q, k_pool, v_pool, block_tables, q_position, *,
                  q_strides, Hkv, G, sliding_window, ring_blocks,
                  scales=(), states=False):
    """Launch the paged body: fp pools, or int8 pools with their
    ``scales`` (k_scale, v_scale), each (NB, Hkv)."""
    B, D = q.shape[0], q.shape[-1]
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    MB = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if tuple(k_pool.shape) != (NB, bs, Hkv, D) or k_pool.shape != v_pool.shape:
        raise ValueError(f"{name}: pools must be (NB, bs, Hkv, D) with Hkv="
                         f"{Hkv}, D={D}, got {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    if any(tuple(s.shape) != (NB, Hkv) for s in scales):
        raise ValueError(f"{name}: scales must be (NB, Hkv) = {(NB, Hkv)}, "
                         f"got {[tuple(s.shape) for s in scales]}")
    if ring_blocks not in (0, MB):
        raise ValueError(f"{name}: ring_blocks {ring_blocks} must be 0 "
                         f"(absolute) or the table width {MB}")
    code = _checks(name, q, (q, k_pool, v_pool), (block_tables, q_position),
                   G=G, index=block_tables, index_shape=(B, MB),
                   scales=scales)
    _build.check_aligned(name, (k_pool, v_pool))
    n_split, chunk = kv_split(B, Hkv, MB * bs, G)
    res, out, st = _outputs(q, states)
    lib = _build.library("decode_attention")
    pools = [k_pool.data_ptr(), v_pool.data_ptr()]
    if scales:
        fn = lib.decode_attention_paged_q8_launch
        pools += [s.data_ptr() for s in scales]
    else:
        fn = lib.decode_attention_paged_launch
    err = fn(code, D, q.data_ptr(), *pools, block_tables.data_ptr(),
             q_position.data_ptr(), out, B, Hkv, G, MB, bs,
             int(ring_blocks),
             *q_strides, int(sliding_window), n_split, chunk, *st,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(name, err)
    launches[name] += 1
    return res


# --------------------------------------------------------------------------
# the operators: CUDA implementations (checks, then one launch), plain
# versions on the CPU, and the output's shape and dtype for fake tensors
# --------------------------------------------------------------------------

_SCHEMA = ("(Tensor q, Tensor k, Tensor v, Tensor kv_positions, "
           "Tensor q_position, *, int sliding_window=0) -> Tensor")
_PAGED_SCHEMA = ("(Tensor q, Tensor k_pool, Tensor v_pool, "
                 "Tensor block_tables, Tensor q_position, *, "
                 "int sliding_window=0, int ring_blocks=0) -> Tensor")
_Q8_SCHEMA = ("(Tensor q, Tensor k_pool, Tensor v_pool, Tensor k_scale, "
              "Tensor v_scale, Tensor block_tables, Tensor q_position, *, "
              "int sliding_window=0, int ring_blocks=0) -> Tensor")


def _fake(q, *args, **kw):
    return torch.empty_like(q)


def _fake_states(q, *args, **kw):
    return _state_buffers(q)


def _bhsd_cuda(q, k, v, kv_positions, q_position, *, sliding_window=0,
               states=False):
    name = "decode_attention_bhsd"
    B, Hkv, G, D = q.shape
    S = k.shape[2]
    if tuple(k.shape) != (B, Hkv, S, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, Hkv, S, D) = "
                         f"{(B, Hkv, S, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _launch(name, q, k, v, kv_positions, q_position,
                   q_strides=(Hkv * G * D, G * D),
                   k_strides=(Hkv * S * D, S * D, D),
                   Hkv=Hkv, G=G, S=S, sliding_window=sliding_window,
                   states=states)


def _bshd_cuda(q, k, v, kv_positions, q_position, *, sliding_window=0):
    name = "decode_attention_bhsd"
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, Hkv, D) or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must be (B, S, Hkv, D) = "
                         f"{(B, S, Hkv, D)}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return _launch(name, q, k, v, kv_positions, q_position,
                   q_strides=(Hkv * G * D, G * D),
                   k_strides=(S * Hkv * D, D, Hkv * D),
                   Hkv=Hkv, G=G, S=S, sliding_window=sliding_window)


def _bshd_plain(q, k, v, kv_positions, q_position, *, sliding_window=0):
    return ref_decode_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                                kv_positions, q_position,
                                sliding_window=sliding_window)


def _merged_cuda(u, k, v, kv_positions, q_position, *, sliding_window=0,
                 states=False):
    name = "decode_attention_merged_bsd"
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
                   Hkv=Hkv, G=G, S=S, sliding_window=sliding_window,
                   states=states)


def _paged_cuda(name, grouped, states=False):
    """The CUDA implementation of a paged operator: ``grouped`` queries
    are (B, Hkv, G, D), the others the stream viewed (B, Hq, D); with
    scales (``q8``) the pools are int8; ``states``: the partial-state
    mode."""
    def run(q, k_pool, v_pool, *rest, sliding_window=0, ring_blocks=0):
        *scales, block_tables, q_position = rest
        if grouped:
            B, Hkv, G, D = q.shape
            q_strides = (Hkv * G * D, G * D)
        else:
            B, Hq, D = q.shape
            Hkv = k_pool.shape[2]
            if Hq % Hkv:
                raise ValueError(f"{name}: {Hq} query heads over {Hkv} kv "
                                 "heads")
            G = Hq // Hkv
            q_strides = (Hq * D, G * D)
        return _launch_paged(name, q, k_pool, v_pool, block_tables,
                             q_position, q_strides=q_strides, Hkv=Hkv, G=G,
                             sliding_window=sliding_window,
                             ring_blocks=ring_blocks, scales=tuple(scales),
                             states=states)
    return run


_OPS = {
    "decode_attention_bhsd": _build.define_op(
        "decode_attention_bhsd", _SCHEMA, cpu=ref_decode_attention,
        cuda=_bhsd_cuda, fake=_fake),
    "decode_attention_bshd": _build.define_op(
        "decode_attention_bshd", _SCHEMA, cpu=_bshd_plain, cuda=_bshd_cuda,
        fake=_fake),
    "decode_attention_merged_bsd": _build.define_op(
        "decode_attention_merged_bsd", _SCHEMA,
        cpu=ref_decode_attention_merged, cuda=_merged_cuda, fake=_fake),
    "decode_attention_paged_bhsd": _build.define_op(
        "decode_attention_paged_bhsd", _PAGED_SCHEMA,
        cpu=ref_decode_attention_paged,
        cuda=_paged_cuda("decode_attention_paged_bhsd", True), fake=_fake),
    "decode_attention_paged_merged_bsd": _build.define_op(
        "decode_attention_paged_merged_bsd", _PAGED_SCHEMA,
        cpu=ref_decode_attention_paged_merged,
        cuda=_paged_cuda("decode_attention_paged_merged_bsd", False),
        fake=_fake),
    "decode_attention_paged_q8_bhsd": _build.define_op(
        "decode_attention_paged_q8_bhsd", _Q8_SCHEMA,
        cpu=ref_decode_attention_paged_q8,
        cuda=_paged_cuda("decode_attention_paged_q8_bhsd", True),
        fake=_fake),
    "decode_attention_paged_q8_merged_bsd": _build.define_op(
        "decode_attention_paged_q8_merged_bsd", _Q8_SCHEMA,
        cpu=ref_decode_attention_paged_q8_merged,
        cuda=_paged_cuda("decode_attention_paged_q8_merged_bsd", False),
        fake=_fake),
}

# the partial-state twins: (name, plain version, CUDA implementation);
# each counts its launches under the twin's name
_STATES_SCHEMA = {"": _SCHEMA, "paged": _PAGED_SCHEMA, "q8": _Q8_SCHEMA}
for _name, _schema, _plain, _cuda in (
        ("decode_attention_bhsd", "", ref_decode_states,
         lambda *a, **k: _bhsd_cuda(*a, states=True, **k)),
        ("decode_attention_merged_bsd", "", ref_decode_states_merged,
         lambda *a, **k: _merged_cuda(*a, states=True, **k)),
        ("decode_attention_paged_bhsd", "paged", ref_decode_states_paged,
         _paged_cuda("decode_attention_paged_bhsd", True, True)),
        ("decode_attention_paged_merged_bsd", "paged",
         ref_decode_states_paged_merged,
         _paged_cuda("decode_attention_paged_merged_bsd", False, True)),
        ("decode_attention_paged_q8_bhsd", "q8", ref_decode_states_paged_q8,
         _paged_cuda("decode_attention_paged_q8_bhsd", True, True)),
        ("decode_attention_paged_q8_merged_bsd", "q8",
         ref_decode_states_paged_q8_merged,
         _paged_cuda("decode_attention_paged_q8_merged_bsd", False, True))):
    _OPS[_name + "_states"] = _build.define_op(
        _name + "_states", _STATES_SCHEMA[_schema].replace(
            "-> Tensor", "-> (Tensor, Tensor, Tensor)"),
        cpu=_plain, cuda=_cuda, fake=_fake_states)


# --------------------------------------------------------------------------
# the wrappers: the checks in front of each operator
# --------------------------------------------------------------------------

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
    _build.check_call("decode_attention_bhsd", q, k, v, kv_positions,
                      q_position)
    return _OPS["decode_attention_bhsd"](q, k, v, kv_positions, q_position,
                                         sliding_window=int(sliding_window))


def decode_attention_bshd(
    q: torch.Tensor,  # (B, Hkv, G, D) — grouped query heads
    k: torch.Tensor,  # (B, S, Hkv, D) — native (sequence-major) layout
    v: torch.Tensor,  # (B, S, Hkv, D)
    kv_positions: torch.Tensor,  # (B, S) int32; -1 marks empty slots
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Generic decode attention over a sequence-major cache read in place
    -> (B, Hkv, G, D): the ``decode_attention_bhsd`` kernel launched on
    the cache's own strides (no head-major copy), counted under its
    key."""
    _build.check_call("decode_attention_bhsd", q, k, v, kv_positions,
                      q_position)
    return _OPS["decode_attention_bshd"](q, k, v, kv_positions, q_position,
                                         sliding_window=int(sliding_window))


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
    _build.check_call("decode_attention_merged_bsd", u, k, v, kv_positions,
                      q_position)
    return _OPS["decode_attention_merged_bsd"](
        u, k, v, kv_positions, q_position, sliding_window=int(sliding_window))


def decode_attention_paged_bhsd(
    q: torch.Tensor,  # (B, Hkv, G, D) — grouped query heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — physical page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D)
    block_tables: torch.Tensor,  # (B, MB) int32 page ids; -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Generic paged decode attention -> (B, Hkv, G, D).  The pool keeps
    the serving cache's native (…, bs, Hkv, D) page layout."""
    name = "decode_attention_paged_bhsd"
    _build.check_call(name, q, k_pool, v_pool, block_tables, q_position)
    return _OPS[name](q, k_pool, v_pool, block_tables, q_position,
                      sliding_window=int(sliding_window),
                      ring_blocks=int(ring_blocks))


def decode_attention_paged_merged_bsd(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd residual stream viewed as heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) — K* page pool, native layout
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) — V* page pool
    block_tables: torch.Tensor,  # (B, MB) int32 page ids; -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Merged paged decode attention (stream-as-query) -> (B, Hq, D)."""
    name = "decode_attention_paged_merged_bsd"
    _build.check_call(name, u, k_pool, v_pool, block_tables, q_position)
    return _OPS[name](u, k_pool, v_pool, block_tables, q_position,
                      sliding_window=int(sliding_window),
                      ring_blocks=int(ring_blocks))


def decode_attention_paged_q8_bhsd(
    q: torch.Tensor,  # (B, Hkv, G, D) — grouped query heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8
    k_scale: torch.Tensor,  # (NB, Hkv) float32 per-(page, head) scales
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32 page ids; -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Generic paged decode over an int8 pool -> (B, Hkv, G, D) in q's
    dtype."""
    name = "decode_attention_paged_q8_bhsd"
    _build.check_call(name, q, k_pool, v_pool, k_scale, v_scale,
                      block_tables, q_position)
    return _OPS[name](q, k_pool, v_pool, k_scale, v_scale, block_tables,
                      q_position, sliding_window=int(sliding_window),
                      ring_blocks=int(ring_blocks))


def decode_attention_paged_q8_merged_bsd(
    u: torch.Tensor,  # (B, Hq, D) — RoPE'd residual stream viewed as heads
    k_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 K* page pool
    v_pool: torch.Tensor,  # (NB, bs, Hkv, D) int8 V* page pool
    k_scale: torch.Tensor,  # (NB, Hkv) float32 per-(page, head) scales
    v_scale: torch.Tensor,  # (NB, Hkv) float32
    block_tables: torch.Tensor,  # (B, MB) int32 page ids; -1 unmapped
    q_position: torch.Tensor,  # (B,) int32
    *,
    sliding_window: int = 0,
    ring_blocks: int = 0,
) -> torch.Tensor:
    """Merged paged decode over an int8 pool (stream-as-query) ->
    (B, Hq, D) in u's dtype."""
    name = "decode_attention_paged_q8_merged_bsd"
    _build.check_call(name, u, k_pool, v_pool, k_scale, v_scale,
                      block_tables, q_position)
    return _OPS[name](u, k_pool, v_pool, k_scale, v_scale, block_tables,
                      q_position, sliding_window=int(sliding_window),
                      ring_blocks=int(ring_blocks))


def decode_states(name: str, *args, sliding_window: int = 0,
                  ring_blocks: int = 0):
    """The partial-state twin of the wrapper ``name`` (one of the six
    above with a twin, e.g. ``"decode_attention_paged_merged_bsd"``) on
    the same operands: (m, l, o) float32, the softmax state of the keys
    (pages) it is given (``ref_decode_states``).  One launch on the card, counted
    under ``name``; the plain version on the CPU."""
    _build.check_call(name, *args)
    kw = {"sliding_window": int(sliding_window)}
    if "paged" in name:
        kw["ring_blocks"] = int(ring_blocks)
    return _OPS[name + "_states"](*args, **kw)

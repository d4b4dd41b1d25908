"""Running the port's models on placed tensors (DTensors on a device mesh).

The model code is written once, over plain tensors.  Under a mesh the
engines and the trainer hand it DTensors (``sharding.distribute_tree``)
and run it inside ``on_mesh``, where DTensor propagates every op's
sharding and inserts the collectives, as GSPMD does for the reference.
Three seams need more than propagation, and live here:

  * ``put_`` / ``assign_``: the port writes its caches IN PLACE (slice
    assignment, advanced indexing, ``copy_``), and DTensor refuses an
    in-place op that would need its destination redistributed.  Each rank
    writes the part of the update that falls in its own shard instead;
    the (small) update itself is gathered first.
  * ``local_call`` / ``local_tree``: where the mesh's model axis has
    size 1 every rank holds whole heads and whole sequences, so the
    attention cores and the SSD scan run on each rank's local shards (its
    batch rows), through the hand-written kernels on the card, and the
    serving engine runs its decode step and whole-prompt prefill so.  A kernel wrapper never
    sees a DTensor (``kernels.ops`` raises ``TypeError`` for one).
  * ``heads_call`` / ``split_k_call``: where the model axis is larger than
    1, the kernel route (``impl="cuda"``) of the attention cores and the
    SSD scan runs on each rank's local tensors all the same: a prefill,
    a VLM's cross decode and the scan on the rank's query (SSM) heads and
    the kv heads they read (``heads_call``), a decode step over the
    rank's slice of the cache's sequence, whose partial softmax states
    are combined across the model axis (``split_k_call``, then
    ``combine_softmax``).  Neither gathers a cache or a pool.
  * ``reanchor``: the counterpart of the reference's
    ``with_sharding_constraint`` (q/k/v of merged layouts, the training
    stream).
  * the paged pools: their page axis splits over the model axis
    (``sharding.paged_cache_pspecs``), so each rank reads and writes the
    pages it holds on its local tensor (``local_pages``, ``own_pages``),
    a copy-on-write page travels from the rank that holds it
    (``copy_page_``), and attention over the pages is a partial softmax
    state per rank, combined across the model axis by an all-reduce MAX
    then SUM (``combine_softmax``: the reference's "each chip scores the
    pages it owns and XLA combines softmax stats").  Host bookkeeping
    that every rank holds whole (block tables, lengths) is placed by
    keeping each rank's own shard (``place_local``), and a batch split
    over the data axes is gathered back whole with ``row_gather``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def is_placed(x) -> bool:
    return isinstance(x, DTensor)


# implicit replication is one flag of DTensor's dispatcher, process-wide:
# the depth keeps a nested ``on_mesh`` from clearing it on exit
_DEPTH = [0]


@contextlib.contextmanager
def on_mesh(mesh):
    """The context the model runs in under ``mesh``: plain tensors made
    inside (positions, masks) count as replicated.  Re-entrant (an engine
    step inside a scheduler iteration); a null context without a mesh."""
    if mesh is None or _DEPTH[0]:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _DEPTH[0] += 1
    try:
        with implicit_replication():
            yield
    finally:
        _DEPTH[0] -= 1


def full(x):
    """The whole tensor on every rank (a gather of a DTensor's shards)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def model_axis_size(x) -> int:
    """The size of the "model" axis of ``x``'s mesh (1 without one)."""
    if not isinstance(x, DTensor):
        return 1
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index("model"))) if "model" in names else 1


def on_shards(impl: str, *tensors) -> bool:
    """True when an operand is a DTensor on a mesh whose model axis has
    size 1: the attention cores and the SSD scan then run on local shards
    (``local_call``), on either route.  A larger model axis splits heads
    or sequences: the "torch" route runs on the DTensors, which propagate
    the sharding, and the kernels ("cuda") on each rank's heads or slice
    (``model_split``)."""
    placed = [t for t in tensors if isinstance(t, DTensor)]
    return bool(placed) and model_axis_size(placed[0]) == 1


def model_split(impl: str, *tensors) -> bool:
    """True for the kernel route (``impl="cuda"``) when an operand is a
    DTensor on a mesh whose model axis is larger than 1: the cores then
    run the kernels through ``heads_call`` or ``split_k_call``."""
    placed = [t for t in tensors if isinstance(t, DTensor)]
    return impl == "cuda" and bool(placed) and \
        model_axis_size(placed[0]) > 1


def shard_box(dst: DTensor):
    """(offset, size) of this rank's shard of ``dst`` in every dim."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, offset = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    return list(zip(offset, shape))


def put_(dst, index, value) -> None:
    """``dst[index] = value`` in place, for a plain tensor or a DTensor.

    ``index`` is a tuple of ints, step-1 slices and 1-D index tensors; the
    index tensors come first (so the indexed result keeps numpy's layout:
    the indexed entries, then the sliced and trailing dims).  On a DTensor
    every rank writes the entries that fall in its own shard."""
    index = index if isinstance(index, tuple) else (index,)
    if not isinstance(dst, DTensor):
        dst[index] = full(value)
        return
    # gather first, on every rank: a rank that owns none of the update
    # still takes part in the collectives
    index = tuple(full(i) if torch.is_tensor(i) else i for i in index)
    value = full(value)
    n_adv = 0
    while n_adv < len(index) and torch.is_tensor(index[n_adv]):
        n_adv += 1
    if any(torch.is_tensor(i) for i in index[n_adv:]):
        raise ValueError("put_: index tensors must lead the index")
    local = dst.to_local()
    box = shard_box(dst)
    # the indexed result's shape, then the value broadcast to it
    out_dims = []  # (dim of dst, global start) per result dim after adv
    rshape = []
    if n_adv:
        n = torch.broadcast_shapes(*(i.shape for i in index[:n_adv]))
        rshape += list(n)
    loc_index = []
    mask = None
    for d in range(dst.ndim):
        lo, size = box[d]
        hi = lo + size
        i = index[d] if d < len(index) else slice(None)
        if d < n_adv:
            t = i.to(local.device).long()
            ok = (t >= lo) & (t < hi)
            mask = ok if mask is None else mask & ok
            loc_index.append(t - lo)
        elif isinstance(i, int):
            if not lo <= i < hi:
                return  # not this rank's shard
            loc_index.append(i - lo)
        else:
            start, stop, step = i.indices(dst.shape[d])
            if step != 1:
                raise ValueError("put_: slices must have step 1")
            a, b = max(start, lo), min(stop, hi)
            if b <= a:
                return  # the slice misses this rank's shard
            rshape.append(stop - start)
            out_dims.append((a - start, b - a))
            loc_index.append(slice(a - lo, b - lo))
    value = torch.as_tensor(value, device=local.device)
    value = value.to(local.dtype).expand(rshape)
    for k, (off, n) in enumerate(out_dims):
        value = value.narrow((1 if n_adv else 0) + k, off, n)
    if n_adv:
        keep = torch.nonzero(mask.reshape(-1)).flatten()
        if keep.numel() == 0:
            return
        idx = [t.expand(mask.shape).reshape(-1)[keep]
               for t in loc_index[:n_adv]]
        value = value.reshape((-1,) + tuple(value.shape[len(mask.shape):]))
        local[tuple(idx) + tuple(loc_index[n_adv:])] = value[keep]
    else:
        local[tuple(loc_index)] = value


def assign_(dst, src) -> None:
    """``dst.copy_(src)`` for a plain tensor or a DTensor (``src`` is
    redistributed to ``dst``'s placements first)."""
    if not isinstance(dst, DTensor):
        dst.copy_(full(src))
        return
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src.to(dst.device), dst.device_mesh,
                                 [Replicate()] * dst.device_mesh.ndim,
                                 run_check=False)
    src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def reanchor(x, spec):
    """Redistribute a DTensor to ``spec`` (after ``sharding.evenly``): the
    counterpart of ``with_sharding_constraint``.  Plain tensors and a None
    spec pass through."""
    if spec is None or not isinstance(x, DTensor):
        return x
    from repro_torch.distribution import sharding as shd

    mesh = x.device_mesh
    spec = shd.evenly(spec, x, mesh)
    return x.redistribute(mesh, shd.placements(spec, mesh))


def local_tree(tree):
    """Each DTensor of a tree (dicts, NamedTuples) as this rank's local
    tensor (no copy); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(local_tree, tree))
    return tree.to_local() if isinstance(tree, DTensor) else tree


def whole_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank: a DTensor split there is
    gathered along it and a pending sum is reduced; splits of other dims
    stay."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    want = [Replicate() if p == Shard(dim) or p.is_partial() else p
            for p in x.placements]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def local_call(fn: Callable, batch: Sequence[Any], other: Sequence[Any] = (),
               **kw):
    """``fn(*batch, *other, **kw)`` on this rank's local shards, when any
    operand is a DTensor on a mesh whose model axis has size 1; otherwise
    ``fn`` as it is.  ``batch`` are the operands whose dim 0 is the batch:
    each goes to the batch placement (dim 0 over every mesh dim of size >
    1 on which one of them is already split on dim 0, replicated on the
    others), so every rank sees matching rows; ``other`` operands (a page
    pool, per-head constants) go as they lie.  The output is placed back
    with the batch placement.  Size-1 mesh dims are never redistributed:
    their local shard is the whole dim."""
    ops = list(batch) + list(other)
    placed = [t for t in ops if isinstance(t, DTensor)]
    if not placed:
        return fn(*ops, **kw)
    mesh = placed[0].device_mesh
    if model_axis_size(placed[0]) > 1:
        raise ValueError("local_call: the model axis splits heads or "
                         "sequences; run heads_call or split_k_call there")
    sizes = [int(s) for s in mesh.shape]
    dp = _batch_dims(mesh, batch)

    def local(t, is_batch):
        if t is None or not torch.is_tensor(t):
            return t
        if not isinstance(t, DTensor):
            if not is_batch or not dp:
                return t
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if is_batch:
            want = [Shard(0) if d in dp else
                    (t.placements[d] if sizes[d] == 1 else Replicate())
                    for d in range(mesh.ndim)]
            if list(t.placements) != want:
                t = t.redistribute(mesh, want)
        return t.to_local()

    args = [local(t, True) for t in batch] + [local(t, False) for t in other]
    out = fn(*args, **kw)
    place = [Shard(0) if d in dp else Replicate() for d in range(mesh.ndim)]

    def wrap(o):
        if not torch.is_tensor(o):
            return o
        return DTensor.from_local(o, mesh, place, run_check=False)

    if isinstance(out, tuple):
        return type(out)(*map(wrap, out)) if hasattr(out, "_fields") \
            else tuple(map(wrap, out))
    return wrap(out)


def _batch_dims(mesh, batch, skip=None):
    """The mesh dims of size > 1 (but ``skip``) on which one of the
    ``batch`` operands is split on its dim 0: the batch rows each rank
    takes."""
    return [d for d in range(mesh.ndim) if d != skip and mesh.size(d) > 1
            and any(isinstance(t, DTensor) and t.placements[d] == Shard(0)
                    for t in batch)]


def _model_dim(mesh) -> int:
    return list(mesh.mesh_dim_names).index("model")


def _as_placed(t, mesh):
    """A plain tensor (made inside ``on_mesh``) as the replicated DTensor
    it counts as."""
    if t is None or isinstance(t, DTensor) or not torch.is_tensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _wrap(out, mesh, place):
    """A function's local output(s) as DTensors with ``place`` (one
    placement list, or one per output of a tuple)."""
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, p, run_check=False)
                     for o, p in zip(out, place))
    return DTensor.from_local(out, mesh, place, run_check=False)


def heads_call(fn: Callable, operands: Sequence, out_heads, *,
               n_heads: int, group: int = 1):
    """``fn`` on this rank's local tensors where the mesh's model axis (of
    size m > 1) splits heads: rank r takes query (or SSM) heads
    [r n, (r + 1) n), n = ``n_heads`` / m, and the kv heads they read
    (head h reads kv head h // ``group``).

    ``operands``: (tensor, batch, head dim, kv) each: ``batch`` says its
    dim 0 is the batch (taken per data rank, as ``local_call`` does), the
    head dim is None for an operand without heads (positions), and ``kv``
    says the dim counts kv heads.  An operand that the model axis splits
    on its head dim at the rank's range is taken as it lies; one it keeps
    whole (``sharding.evenly``: kv heads that the axis does not divide) is
    replicated and sliced.  Where the axis does not divide the query
    heads, or a rank's heads would read part of a kv head's group and part
    of another's, every rank runs ``fn`` on whole heads.  ``out_heads``:
    each output's head dim (an int, or one per output of a tuple); the
    outputs are placed split there over the model axis (whole, where the
    heads are), and over the data axes on their batch dim."""
    placed = [t for t, *_ in operands if isinstance(t, DTensor)]
    mesh = placed[0].device_mesh
    md = _model_dim(mesh)
    m, r = mesh.size(md), mesh.get_local_rank(md)
    n = n_heads // m
    split = n_heads % m == 0 and (n % group == 0 or group % n == 0)
    dp = _batch_dims(mesh, [t for t, batch, *_ in operands if batch], md)

    def local(t, batch, hdim, kv):
        t = _as_placed(t, mesh)
        if not isinstance(t, DTensor):
            return t
        count = n_heads // group if kv else n_heads
        lo, hi = (r * n // group, (r * n + n - 1) // group + 1) if kv \
            else (r * n, r * n + n)
        heads = split and hdim is not None
        sharded = heads and count % m == 0  # the rank's range is its shard
        want = [(Shard(hdim) if sharded else Replicate()) if d == md else
                Shard(0) if batch and d in dp else
                t.placements[d] if mesh.size(d) == 1 else Replicate()
                for d in range(mesh.ndim)]
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        x = t.to_local()
        return x.narrow(hdim, lo, hi - lo) if heads and not sharded else x

    out = fn(*[local(*o) for o in operands])

    def place(hdim):
        return [(Shard(hdim) if split else Replicate()) if d == md else
                Shard(0) if d in dp else Replicate()
                for d in range(mesh.ndim)]

    return _wrap(out, mesh, [place(h) for h in out_heads]
                 if isinstance(out_heads, (tuple, list)) else
                 place(out_heads))


def split_k_call(states_fn: Callable, whole_fn: Callable, q, kv, batch,
                 out_dtype):
    """A decode step's attention where the model axis may split the
    sequence of the cache: ``q`` (its heads gathered whole: a small
    (B, Hq, D) or (B, d)), ``kv`` the cache operands whose dim 1 is the
    sequence (k, v, their positions), ``batch`` the other per-row operands
    (the query positions).  Each rank runs ``states_fn(q, *kv, *batch)``
    on its batch rows and its slice of the sequence, a partial softmax
    state (m, l, o), and the states are combined across the model axis
    (``combine_softmax``) into ``q``'s shape in ``out_dtype``; the cache
    is read where it lies.  Where no mesh dim splits the sequence
    (``sharding.evenly`` keeps it whole), ``whole_fn`` runs on the local
    tensors instead.  The output is placed over the data axes on its
    batch dim, replicated over the rest."""
    mesh = next(t for t in (q, *kv) if isinstance(t, DTensor)).device_mesh
    dp = _batch_dims(mesh, (q, *kv, *batch))
    seq = [d for d in range(mesh.ndim) if mesh.size(d) > 1 and
           isinstance(kv[0], DTensor) and kv[0].placements[d] == Shard(1)]
    if len(seq) > 1:
        raise ValueError("split_k_call: the sequence splits over one mesh "
                         f"dim, got {kv[0].placements}")
    group = mesh.get_group(seq[0]) if seq else None

    def local(t, keep_seq):
        t = _as_placed(t, mesh)
        if not isinstance(t, DTensor):
            return t
        want = [Shard(0) if d in dp else
                Shard(1) if keep_seq and d in seq else Replicate()
                for d in range(mesh.ndim)]
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()

    ql = local(q, False)
    args = [ql] + [local(t, True) for t in kv] + \
        [local(t, False) for t in batch]
    if group is None:
        out = whole_fn(*args)
    else:
        out = combine_softmax(*states_fn(*args), group=group)
        out = out.to(out_dtype).reshape(ql.shape)
    place = [Shard(0) if d in dp else Replicate() for d in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, place, run_check=False)


# ---------------------------------------------------------------------------
# paged pools on a mesh
# ---------------------------------------------------------------------------

def local_pages(pool, dim: int = 1):
    """(this rank's tensor, its first page, its page count) of a page pool
    or its scales, whose dim ``dim`` counts pages: a plain tensor is all
    its own; a DTensor's rank holds the pages of its shard of that dim
    (all of them where no mesh dim splits it)."""
    if not isinstance(pool, DTensor):
        return pool, 0, int(pool.shape[dim])
    lo, n = shard_box(pool)[dim]
    return pool.to_local(), int(lo), int(n)


def own_pages(ids, lo: int, n: int):
    """Global page ids -> this rank's indices: ``ids - lo`` where the rank
    holds the page (``lo <= id < lo + n``), -1 elsewhere and where ``ids``
    is -1."""
    return torch.where((ids >= lo) & (ids < lo + n), ids - lo, -1)


def split_group(x, dim: int):
    """The process group of the mesh dim that splits dim ``dim`` of ``x``
    (None for a plain tensor or where no mesh dim of size > 1 splits
    it)."""
    if not isinstance(x, DTensor):
        return None
    for d, p in enumerate(x.placements):
        if p.is_shard(dim % x.ndim) and x.device_mesh.size(d) > 1:
            return x.device_mesh.get_group(d)
    return None


def combine_softmax(m, l, o, group=None):
    """Attention from partial softmax states over disjoint key ranges:
    ``m`` (...) a range's running max of the scores, ``l`` (...) its sum of
    exp(score - m) and ``o`` (..., D) its unnormalised sum of
    exp(score - m) v, float32.  Without ``group`` the ranges are stacked on
    a leading dim; with one (the model axis's process group) each rank
    holds its own range, and the states are all-reduced, MAX then SUM.
    Returns (..., D) float32: sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r,
    M the max over ranges.  A range with nothing to attend to (every
    score at the -1e30 mask) weighs e^(-1e30 - M) = 0 beside one that has
    a real score; where no range has one and every l is 0 (the decode
    kernel's states of an idle row: m at the mask, l = 0, o = 0) the
    result is 0, as the unsplit kernel writes, not 0/0."""
    if group is None:
        top = m.amax(0)
        w = torch.exp(m - top)
        return _normalised((o * w[..., None]).sum(0), (l * w).sum(0))
    import torch.distributed as dist

    top = m.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(m - top)
    both = torch.cat([(o * w[..., None]).reshape(-1), (l * w).reshape(-1)])
    dist.all_reduce(both, group=group)
    n = o.numel()
    return _normalised(both[:n].view(o.shape), both[n:].view(l.shape))


def _normalised(o, l):
    return o / torch.where(l == 0, 1.0, l)[..., None]


def copy_page_(pool, src: int, dst: int) -> None:
    """``pool[:, dst] = pool[:, src]`` in place, for a plain page pool (or
    its scales) or a DTensor whose dim 1, the page axis, may be split over
    the model axis.  Where one shard holds both pages (always, where
    nothing splits the pages) the rank that holds them copies and the
    others have nothing to do; otherwise the page travels from the rank
    that holds ``src`` to the one that holds ``dst`` by a broadcast over
    the mesh dim that splits the pages, device to device.  Every rank of
    that group runs the same host bookkeeping, so all of them take the
    same branch (the shards are equal: ``sharding.evenly``)."""
    local, lo, n = local_pages(pool)
    if src // n == dst // n:
        if lo <= src < lo + n:
            local[:, dst - lo].copy_(local[:, src - lo])
        return
    import torch.distributed as dist

    group = split_group(pool, 1)
    has_src = lo <= src < lo + n
    buf = local[:, src - lo].contiguous() if has_src \
        else torch.empty_like(local[:, 0])
    dist.broadcast(buf, src=dist.get_global_rank(group, src // n),
                   group=group)
    if lo <= dst < lo + n:
        local[:, dst - lo].copy_(buf)


def place_local(x, mesh, placements):
    """A tensor that every rank holds whole and equal (host bookkeeping
    copied to the device) as a DTensor with ``placements``: each rank keeps
    its own shard, so no collective runs."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, offset = compute_local_shape_and_global_offset(
        x.shape, mesh, placements)
    local = x[tuple(slice(o, o + s) for o, s in zip(offset, shape))]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def row_gather(like) -> Optional[Callable]:
    """For a batch laid out like the DTensor ``like`` (its dim 0 split
    over some mesh dims): a function taking this rank's rows of a plain
    tensor to the whole batch, an all-gather over those dims.  None where
    every rank holds the whole batch (a plain ``like`` too)."""
    if not isinstance(like, DTensor):
        return None
    mesh = like.device_mesh
    place = [Shard(0) if p.is_shard(0) and mesh.size(d) > 1 else Replicate()
             for d, p in enumerate(like.placements)]
    if all(p == Replicate() for p in place):
        return None
    return lambda x: DTensor.from_local(x, mesh, place,
                                        run_check=False).full_tensor()

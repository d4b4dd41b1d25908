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
  * ``reanchor``: the counterpart of the reference's
    ``with_sharding_constraint`` (q/k/v of merged layouts, the training
    stream).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Sequence

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
    (``local_call``).  A larger model axis splits heads or sequences: the
    kernels ("cuda") raise ValueError there, and the "torch" route runs on
    the DTensors, which propagate the sharding."""
    placed = [t for t in tensors if isinstance(t, DTensor)]
    if not placed:
        return False
    if model_axis_size(placed[0]) > 1:
        if impl == "cuda":
            raise ValueError("impl='cuda' under a mesh whose model axis is "
                             "larger than 1: the kernels take whole heads "
                             "and sequences; serve with impl='torch'")
        return False
    return True


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
            rshape.append(stop - start)
            out_dims.append((a - start, max(b - a, 0)))
            loc_index.append(slice(a - lo, max(b, a) - lo))
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
                         "sequences; only DTensor propagation runs there")
    sizes = [int(s) for s in mesh.shape]
    dp = [d for d in range(mesh.ndim) if sizes[d] > 1 and any(
        isinstance(t, DTensor) and t.placements[d] == Shard(0)
        for t in batch)]

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

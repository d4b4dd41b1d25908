"""Logical-axis sharding rules -> partition specs for every tree the port
places on a device mesh: the counterpart of ``repro.distribution.sharding``.

Parallelism mapping (as in the reference):
  * DP  — batch over ("pod", "data") (multi-pod) or ("data",); a batch
    smaller than the DP size drops the axis (replicates) instead of
    padding it.
  * TP  — heads / kv-heads / d_ff / vocab / ssm-rows over "model".
  * EP  — the MoE expert axis over "model".

A spec is a ``P``: a tuple with one entry per leading dim of its leaf,
each ``None`` (replicated), an axis name or a tuple of axis names (the
shape of ``jax.sharding.PartitionSpec``).  Rules are path-based over the
nested-dict parameter tree: ``_param_spec`` matches the TRAILING dims of
each leaf by (parent key, name); leading stack axes (layers / groups) are
never sharded.  Merged (Q/P-removed) trees use the same table: wq/wp do
not exist, K*/V* keep the head sharding of the K/V they were rewritten
from.  Under a mesh the serving steps re-anchor q/k/v to the
``(dp, None, heads, None)`` placement (``qkv_pspec``), as the reference
does with ``with_sharding_constraint``.

Uneven shardings (40 heads over 16 chips) are never placed: ``evenly``
replicates any dim its mesh axes do not divide (the reference's jit
rejects uneven argument shardings; DTensor would pad the last rank), and
``check_divisibility`` lists them, so the waste is visible.

A mesh here is either a ``torch.distributed.device_mesh.DeviceMesh`` or a
shape-only ``launch.mesh.MeshShape`` (axis names -> sizes): the dry run's
256- and 512-way meshes exist only as shapes.  The torch side
(``placements``, ``distribute_tree``) needs a real ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple



class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, for a ``DeviceMesh`` or a ``MeshShape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` or a ``MeshShape``."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(s) for s in shape)))


def _size(sizes: Dict[str, int], ax) -> int:
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    if "+".join(axes) in sizes:  # a flattened pair (``torch_mesh``)
        return sizes["+".join(axes)]
    return math.prod(sizes[a] for a in axes)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical axis -> mesh axes (None = replicate)."""
    dp: Optional[Tuple[str, ...]] = ("data",)  # batch
    tp: Optional[str] = "model"  # heads/ffn/vocab/experts
    # overrides re-map specific logical dims:
    vocab: Optional[str] = "use_tp"
    heads: Optional[str] = "use_tp"
    ffn: Optional[str] = "use_tp"
    experts: Optional[str] = "use_tp"

    def axis(self, name: str):
        v = getattr(self, name)
        return self.tp if v == "use_tp" else v


def make_rules(mesh, *, batch: int = 0, **kw) -> ShardingRules:
    """Default rules for a mesh; drops DP when the batch can't use it."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    dp_axes = tuple(a for a in ("pod", "data") if a in names)
    dp_size = math.prod(sizes[a] for a in dp_axes) if dp_axes else 1
    if batch and batch < dp_size:
        dp_axes = None  # replicate tiny batches (e.g. long_500k batch=1)
    return ShardingRules(dp=dp_axes, tp="model" if "model" in names else None,
                         **kw)


# ---------------------------------------------------------------------------
# parameter specs (path-based)
# ---------------------------------------------------------------------------

def _param_spec(path: Tuple[str, ...], ndim: int, rules: ShardingRules) -> P:
    """Spec for one param; trailing-dim rules, leading stack dims -> None."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    tp = rules.axis
    table = {
        # (parent, name): trailing spec
        ("embed", "table"): (tp("vocab"), None),
        ("unembed", "table"): (tp("vocab"), None),
        ("attn", "wq"): (None, tp("heads")),
        ("attn", "wk"): (None, tp("heads")),
        ("attn", "wv"): (None, tp("heads")),
        ("attn", "wp"): (tp("heads"), None),
        ("attn", "bq"): (tp("heads"),),
        ("attn", "bk"): (tp("heads"),),
        ("attn", "bv"): (tp("heads"),),
        ("ffn", "w_gate"): (None, tp("ffn")),
        ("ffn", "w_up"): (None, tp("ffn")),
        ("ffn", "w_down"): (tp("ffn"), None),
        ("ffn", "w_in"): (None, tp("ffn")),
        ("ffn", "w_out"): (tp("ffn"), None),
        ("moe", "router"): (None, None),
        ("moe", "w_gate"): (tp("experts"), None, None),
        ("moe", "w_up"): (tp("experts"), None, None),
        ("moe", "w_down"): (tp("experts"), None, None),
        # merged-only leaves (Q/P-removed trees, core/merge.py)
        ("", "input_proj"): (None, tp("heads")),  # audio T_0: columns = q heads
        ("", "embed_bias"): (None,),  # stream-basis biases stay replicated
        ("", "b_out"): (None,),
        ("layers", "b_out"): (None,),
        ("ssm", "in_proj"): (tp("ffn"), None),  # row (d_model) sharded
        ("ssm", "out_proj"): (tp("ffn"), None),  # row (d_inner) sharded
        ("ssm", "conv_kernel"): (None, None),
        ("ssm", "conv_bias"): (None,),
        ("ssm", "A_log"): (None,),
        ("ssm", "D"): (None,),
        ("ssm", "dt_bias"): (None,),
    }
    trailing = table.get((parent, name))
    if trailing is None:
        # norms, biases, conv_pos, … -> replicate
        trailing = tuple(None for _ in range(ndim))
    pad = ndim - len(trailing)
    return P(*((None,) * pad + tuple(trailing)))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict; ``path`` is the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params_shape, rules: ShardingRules):
    """Spec tree matching a params (or meta-shape) tree."""
    return _map_with_path(
        lambda path, leaf: _param_spec(path, len(leaf.shape), rules),
        params_shape)


# ---------------------------------------------------------------------------
# activation / input / cache specs
# ---------------------------------------------------------------------------

def batch_pspec(rules: ShardingRules, extra_dims: int = 1) -> P:
    return P(rules.dp, *([None] * extra_dims))


def qkv_pspec(rules: ShardingRules) -> P:
    """(B, S, heads, Dh) q/k/v under a mesh: batch over DP, heads over TP."""
    return P(rules.dp, None, rules.axis("heads"), None)


def heads_split(n_kv_heads: int, m: int) -> bool:
    """Whether a model axis of size ``m`` splits the attention heads of a
    placed step: only where it divides the kv heads (it then divides the
    query heads, a multiple of them).  Elsewhere q, k and v are whole on
    every rank of the axis: a DTensor cannot reshape a projection split
    inside a head (or a kv head's query group) into heads, so the
    projection's column shards are gathered before the reshape
    (``placed.head_layout``); its matmul stays split."""
    return n_kv_heads % m == 0


def stream_pspec(rules: ShardingRules) -> P:
    """(B, S, d) residual stream, sequence-parallel over TP (training)."""
    return P(rules.dp, rules.tp, None)


def input_pspecs(cfg, kind: str, rules: ShardingRules) -> Dict[str, P]:
    """Specs for the input dict of train/prefill/decode steps."""
    dp = rules.dp
    if kind in ("train", "prefill"):
        specs = {"inputs": P(dp, None)}
        if kind == "train":
            specs["labels"] = P(dp, None)
        if cfg.family == "audio":
            specs["inputs"] = P(dp, None, None)
        if cfg.family == "vlm":
            specs["vision"] = P(dp, None, None)
        return specs
    if kind == "decode":
        return {"token": P(dp)}
    raise ValueError(kind)


def cache_pspecs(cfg, rules: ShardingRules):
    """Specs for a ``DecodeCache`` (structure mirrors the NamedTuple).

    KV caches are SEQUENCE-sharded over the model axis (a flash-decoding
    split-K: every rank scores its cache slice, the softmax stats are
    combined) because GQA kv-head counts rarely divide a 16-way TP axis
    while cache lengths do.  SSM state shards over heads when divisible
    (``evenly`` downgrades it otherwise)."""
    from repro_torch.models import mamba2 as m2
    from repro_torch.models.transformer import DecodeCache

    dp, tp = rules.dp, rules.axis("heads")
    kv = P(None, dp, tp, None, None)
    return DecodeCache(
        k=kv, v=kv,
        kv_pos=P(dp, tp),
        length=P(dp),
        ssm=m2.SSMState(ssm=P(None, dp, tp, None, None),
                        conv=P(None, dp, None, None)),
        cross_k=P(None, dp, None, tp, None),  # vision tokens: head-sharded
        cross_v=P(None, dp, None, tp, None),
    )


def paged_cache_pspecs(cfg, rules: ShardingRules):
    """Specs for a ``PagedDecodeCache``: the pools' PHYSICAL-BLOCK axis over
    the model axis (the paged analogue of the dense sequence split); block
    tables and lengths batch-sharded."""
    from repro_torch.models.transformer import PagedDecodeCache

    dp, tp = rules.dp, rules.axis("heads")
    pool = P(None, tp, None, None, None)
    return PagedDecodeCache(k=pool, v=pool, block_tables=P(dp, None),
                            length=P(dp))


def paged_q8_cache_pspecs(cfg, rules: ShardingRules):
    """Specs for a ``PagedQ8DecodeCache``: int8 pools like the fp pools,
    and the (L, NB, Hkv) scales split on the same block axis, so a page's
    scale rows live with the page."""
    from repro_torch.models.transformer import PagedQ8DecodeCache

    dp, tp = rules.dp, rules.axis("heads")
    pool = P(None, tp, None, None, None)
    scale = P(None, tp, None)
    return PagedQ8DecodeCache(k=pool, v=pool, k_scale=scale, v_scale=scale,
                              block_tables=P(dp, None), length=P(dp))


def serving_cache_pspecs(cfg, rules: ShardingRules, cache_like):
    """Specs for whichever serving cache ``cache_like`` is, TRIMMED to the
    fields that exist: a dense cache's absent (None) fields get None."""
    from repro_torch.models.transformer import (DecodeCache, PagedDecodeCache,
                                                PagedQ8DecodeCache)

    if isinstance(cache_like, PagedQ8DecodeCache):
        return paged_q8_cache_pspecs(cfg, rules)
    if isinstance(cache_like, PagedDecodeCache):
        return paged_cache_pspecs(cfg, rules)
    spec = cache_pspecs(cfg, rules)
    return DecodeCache(*[
        None if getattr(cache_like, f) is None else getattr(spec, f)
        for f in DecodeCache._fields])


def logits_pspec(rules: ShardingRules, seq_dim: bool = True) -> P:
    if seq_dim:
        return P(rules.dp, None, rules.axis("vocab"))
    return P(rules.dp, rules.axis("vocab"))


# ---------------------------------------------------------------------------
# mesh-aware downgrade: placed shardings must divide evenly
# ---------------------------------------------------------------------------

def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, P)


def _map_specs(fn, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a spec tree (dicts, NamedTuples; a ``P``
    or None is a leaf) and trees of the same structure."""
    if _is_spec_leaf(spec_tree):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple):  # NamedTuple caches / optimizer states
        return type(spec_tree)(*[
            _map_specs(fn, v, *(None if r is None else r[i] for r in rest))
            for i, v in enumerate(spec_tree)])
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def evenly(pspec_tree, shape_tree, mesh):
    """Replace any spec axis whose dim doesn't divide the mesh axes with
    None (replicate).  Every placed tree passes through this, so a
    downgrade is what ``check_divisibility`` reports, never a padded
    shard."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        if spec is None or leaf is None:
            return spec
        dims = tuple(leaf.shape)
        parts = []
        for d, ax in enumerate(tuple(spec) + (None,) * (len(dims) - len(spec))):
            if ax is None:
                parts.append(None)
                continue
            parts.append(ax if dims[d] % _size(sizes, ax) == 0 else None)
        return P(*parts)

    return _map_specs(fix, pspec_tree, shape_tree)


def check_divisibility(params_shape, mesh, rules: ShardingRules):
    """A list of (path, dim, size, axis_size) uneven shardings."""
    sizes = axis_sizes(mesh)
    uneven = []

    def visit(path, leaf):
        spec = _param_spec(path, len(leaf.shape), rules)
        for d, ax in enumerate(spec):
            if ax is None:
                continue
            size = _size(sizes, ax)
            if leaf.shape[d] % size:
                uneven.append(("/".join(path), d, leaf.shape[d], size))

    _map_with_path(visit, params_shape)
    return uneven


# ---------------------------------------------------------------------------
# optimizer-state specs
# ---------------------------------------------------------------------------

def opt_pspecs(opt_state, param_pspec, mesh=None, zero1: bool = False,
               dp_axes=None):
    """Optimizer-state specs: the moments follow the params; the step
    replicates.  ``zero1=True`` also shards each moment over the data axes
    on its first unsharded dim (ZeRO-1)."""

    def moment(spec, leaf):
        if zero1 and dp_axes:
            parts = list(tuple(spec) + (None,) * (leaf.ndim - len(spec)))
            for d in range(leaf.ndim):
                if parts[d] is None:
                    parts[d] = dp_axes
                    break
            return P(*parts)
        return spec

    fields = {f: getattr(opt_state, f) for f in opt_state._fields}
    out = {}
    for f, tree in fields.items():
        if f == "step":
            out[f] = P()
        else:
            out[f] = _map_specs(lambda s, leaf: moment(s, leaf),
                                param_pspec, tree)
    return type(opt_state)(**out)


# ---------------------------------------------------------------------------
# the torch side: placements and placed trees on a DeviceMesh
# ---------------------------------------------------------------------------

_FLAT: Dict[int, Any] = {}


def torch_mesh(mesh):
    """The ``DeviceMesh`` DTensors live on for ``mesh``: the mesh itself,
    or, for a multi-pod mesh, one whose "pod" and "data" dims are
    flattened into one "pod+data" dim over the same ranks.  Every spec
    names the two together (the batch over ("pod", "data")), so the
    layout is the same; DTensor plans its ops and collectives over a 3-d
    mesh far more slowly, and itself asks for the flattening.  Built once
    per mesh, on every rank (it makes process groups)."""
    names = axis_names(mesh)
    if "pod" not in names or "data" not in names:
        return mesh
    hit = _FLAT.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    from torch.distributed.device_mesh import DeviceMesh

    i = names.index("pod")
    if names[i + 1] != "data":
        raise ValueError(f"a multi-pod mesh has 'data' right after 'pod': "
                         f"{names}")
    ranks = mesh.mesh
    shape = list(ranks.shape)
    shape[i:i + 2] = [shape[i] * shape[i + 1]]
    flat = DeviceMesh(mesh.device_type, ranks.reshape(shape),
                      mesh_dim_names=names[:i] + ("pod+data",) + names[i + 2:])
    _FLAT[id(mesh)] = (mesh, flat)
    return flat


def placements(spec: P, mesh):
    """One ``Shard(d)`` or ``Replicate()`` per mesh dim: leaf dim ``d``
    sharded over axes (a, b) gives ``Shard(d)`` on mesh dims a and b (on
    the flattened "pod+data" dim of a ``torch_mesh``, for ("pod",
    "data")).  An axis of size 1 holds the whole dim on its one rank, so
    it is ``Replicate()`` whatever the spec says (a ``Shard`` there would
    only stop DTensor from reshaping the dim)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    index = {a: i for i, a in enumerate(names)}
    for d, ax in enumerate(spec or ()):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if "+".join(axes) in index:
            axes = ("+".join(axes),)
        for a in axes:
            if not isinstance(out[index[a]], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims in {spec}")
            if sizes[a] > 1:
                out[index[a]] = Shard(d)
    return tuple(out)


def place(x, spec: P, mesh):
    """One tensor as a DTensor on ``torch_mesh(mesh)`` per ``spec``
    (after ``evenly``)."""
    from torch.distributed.tensor import distribute_tensor

    spec = evenly(spec, x, mesh)
    tm = torch_mesh(mesh)
    return distribute_tensor(x, tm, placements(spec, tm))


def place_host(x, spec: P, mesh):
    """``place`` for a tensor that every rank holds whole and equal (host
    data copied to the device: the sampled tokens): each rank keeps its
    own shard (``placed.place_local``), where ``distribute_tensor`` would
    scatter or broadcast from rank 0."""
    from repro_torch.distribution.placed import place_local

    spec = evenly(spec, x, mesh)
    tm = torch_mesh(mesh)
    return place_local(x, tm, placements(spec, tm))


def distribute_tree(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``torch_mesh(mesh)``, placed per
    ``specs`` after ``evenly`` (the counterpart of ``device_put`` with
    ``param_shardings``).  Leaves whose spec is None stay as they are."""
    from torch.distributed.tensor import distribute_tensor

    specs = evenly(specs, tree, mesh)
    tm = torch_mesh(mesh)

    def put(spec, leaf):
        if spec is None or leaf is None:
            return leaf
        return distribute_tensor(leaf, tm, placements(spec, tm))

    return _map_specs(put, specs, tree)

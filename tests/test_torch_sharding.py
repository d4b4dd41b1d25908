"""The port's spec layer (``repro_torch.distribution.sharding``) held
against ``repro.distribution.sharding`` leaf for leaf: parameter specs of
every arch in every block style it admits (source and merged, at full
width; the depth is cut to two layers, or two VLM groups, since the
leading layer axes are never split), the dense, paged and int8 cache specs,
input and logits specs, ``make_rules``, ``evenly`` and
``check_divisibility`` on the (1,1), 16x16 and 2x16x16 meshes (shapes
only: the reference reads ``mesh.shape`` and ``mesh.axis_names``, so it is
handed a duck-typed mesh), and the optimizer-state specs with and without
ZeRO-1.  Specs compare as tuples (an entry naming one axis as a 1-tuple
equals the bare name: ``PartitionSpec`` stores it so).  Then
``placements``, the torch side, on shape-only meshes."""
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jcfg
from repro.distribution import sharding as jshd
from repro.launch import steps as jsteps
from repro.training.optimizer import make_optimizer as j_make_optimizer
from repro.training.train_loop import _opt_pspecs as j_opt_pspecs
from repro_torch import configs as tcfg
from repro_torch.distribution import sharding as shd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshShape, make_production_mesh
from repro_torch.training.optimizer import make_optimizer

STYLES = ("standard", "skipless", "skipless_merged", "residual_qpfree")


def _valid(cfg):
    try:
        cfg.validate_style()
        return True
    except (ValueError, AssertionError):
        return False


def _combos():
    out = []
    for arch in tcfg.list_archs():
        for style in STYLES:
            variants = ("qp", "kp", "vp") if style == "skipless_merged" \
                else (None,)
            for var in variants:
                kw = {"block_style": style}
                if var:
                    kw["merged_variant"] = var
                if _valid(tcfg.get_config(arch).with_(**kw)):
                    out.append((arch, kw))
    return out


COMBOS = _combos()
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _JaxMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _meshes(name):
    shape, axes = MESHES[name]
    return _JaxMesh(shape, axes), MeshShape(shape, axes)


def _norm(spec):
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_flat(tree):
    """path -> spec tuple (None for an absent subtree) of a JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: x is None or isinstance(x, JP))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        out[key] = _norm(leaf)
    return out


def _port_flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields") and \
            not isinstance(tree, shd.P):
        for f, v in zip(tree._fields, tree):
            out.update(_port_flat(v, f"{prefix}{f}/"))
    else:
        out[prefix[:-1]] = _norm(tree)
    return out


def _jax_rules(name, batch=0):
    return jshd.make_rules(_meshes(name)[0], batch=batch)


def _rules(name, batch=0):
    return shd.make_rules(_meshes(name)[1], batch=batch)


def _cfgs(arch, kw):
    """Full width, two layers (two groups on a VLM)."""
    c = tcfg.get_config(arch)
    kw = dict(kw, n_layers=2 * (c.cross_attn_every if c.family == "vlm"
                                else 1))
    return jcfg.get_config(arch).with_(**kw), c.with_(**kw)


@functools.lru_cache(maxsize=None)
def _param_shapes(arch, kw_items=()):
    jc, tc = _cfgs(arch, dict(kw_items))
    return jsteps.param_specs(jc), tsteps.param_specs(tc)


@pytest.mark.parametrize("arch,kw", COMBOS,
                         ids=[f"{a}-{'-'.join(k.values())}" for a, k in COMBOS])
def test_param_specs_equal_the_reference_leaf_for_leaf(arch, kw):
    """Every leaf's spec, and its evenly-downgraded spec on the 16x16 and
    2x16x16 meshes, as the reference gives them; the port's meta shapes
    equal the reference's ``eval_shape`` shapes."""
    jshape, tshape = _param_shapes(arch, tuple(sorted(kw.items())))
    jshapes = {k: tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(
        jshape)[0] for k in ["/".join(str(p.key) for p in k)]}
    tshapes = {k: tuple(v.shape) for k, v in _port_flat_leaves(tshape)}
    assert tshapes == jshapes
    for name in ("16x16", "2x16x16"):
        jm, tm = _meshes(name)
        jr, tr = _jax_rules(name), _rules(name)
        want = jshd.param_pspecs(jshape, jr)
        got = shd.param_pspecs(tshape, tr)
        assert _port_flat(got) == _jax_flat(want)
        assert _port_flat(shd.evenly(got, tshape, tm)) == \
            _jax_flat(jshd.evenly(want, jshape, jm))
        assert shd.check_divisibility(tshape, tm, tr) == \
            jshd.check_divisibility(jshape, jm, jr)


def _port_flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_flat_leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


DECODERS = sorted({a for a, _ in COMBOS if tcfg.get_config(a).causal})


@pytest.mark.parametrize("arch", DECODERS)
def test_dense_cache_specs_equal_the_reference(arch):
    """``serving_cache_pspecs`` over a dense cache (absent fields trimmed)
    and its evenly downgrade at decode_32k's batch and length, on both
    production meshes."""
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    jcache = jsteps.cache_specs(jc, 128, 32768)
    tcache = tsteps.cache_specs(tc, 128, 32768)
    for name in ("1x1", "16x16", "2x16x16"):
        jm, tm = _meshes(name)
        want = jshd.serving_cache_pspecs(jc, _jax_rules(name, 128), jcache)
        got = shd.serving_cache_pspecs(tc, _rules(name, 128), tcache)
        assert _port_flat(got) == _jax_flat(want)
        assert _port_flat(shd.evenly(got, tcache, tm)) == \
            _jax_flat(jshd.evenly(want, jcache, jm))
        # the unpadded full spec tree too (every field present)
        assert _port_flat(shd.cache_pspecs(tc, _rules(name))) == \
            _jax_flat(jshd.cache_pspecs(jc, _jax_rules(name)))


class _Leaf:
    def __init__(self, shape):
        self.shape = tuple(shape)


@pytest.mark.parametrize("arch", ["mistral-7b", "phi3.5-moe-42b-a6.6b",
                                  "qwen2.5-32b"])
def test_paged_cache_specs_equal_the_reference(arch):
    """The fp and int8 pools' specs and their evenly downgrade over a
    256-page pool (divisible) and a 100-page one (not)."""
    from repro import models as jmodels
    from repro_torch import models as tmodels

    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for name in ("16x16", "2x16x16"):
        jm, tm = _meshes(name)
        jr, tr = _jax_rules(name, 8), _rules(name, 8)
        for q8, jf, tf in ((False, jshd.paged_cache_pspecs,
                            shd.paged_cache_pspecs),
                           (True, jshd.paged_q8_cache_pspecs,
                            shd.paged_q8_cache_pspecs)):
            want, got = jf(jc, jr), tf(tc, tr)
            assert _port_flat(got) == _jax_flat(want)
            for n_blocks in (256, 100):
                jspec = (jmodels.paged_q8_cache_spec if q8 else
                         jmodels.paged_cache_spec)(jc, n_blocks, 16, 8, 1024)
                tspec = (tmodels.paged_q8_cache_spec if q8 else
                         tmodels.paged_cache_spec)(tc, n_blocks, 16, 8, 1024)
                assert {k: tuple(v[0]) for k, v in tspec.items()} == \
                    {k: tuple(v[0]) for k, v in jspec.items()}
                jl = type(want)(*[_Leaf(jspec[f][0]) for f in want._fields])
                tl = type(got)(*[_Leaf(tspec[f][0]) for f in got._fields])
                assert _port_flat(shd.evenly(got, tl, tm)) == \
                    _jax_flat(jshd.evenly(want, jl, jm))
            # the serving dispatcher picks the same specs from the cache
            tcache = (tmodels.init_paged_q8_cache if q8 else
                      tmodels.init_paged_cache)(tc.with_(n_layers=1, d_model=8,
                                                         n_heads=1,
                                                         n_kv_heads=1,
                                                         d_head=8),
                                                4, 4, 2, 8, device="cpu")
            assert _port_flat(shd.serving_cache_pspecs(tc, tr, tcache)) == \
                _port_flat(got)


@pytest.mark.parametrize("arch", sorted(tcfg.list_archs()))
def test_input_and_logits_specs_equal_the_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    for name in ("1x1", "16x16", "2x16x16"):
        for batch in (0, 1, 256):
            jr, tr = _jax_rules(name, batch), _rules(name, batch)
            for kind in ("train", "prefill", "decode"):
                assert {k: _norm(v) for k, v in
                        shd.input_pspecs(tc, kind, tr).items()} == \
                    {k: _norm(v) for k, v in
                     jshd.input_pspecs(jc, kind, jr).items()}
            for seq in (True, False):
                assert _norm(shd.logits_pspec(tr, seq)) == \
                    _norm(jshd.logits_pspec(jr, seq))
            assert _norm(shd.batch_pspec(tr, 2)) == \
                _norm(jshd.batch_pspec(jr, 2))


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("batch", [0, 1, 2, 16, 255, 256, 512])
def test_make_rules_equals_the_reference(name, batch):
    """DP over ("pod", "data") where present, dropped for a batch smaller
    than the DP size (batch 1 on every mesh of more than one chip)."""
    assert _rules(name, batch) == \
        shd.ShardingRules(**_jax_rules(name, batch).__dict__)
    if batch == 1 and name != "1x1":
        assert _rules(name, batch).dp is None


@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3.5-moe-42b-a6.6b",
                                  "hymba-1.5b"])
def test_opt_specs_equal_the_reference(arch, zero1):
    """AdamW state specs (step replicated, moments following the evenly
    param specs, ZeRO-1 on the first free dim) on every mesh."""
    jshape, tshape = _param_shapes(arch)
    jopt = jax.eval_shape(j_make_optimizer("adamw", 1e-3, 1, 10).init,
                          jshape)
    topt = make_optimizer("adamw", 1e-3, 1, 10).init(tshape)
    for name in ("1x1", "16x16", "2x16x16"):
        jm, tm = _meshes(name)
        jr, tr = _jax_rules(name, 256), _rules(name, 256)
        jp = jshd.evenly(jshd.param_pspecs(jshape, jr), jshape, jm)
        tp = shd.evenly(shd.param_pspecs(tshape, tr), tshape, tm)
        want = j_opt_pspecs(jopt, jp, jm, zero1=zero1, dp_axes=jr.dp)
        got = shd.opt_pspecs(topt, tp, tm, zero1=zero1, dp_axes=tr.dp)
        assert _port_flat(got) == _jax_flat(want)
        assert _port_flat(shd.evenly(got, topt, tm)) == \
            _jax_flat(jshd.evenly(want, jopt, jm))


def test_production_meshes_are_shapes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.size == 512


def test_placements_one_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    m2 = MeshShape((2, 4), ("data", "model"))
    assert shd.placements(shd.P(("data",), None), m2) == (Shard(0), R)
    assert shd.placements(shd.P(None, "model"), m2) == (R, Shard(1))
    assert shd.placements(shd.P(("data",), None, "model"), m2) == \
        (Shard(0), Shard(2))
    assert shd.placements(shd.P(), m2) == (R, R)
    assert shd.placements(shd.P(None, None), m2) == (R, R)
    # a dim split over two axes is Shard(d) on both
    m3 = MeshShape((2, 2, 4), ("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), "model"), m3) == \
        (Shard(0), Shard(0), Shard(1))
    # an axis of size 1 holds the whole dim: Replicate
    m1 = MeshShape((1, 4), ("data", "model"))
    assert shd.placements(shd.P(("data",), "model"), m1) == (R, Shard(1))
    # one axis cannot split two dims
    with pytest.raises(ValueError, match="two dims"):
        shd.placements(shd.P("model", "model"), m2)


def test_evenly_replicates_what_does_not_divide():
    m = MeshShape((2, 16, 16), ("pod", "data", "model"))
    spec = {"a": shd.P(("pod", "data"), "model"), "b": shd.P(None, "model"),
            "c": None}
    shapes = {"a": _Leaf((64, 40)), "b": _Leaf((3, 32)), "c": _Leaf((5,))}
    assert shd.evenly(spec, shapes, m) == {
        "a": shd.P(("pod", "data"), None), "b": shd.P(None, "model"),
        "c": None}

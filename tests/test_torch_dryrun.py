"""The meta-device dry run (``repro_torch.configs.shapes``,
``repro_torch.launch.steps``, ``repro_torch.launch.dryrun``) held against
the reference: ``SHAPES`` and ``shape_applicable`` (with its reasons) for
every arch, the input stand-ins' shapes and dtypes, ``n_params`` and the
model FLOPs, then records of every applicable cell at ``reduce_config``
and of a few at full width, on the meta device (the meta-only record,
``analysis=False``; the placed run's record is
``tests/test_torch_dryrun_placed.py``'s).

``repro.launch.dryrun`` is never imported here (it sets ``XLA_FLAGS`` to
512 host devices on import): the reference's model FLOPs come from
``repro.core.analysis.weight_table`` with its formula, written out
below."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.analysis import weight_table as j_weight_table
from repro.launch import steps as jsteps
from repro_torch import configs as tcfg
from repro_torch.distribution import sharding as shd
from repro_torch.launch import dryrun, steps as tsteps

ARCHS = tcfg.ASSIGNED_ARCHS

_DT = {"int32": torch.int32, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


def test_shapes_and_archs_equal_the_reference():
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in tcfg.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in jcfg.SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(tcfg.list_archs()))
def test_shape_applicable_equals_the_reference(arch):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    for name in tcfg.SHAPES:
        assert tcfg.shape_applicable(tc, tcfg.SHAPES[name]) == \
            jcfg.shape_applicable(jc, jcfg.SHAPES[name])
    assert [s.name for s in tcfg.applicable_shapes(tc)] == \
        [s.name for s in jcfg.applicable_shapes(jc)]


def _flat(tree, prefix=""):
    if tree is None:
        return {prefix: None}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}{f}/"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    """Every applicable shape's inputs (a decode cell's cache too): the
    same shapes and dtypes; the port's lie on the meta device."""
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    for s in tcfg.applicable_shapes(tc):
        got = tsteps.input_specs(tc, s)
        want = jsteps.input_specs(jc, jcfg.SHAPES[s.name])
        assert _flat(got) == _flat(want), s.name
        assert all(x.device.type == "meta" for x in
                   jax.tree_util.tree_leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_equals_the_reference(arch):
    """The port's meta-device tree holds as many parameters as the
    reference's ``eval_shape`` tree, at full width and depth."""
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    want = sum(int(np.prod(x.shape)) for x in
               jax.tree.leaves(jsteps.param_specs(jc)))
    pshape = tsteps.param_specs(tc)
    assert sum(x.numel() for x in jax.tree_util.tree_leaves(pshape)) == want
    assert all(x.device.type == "meta"
               for x in jax.tree_util.tree_leaves(pshape))


def _j_model_flops(cfg, shape):
    """The reference's ``_model_flops`` (``repro/launch/dryrun.py``)."""
    wt = j_weight_table(cfg)
    n_matmul = wt["total"] - cfg.d_model * cfg.vocab_size
    if cfg.n_experts:
        frac_active = cfg.experts_per_token / cfg.n_experts
        n_matmul -= cfg.n_layers * wt["ffn_per_layer"] * (1 - frac_active)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n_matmul * tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    for name, s in tcfg.SHAPES.items():
        assert dryrun._model_flops(tc, s) == \
            _j_model_flops(jc, jcfg.SHAPES[name])


def _check_record(rec, arch, shape, multi_pod):
    assert not rec["skipped"] and rec["arch"] == arch
    assert rec["mesh"]["chips"] == (512 if multi_pod else 256)
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(v for k, v in mem.items()
                                        if k != "argument_bytes")
    assert mem["params_bytes"] > 0 and mem["input_bytes"] > 0
    assert ("opt_bytes" in mem) == (rec["kind"] == "train")
    assert ("cache_bytes" in mem) == (rec["kind"] == "decode")
    r = rec["roofline"]
    assert r["compute_s"] == rec["model_flops_per_device"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == mem["argument_bytes"] / dryrun.HBM_BW
    assert r["dominant"] in ("compute", "memory")
    json.dumps(rec)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_applicable_cell_runs_at_reduce_config(arch, monkeypatch):
    """Each cell's step runs on the meta device at the cell's full shape
    (the reduced model); skipped cells carry the reference's reason.  The
    SSD scan keeps the full config's chunk: at the reduced 8 a 32k-token
    prompt is 4096 chunk steps of the plain scan, which cost time and
    cover nothing more."""
    real = tcfg.get_config

    def reduced(name):
        c = real(name)
        return tcfg.reduce_config(c).with_(ssm_chunk=c.ssm_chunk)

    monkeypatch.setattr(tcfg, "get_config", reduced)
    jc = jcfg.get_config(arch)
    jc = jcfg.reduce_config(jc).with_(ssm_chunk=jc.ssm_chunk)
    n_params = sum(int(np.prod(x.shape))
                   for x in jax.tree.leaves(jsteps.param_specs(jc)))
    for name, s in tcfg.SHAPES.items():
        for mp in (False, True):
            rec = dryrun.run_cell(arch, name, multi_pod=mp, analysis=False)
            ok, why = jcfg.shape_applicable(jc, jcfg.SHAPES[name])
            if not ok:
                assert rec == {"arch": arch, "shape": name, "skipped": True,
                               "reason": why}
                continue
            _check_record(rec, arch, name, mp)
            assert rec["n_params"] == n_params


def _per_device(tree_specs, tree_shapes, mesh):
    return dryrun._per_device_bytes(tree_shapes, tree_specs, mesh)


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("llama3.2-1b", "train_4k", False),
    ("qwen2.5-32b", "decode_32k", True),
    ("hymba-1.5b", "long_500k", True),
    ("hubert-xlarge", "prefill_32k", False),
])
def test_full_width_cells(arch, shape, multi_pod):
    """A few cells at full width and depth: the record's parameter count,
    uneven shardings and per-device parameter bytes against the specs."""
    from repro_torch.launch.mesh import make_production_mesh

    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, analysis=False)
    _check_record(rec, arch, shape, multi_pod)
    tc = tcfg.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = shd.make_rules(mesh, batch=tcfg.SHAPES[shape].global_batch)
    pshape = tsteps.param_specs(tc)
    assert rec["n_params"] == sum(x.numel() for x in
                                  jax.tree_util.tree_leaves(pshape))
    assert rec["uneven_shardings"] == shd.check_divisibility(pshape, mesh,
                                                             rules)
    spec = shd.evenly(shd.param_pspecs(pshape, rules), pshape, mesh)
    assert rec["memory"]["params_bytes"] == _per_device(spec, pshape, mesh)
    # a replicated leaf counts whole on every device: at least total / chips
    total = sum(x.numel() * x.element_size() for x in
                jax.tree_util.tree_leaves(pshape))
    assert total / rec["mesh"]["chips"] <= rec["memory"]["params_bytes"] \
        <= total


def test_cli_writes_records_and_skips_existing(tmp_path, capsys):
    out = str(tmp_path / "dry")
    counts = dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                          "--both-meshes", "--out", out])
    assert counts == {"run": 2, "skipped": 0, "failed": 0}
    files = sorted(os.listdir(out))
    assert files == ["mamba2-2.7b__long_500k__multi__default.json",
                     "mamba2-2.7b__long_500k__single__default.json"]
    rec = json.load(open(os.path.join(out, files[0])))
    assert rec["mesh"]["chips"] == 512 and rec["kind"] == "decode"
    assert rec["roofline"]["collective_s"] > 0  # the placed run's record
    counts = dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                          "--out", out])
    assert counts == {"run": 0, "skipped": 1, "failed": 0}
    assert "SKIP: pure full-attention arch" in capsys.readouterr().out
    counts = dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                          "--both-meshes", "--out", out, "--skip-existing"])
    assert counts == {"run": 0, "skipped": 0, "failed": 0}

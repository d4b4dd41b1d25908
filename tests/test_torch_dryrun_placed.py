"""The placed dry run (``repro_torch.launch.dryrun.run_cell`` with its
analysis on): each step runs on DTensors over a fake process group of the
mesh's size, and its record carries the counts of the partitioned
program.

  * every arch at ``reduce_config``, each applicable kind (train, prefill,
    decode), placed on both production meshes (16x16 and 2x16x16), and
    reduced HuBERT and Moonshot on a (2, 8) mesh as well (a model axis of
    8 over 4 heads and over the MoE dispatch, which did not cohere): each
    record has the collectives (counts, bytes per op, total, by link),
    the per-device FLOPs and bytes accessed, the model-FLOPs ratio and the
    three-term roofline.  The cells' shapes are cut, each cut listed in
    ``CUTS`` (the global batch is kept, so the data axes split it as in
    production): a 32k-token prefill at the reduced width is a loop of 32
    query chunks a layer and, at the reduced SSD chunk of 8, 4096 chunk
    steps a layer, which cost time and place nothing new.
    ``shape_applicable`` is read on the uncut shape;
  * full width and depth, decode: Llama-3.2-1B decode_32k on the single
    pod (8 kv heads over a model axis of 16), Qwen2.5-32B decode_32k and
    Hymba-1.5B long_500k on the multi-pod mesh, against the specs'
    per-device bytes.  Full-width prefill and train cells are the CLI
    run's (``--all --both-meshes``).

No process group is started in the test process: the cells run in
subprocesses (``tests/_torch_dryrun_placed_worker.py``), all at once."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch import configs as tcfg
from repro_torch.launch import dryrun

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dryrun_placed_worker.py")
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 240
N_WORKERS = 4

KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
# the cuts of the reduced cells' shapes: the sequence only
CUTS = {"train_4k": {"seq_len": 64}, "prefill_32k": {"seq_len": 64},
        "decode_32k": {}}
FULL = [("llama3.2-1b", "decode_32k", False),
        ("qwen2.5-32b", "decode_32k", True),
        ("hymba-1.5b", "long_500k", True)]
AXIS_8 = ["hubert-xlarge", "moonshot-v1-16b-a3b"]


def _reduced(arch):
    full = tcfg.get_config(arch)
    red = tcfg.reduce_config(full)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _cells():
    """(tag, run_cell keywords) of every cell this file runs."""
    out = []
    for arch in tcfg.ASSIGNED_ARCHS:
        over = _reduced(arch)
        for kind, shape in KINDS.items():
            if not tcfg.shape_applicable(tcfg.get_config(arch),
                                         tcfg.SHAPES[shape])[0]:
                continue
            meshes = [("single", {"multi_pod": False}),
                      ("multi", {"multi_pod": True})]
            if arch in AXIS_8:
                meshes.append(("2x8", {"mesh_shape": [2, 8]}))
            for name, mesh in meshes:
                out.append((f"{arch}|{kind}|{name}", dict(
                    arch=arch, shape_name=shape, cfg_overrides=over,
                    shape_overrides=CUTS[shape] or None, **mesh)))
    for arch, shape, mp in FULL:
        out.append((f"full|{arch}|{shape}|{'multi' if mp else 'single'}",
                    dict(arch=arch, shape_name=shape, multi_pod=mp)))
    return out


CELLS = _cells()


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("placed"))
    # the full-width cells first, one to a worker, then the rest dealt out
    order = sorted(range(len(CELLS)),
                   key=lambda i: not CELLS[i][0].startswith("full"))
    parts = [order[w::N_WORKERS] for w in range(N_WORKERS)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC)
    procs = []
    for w, part in enumerate(parts):
        cells = os.path.join(data, f"cells_{w}.json")
        with open(cells, "w") as f:
            json.dump([CELLS[i][1] for i in part], f)
        log = open(os.path.join(data, f"worker_{w}.log"), "w")
        procs.append((part, os.path.join(data, f"out_{w}.json"), log,
                      subprocess.Popen([sys.executable, WORKER, cells,
                                        os.path.join(data, f"out_{w}.json")],
                                       stdout=log, stderr=subprocess.STDOUT,
                                       env=env)))
    out = {}
    for part, path, log, p in procs:
        try:
            code = p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            code = "timeout"
        log.close()
        got = json.load(open(path)) if os.path.exists(path) else []
        for j, i in enumerate(part):
            out[CELLS[i][0]] = got[j] if j < len(got) else {
                "error": f"worker exit {code}: "
                         + open(log.name).read()[-3000:]}
    return out


def _check(rec):
    assert "error" not in rec, rec.get("traceback", rec.get("error"))
    assert not rec["skipped"]
    c = rec["collectives"]
    names = set(c["counts"])
    assert {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute"} <= names
    assert names == set(c["per_op_bytes"])
    assert c["total_bytes"] == sum(c["per_op_bytes"].values())
    assert c["total_bytes"] == sum(c["by_link"].values())
    assert sum(c["counts"].values()) > 0  # a model axis > 1 splits it
    assert rec["flops_per_device"] > 0
    assert rec["bytes_accessed_per_device"] > 0
    assert rec["model_flops_ratio"] == \
        rec["model_flops_per_device"] / rec["flops_per_device"]
    r = rec["roofline"]
    assert r["compute_s"] == rec["flops_per_device"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == rec["bytes_accessed_per_device"] / dryrun.HBM_BW
    assert r["collective_s"] == c["by_link"]["nvlink"] / dryrun.NVLINK_BW \
        + c["by_link"]["network"] / dryrun.NETWORK_BW
    assert r["dominant"] == max(("compute", "memory", "collective"),
                                key=lambda k: r[k + "_s"])
    json.dumps(rec)


@pytest.mark.parametrize("tag", [t for t, _ in CELLS
                                 if not t.startswith("full")])
def test_every_arch_and_kind_runs_placed_at_reduce_config(records, tag):
    rec = records[tag]
    _check(rec)
    arch, kind, mesh = tag.split("|")
    assert rec["kind"] == kind
    want = {"single": 256, "multi": 512, "2x8": 16}[mesh]
    assert rec["mesh"]["chips"] == want
    cut = CUTS[KINDS[kind]]
    assert rec.get("shape_overrides") == (cut or None)
    # the model axis (of 16, or 8) spans two 8-GPU nodes only on the
    # production meshes: their model-axis collectives ride the network
    if mesh != "2x8":
        assert rec["collectives"]["by_link"]["network"] > 0


@pytest.mark.parametrize("arch,shape,multi_pod", FULL)
def test_full_width_decode_runs_placed(records, arch, shape, multi_pod):
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_production_mesh

    rec = records[f"full|{arch}|{shape}|{'multi' if multi_pod else 'single'}"]
    _check(rec)
    assert rec["mesh"]["chips"] == (512 if multi_pod else 256)
    tc = tcfg.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = shd.make_rules(mesh, batch=tcfg.SHAPES[shape].global_batch)
    pshape = tsteps.param_specs(tc)
    spec = shd.evenly(shd.param_pspecs(pshape, rules), pshape, mesh)
    assert rec["memory"]["params_bytes"] == \
        dryrun._per_device_bytes(pshape, spec, mesh)
    # the decode step writes its new K/V rows through ``placed.put_``
    # (the gathers of the step's rows) and, with attention, combines the
    # sequence-split cache's scores across the model axis
    assert rec["collectives"]["counts"]["all-gather"] > 0


def test_no_analysis_keeps_the_meta_only_record_and_starts_no_group(
        tmp_path):
    """``--no-analysis``: no placed run, no process group, the meta-only
    record (a roofline of model FLOPs and argument bytes)."""
    import torch.distributed as dist

    out = str(tmp_path / "dry")
    counts = dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                          "--no-analysis", "--out", out])
    assert counts == {"run": 1, "skipped": 0, "failed": 0}
    rec = json.load(open(os.path.join(
        out, "llama3.2-1b__decode_32k__single__default.json")))
    assert "collectives" not in rec and "flops_per_device" not in rec
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "dominant"}
    assert not dist.is_initialized()


def test_importing_the_dry_run_starts_no_group_and_sets_no_environment():
    code = ("import os, json; before = dict(os.environ); "
            "import torch.distributed as dist; "
            "import repro_torch.launch.dryrun, "
            "repro_torch.distribution.collectives; "
            "print(json.dumps([dist.is_initialized(), "
            "dict(os.environ) == before]))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [False, True]

"""The port on device meshes of CPU processes (gloo), held against the JAX
package without a mesh and the port without one:

  * ``Trainer(mesh=)`` on (1, 1), (2, 1), (1, 2), (2, 2) and, one step,
    (2, 2, 2) ("pod", "data", "model"): resumed from the JAX
    ``Trainer``'s step-1 checkpoint, its logged losses and final params
    equal the JAX run's and the unmeshed port's to ``RTOL`` relative
    (params: per leaf, ||a - b|| / ||b||); at step 1, ``build_step``'s
    train step with its re-anchors gives the unmeshed step's loss;
  * elastic resume: a checkpoint at step 2 on (2, 2), resumed on (1, 4),
    equals a straight (1, 4) run (the counterpart of
    ``tests/test_elastic.py``);
  * ``Engine`` and ``ScheduledEngine`` on (1, 1), (1, 2), (2, 1) and
    (2, 2), dense cache, the source and the qp-merged skipless Mistral-7B
    (reduced): greedy streams equal to the JAX ``Engine``'s;
  * the other families on the dense cache on those meshes (MoE, hybrid,
    SSM, the VLM with its vision tokens), from the JAX package's weights:
    greedy streams equal to the JAX ``Engine``'s and the unmeshed port's;
    the paged and int8 pools raise NotImplementedError; ``impl="cuda"``
    with a model axis larger than 1 raises ValueError at construction; a
    kernel wrapper given a DTensor raises TypeError;
  * ``python -m repro_torch.launch.train --mesh 2x2 --smoke --device cpu``
    under ``torchrun --standalone`` (four processes; its rendezvous
    binds a free localhost port itself).

No process group is started in the test process: every mesh runs in
subprocesses (``tests/_torch_dist_worker.py``) that meet through a
``file://`` rendezvous in ``tmp_path``, each with its own timeout.  All
groups run at once, in one module fixture, while the test process
computes the references."""
import dataclasses
import json
import os
import pickle
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jcfg
from repro import training as jtr
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.convert import to_torch
from repro_torch.launch import steps as tsteps
from repro_torch.serving import Engine, ServeConfig
from repro_torch.training import DataConfig, Trainer, TrainerConfig

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
SRC = os.path.join(HERE, "..", "src")
RTOL = 1e-5
TIMEOUT = 300

GROUPS = {  # name: (mesh, world, tasks)
    "g11": ("1x1", 1, "train,serve,families"),
    "g21": ("2x1", 2, "train,serve,families"),
    "g12": ("1x2", 2, "train,serve,families"),
    "g22": ("2x2", 4, "train,serve,families,elastic"),
    "g222": ("2x2x2", 8, "train"),
}
SERVE_GROUPS = ["g11", "g12", "g21", "g22"]
TRAIN = {"steps": 3,
         "trainer": dict(log_every=1, ckpt_every=1, keep_ckpts=10, lr=1e-3,
                         warmup=1),
         "data": dict(global_batch=4, seq_len=16, seed=0)}
SERVE = {"n_slots": 4, "max_len": 48, "max_new": 6,
         "sched": dict(token_budget=16, chunk_tokens=8),
         "prompts": [[(3 * i + 7 * j) % 128 for j in range(n)]
                     for i, n in enumerate((5, 11, 3, 8, 14))]}
# the other families: (arch, block style, embedding gain), the weights as
# the JAX package's own tests of each family make them
FAMILIES = {"phi3.5-moe-42b-a6.6b": ("skipless", 1.0),
            "hymba-1.5b": ("skipless", 1.0),
            "mamba2-2.7b": ("standard", 1.0),
            "llama3.2-vision-11b": ("skipless", 50.0)}
FAMILY_SERVE = {"sc": dict(n_slots=4, max_len=32, block_size=8),
                "max_new": 5}


def _save_tree(path, tree):
    flat = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + (k,))
        else:
            flat["/".join(p)] = np.asarray(t)

    walk(tree, ())
    np.savez(path, **flat)


def _env():
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC,
                JAX_PLATFORMS="cpu")


def _streams(outs):
    return [list(map(int, o)) for o in outs]


def _families(data):
    """The JAX weights of each family, saved for the workers with the
    port's config, the prompts and the vision tokens."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 9, 3)]
    models = {}
    for i, (arch, (style, gain)) in enumerate(FAMILIES.items()):
        jc = jcfg.reduce_config(jcfg.get_config(arch)).with_(
            block_style=style, dtype="float32", param_dtype="float32")
        p = jax.tree.map(np.asarray,
                         jax_init_params(jax.random.PRNGKey(i), jc))
        p["embed"]["table"] = p["embed"]["table"] * gain
        tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(jc)})
        models[arch] = (jc, tc, p)
    d = jcfg.reduce_config(jcfg.get_config("llama3.2-vision-11b")).d_model
    n = jcfg.reduce_config(
        jcfg.get_config("llama3.2-vision-11b")).n_vision_tokens
    vision = [rng.standard_normal((n, d)).astype(np.float32)
              for _ in prompts]
    spec = dict(FAMILY_SERVE, prompts=prompts, vision=vision,
                models={a: (tc, p) for a, (_, tc, p) in models.items()})
    with open(os.path.join(data, "families.pkl"), "wb") as f:
        pickle.dump(spec, f)
    return models, spec


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("dist"))
    ck = os.path.join(data, "ck_launch")
    launch = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--smoke", "--steps", "4", "--log-every", "2",
         "--batch", "4", "--seq-len", "16", "--mesh", "2x2", "--device",
         "cpu", "--ckpt-dir", ck], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env())
    # the JAX Trainer, a checkpoint at every step: the workers resume its
    # first
    jc = jcfg.reduce_config(jcfg.get_config("llama3.2-1b"))
    jtrainer = jtr.Trainer(jc, jtr.TrainerConfig(
        ckpt_dir=os.path.join(data, "jax_ck"), steps=TRAIN["steps"],
        **TRAIN["trainer"]), jtr.DataConfig(**TRAIN["data"]))
    jtrainer.run()
    with open(os.path.join(data, "train.json"), "w") as f:
        json.dump(TRAIN, f)
    # the models to serve (Mistral-7B source and qp-merged, the other
    # families), saved for the workers
    base = dict(block_style="skipless", dtype="float32",
                param_dtype="float32", n_kv_heads=4)
    jm = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**base)
    params = jax_init_params(jax.random.PRNGKey(0), jm)
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    mp, mc = jax_merge(params, jm, "qp")
    cfgs, mistral = {}, {}
    for name, (c, p) in (("source", (jm, params)), ("merged", (mc, mp))):
        _save_tree(os.path.join(data, f"serve_{name}.npz"),
                   jax.tree.map(np.asarray, p))
        cfgs[name] = dict(base, block_style=c.block_style,
                          merged_variant=c.merged_variant)
        mistral[name] = (c, p)
    with open(os.path.join(data, "serve.json"), "w") as f:
        json.dump(dict(SERVE, cfgs=cfgs), f)
    families, fspec = _families(data)

    procs = []
    for group, (mesh, world, tasks) in GROUPS.items():
        for r in range(world):
            log = open(os.path.join(data, f"{group}_{r}.log"), "w")
            procs.append((group, log, subprocess.Popen(
                [sys.executable, WORKER, data, group, str(r), str(world),
                 mesh, tasks], stdout=log, stderr=subprocess.STDOUT,
                env=_env())))

    # meanwhile, the references: the JAX engines' streams, the unmeshed
    # port's streams of the other families, and the unmeshed port resuming
    # the same checkpoint (its train step's loss at step 1 first)
    prompts = [np.asarray(p, np.int32) for p in SERVE["prompts"]]
    want = {name: _streams(JaxEngine(c, p, JaxServeConfig(
        n_slots=SERVE["n_slots"], max_len=SERVE["max_len"])).generate(
            prompts, max_new_tokens=SERVE["max_new"]))
        for name, (c, p) in mistral.items()}
    jax_fam, port_fam = {}, {}
    for arch, (jc_, tc_, p) in families.items():
        vis = fspec["vision"] if tc_.n_vision_tokens else None
        kw = dict(max_new_tokens=fspec["max_new"], vision=vis)
        jax_fam[arch] = _streams(JaxEngine(
            jc_, p, JaxServeConfig(**fspec["sc"]), impl="xla").generate(
                fspec["prompts"], **kw))
        port_fam[arch] = _streams(Engine(
            tc_, to_torch(p, device="cpu"), ServeConfig(**fspec["sc"]),
            impl="torch", device="cpu").generate(fspec["prompts"], **kw))
    tc = tcfg.reduce_config(tcfg.get_config("llama3.2-1b"))
    d = os.path.join(data, "ck_plain")
    shutil.copytree(os.path.join(data, "jax_ck", "step_00000001"),
                    os.path.join(d, "step_00000001"))
    plain = Trainer(tc, TrainerConfig(ckpt_dir=d, steps=TRAIN["steps"],
                                      **TRAIN["trainer"]),
                    DataConfig(**TRAIN["data"]), device="cpu")
    fn, _ = tsteps.build_step(tc, "train")
    p1 = tree_map(lambda t: t.clone(), plain.params)
    plain_loss = float(fn(p1, plain.optimizer.init(p1),
                          plain._batch(1))[2]["loss"])
    plain.run()

    codes = {}
    for group, log, p in procs:
        try:
            codes.setdefault(group, []).append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.setdefault(group, []).append("timeout")
        log.close()
    try:
        launch_out, _ = launch.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        launch.kill()
        launch_out, _ = launch.communicate()
    results = {}
    for group, (_, world, _) in GROUPS.items():
        path = os.path.join(data, f"{group}_0.json")
        results[group] = json.load(open(path)) if os.path.exists(path) \
            else {}
        if codes[group] != [0] * world:
            logs = "".join(open(os.path.join(data, f"{group}_{r}.log")).read()
                           [-3000:] for r in range(world))
            results[group]["failure"] = f"exit {codes[group]}: {logs}"
    return {"data": data, "groups": results, "jax_train": jtrainer,
            "plain": plain, "plain_loss": plain_loss, "jax_streams": want,
            "jax_families": jax_fam, "port_families": port_fam,
            "launch": (launch.returncode, launch_out, ck)}


def _group(run, name):
    res = run["groups"][name]
    assert "failure" not in res, res.get("failure")
    return res


def _rel(a, b):
    return abs(a - b) / abs(b)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _flat_jax(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_trainer_on_a_mesh_equals_jax_and_the_unmeshed_port(run, group):
    res = _group(run, group)
    losses = {int(k): v for k, v in res["train_losses"].items()}
    jax_losses = {m["step"]: m["loss"] for m in run["jax_train"].metrics_log}
    plain = {m["step"]: m["loss"] for m in run["plain"].metrics_log}
    assert sorted(losses) == list(range(2, 2 + len(losses)))
    for s, v in losses.items():
        assert _rel(v, jax_losses[s]) <= RTOL, (s, v, jax_losses[s])
        assert _rel(v, plain[s]) <= RTOL, (s, v, plain[s])
    if len(losses) < TRAIN["steps"] - 1:  # (2, 2, 2): one step
        return
    got = _load(os.path.join(run["data"], f"train_{group}.npz"))
    want = _flat_jax(run["jax_train"].params)
    mine = dict(zip(sorted(got), (t.numpy() for t in tree_leaves(
        run["plain"].params))))
    assert sorted(got) == sorted(want)
    for k in got:
        for ref in (want[k], mine[k]):
            err = np.linalg.norm(got[k] - ref) / np.linalg.norm(ref)
            assert err <= RTOL, (k, err)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_build_step_reanchors_change_no_loss(run, group):
    """``build_step``'s stream (sequence over "model"), q/k/v (heads) and
    logits (vocab) re-anchors on the mesh: the unmeshed step's loss."""
    anchored = _group(run, group)["anchored_loss"]
    assert _rel(anchored, run["plain_loss"]) <= RTOL, \
        (anchored, run["plain_loss"])


def test_params_and_moments_are_placed_per_the_specs(run):
    # w_up (L, d, d_ff) splits its FFN dim over "model", whole over "data"
    assert _group(run, "g22")["train_placements"] == \
        "(Replicate(), Shard(dim=2))"
    assert _group(run, "g21")["train_placements"] == \
        "(Replicate(), Replicate())"
    assert _group(run, "g222")["train_placements"] == \
        "(Replicate(), Shard(dim=2))"


def test_elastic_resume_from_2x2_to_1x4_equals_a_straight_run(run):
    res = _group(run, "g22")
    assert res["elastic_start"] == 2
    assert res["elastic_rel"] <= RTOL, res["elastic_rel"]
    a, b = res["elastic_loss"]
    assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("engine", ["engine", "sched"])
@pytest.mark.parametrize("model", ["source", "merged"])
@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_engines_on_a_mesh_give_the_jax_engine_streams(run, group, model,
                                                       engine):
    res = _group(run, group)["serve"]
    assert res[f"{model}/{engine}"] == run["jax_streams"][model]
    if engine == "engine":
        assert res[f"{model}/engine_fast_path"] == (model == "merged")


def test_the_cache_is_placed_per_the_specs(run):
    # k (L, B, S, Hkv, Dh): batch over "data", the sequence over "model"
    res = _group(run, "g22")["serve"]["source/placements"]
    assert res["k"] == "(Shard(dim=1), Shard(dim=2))"
    assert res["wk"] == "(Replicate(), Shard(dim=2))"


@pytest.mark.parametrize("arch", sorted(FAMILIES))
@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_other_families_on_a_mesh_give_the_jax_engine_streams(run, group,
                                                              arch):
    """MoE, hybrid, SSM and the VLM with its vision tokens, dense cache."""
    assert _group(run, group)["families"][arch] == run["jax_families"][arch]


@pytest.mark.parametrize("arch", sorted(FAMILIES))
@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_other_families_on_a_mesh_equal_the_unmeshed_port(run, group, arch):
    assert _group(run, group)["families"][arch] == run["port_families"][arch]


@pytest.mark.parametrize("kind", ["paged", "paged_q8"])
@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_paged_pools_refuse_a_mesh(run, group, kind):
    got = _group(run, group)["families"][kind]
    assert got.startswith("NotImplementedError") and kind in got, got


@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_cuda_refuses_a_model_axis_larger_than_1(run, group):
    got = _group(run, group)["families"]["cuda"]
    assert got.startswith("ValueError"), got
    # a model axis of 1 gets past that check (to the device check)
    assert ("model axis" in got) == (group in ("g12", "g22")), got


@pytest.mark.parametrize("group", SERVE_GROUPS)
def test_kernel_wrappers_refuse_dtensors(run, group):
    got = _group(run, group)["families"]["wrapper"]
    assert got.startswith("TypeError") and "DTensor" in got, got


def test_launch_train_mesh_under_torchrun(run):
    from repro_torch.training import checkpoint

    code, out, ck = run["launch"]
    assert code == 0, out[-3000:]
    lines = out.splitlines()
    logs = [json.loads(x) for x in lines if x.startswith("{")]
    assert [m["step"] for m in logs] == [2, 4]  # rank 0 alone prints
    assert all(np.isfinite(m["loss"]) for m in logs)
    assert sum(x.startswith("final:") for x in lines) == 1
    assert checkpoint.latest_step(ck) == 4

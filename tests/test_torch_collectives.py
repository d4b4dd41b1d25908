"""The collective counter (``repro_torch.distribution.collectives
.StepCounter``) and the placed dry run's prediction against what a real
group moves:

  * three cases with a known answer, each on a fake group and on a gloo
    group of 2, mesh (1, 2): a row-parallel product (one all-reduce of
    B·S·D float32 elements; its FLOPs those of the rank's local shard, not
    of the global shapes), the all-gather of a tensor split on dim 0 (the
    local shard's bytes) and ``placed.combine_softmax`` (two all-reduces:
    the maxima, then the weighted sums and normalisers);
  * predicted == moved: the train, prefill and decode steps of the
    reduced Llama-3.2-1B and Mistral-7B (skipless source and its qp
    merge), and Mamba2's decode, counted on gloo groups of the meshes
    (1, 2) and (2, 2), equal ``launch.dryrun.run_cell``'s record for the
    same step, config, batch, mesh shape and route ("torch", a CPU mesh)
    over a fake group, per op, in counts and bytes; every gloo rank
    counts the same;
  * a model axis that does not divide the kv heads (the reduced
    Mistral-7B at 6 query and 3 kv heads, d_model 96, on (1, 2): the
    projections used to reshape a column split inside a head): ``Engine``
    on both routes, source and qp merge, gives the JAX engine's greedy
    streams, and ``Trainer`` resuming the JAX run's step-1 checkpoint its
    losses;
  * on (2, 2) and (2, 1), a loss and its gradients of reduced
    Llama-3.2-1B, Mamba2 and Moonshot equal the unmeshed ones (the seams
    where a rank computes on local tensors: the vocabulary-parallel
    embedding, the SSD scan on the rank's heads or batch rows, the MoE
    dispatch on its groups; a replicated weight used there has a
    gradient summed over the ranks).

No process group is started in the test process: the gloo ranks and the
fake groups run in subprocesses (``tests/_torch_collectives_worker.py``)
at once, while the test process computes the JAX references."""
import dataclasses
import json
import os
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

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_collectives_worker.py")
SRC = os.path.join(HERE, "..", "src")
TIMEOUT = 240
RTOL = 1e-5

# name: (mesh, world, tasks); "fake..." processes start no gloo group
GROUPS = {"c12": ("1x2", 2, "known,steps,heads"),
          "c22": ("2x2", 4, "steps,grads"),
          "c21": ("2x1", 2, "grads"),
          "fake12": ("1x2", 1, "known,predict"),
          "fake22": ("2x2", 1, "predict")}
MESHES = {"1x2": ("c12", "fake12"), "2x2": ("c22", "fake22")}
CELLS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
SIZES = {"train": (4, 16), "prefill": (4, 16), "decode": (4, 32)}


def _reduced(arch, **kw):
    full = tcfg.get_config(arch)
    red = tcfg.reduce_config(full).with_(**kw)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(red)
            if getattr(red, f.name) != getattr(full, f.name)}


def _cases():
    models = {"llama": ("llama3.2-1b", {}, False),
              "mistral": ("mistral-7b", {"block_style": "skipless"}, False),
              "mistral_qp": ("mistral-7b", {"block_style": "skipless"},
                             True)}
    out = {}
    for name, (arch, kw, merged) in models.items():
        for kind in CELLS:
            out[f"{name}/{kind}"] = (arch, kw, merged, kind)
    out["mamba2/decode"] = ("mamba2-2.7b", {}, False, "decode")
    return {k: {"arch": a, "overrides": _reduced(a, **kw), "merged": m,
                "kind": kind, "cell": CELLS[kind],
                "batch": SIZES[kind][0], "seq_len": SIZES[kind][1]}
            for k, (a, kw, m, kind) in out.items()}


CASES = _cases()

# the heads case: 3 kv heads that a model axis of 2 does not divide
HEADS = dict(d_model=96, n_heads=6, n_kv_heads=3, dtype="float32",
             param_dtype="float32", block_style="skipless")
HEADS_SERVE = {"sc": dict(n_slots=4, max_len=48), "max_new": 6,
               "prompts": [[(3 * i + 7 * j) % 128 for j in range(n)]
                           for i, n in enumerate((5, 11, 3, 8))]}
HEADS_TRAIN = {"trainer": dict(steps=3, log_every=1, ckpt_every=1,
                               keep_ckpts=10, lr=1e-3, warmup=1),
               "data": dict(global_batch=4, seq_len=16, seed=0)}


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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("collectives"))
    with open(os.path.join(data, "cases.json"), "w") as f:
        json.dump(CASES, f)
    # the heads case: JAX weights (source and qp merge) and the JAX
    # Trainer's run, a checkpoint at every step
    jm = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**HEADS)
    params = jax_init_params(jax.random.PRNGKey(0), jm)
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    mp, mc = jax_merge(params, jm, "qp")
    models, cfgs = {}, {}
    for name, (c, p) in (("source", (jm, params)), ("merged", (mc, mp))):
        _save_tree(os.path.join(data, f"heads_{name}.npz"),
                   jax.tree.map(np.asarray, p))
        cfgs[name] = dict(HEADS, block_style=c.block_style,
                          merged_variant=c.merged_variant)
        models[name] = (c, p)
    jtrainer = jtr.Trainer(jm, jtr.TrainerConfig(
        ckpt_dir=os.path.join(data, "jax_ck"), **HEADS_TRAIN["trainer"]),
        jtr.DataConfig(**HEADS_TRAIN["data"]))
    jtrainer.run()
    with open(os.path.join(data, "heads.json"), "w") as f:
        json.dump(dict(HEADS_SERVE, cfgs=cfgs, train_cfg=HEADS,
                       trainer={k: v for k, v in
                                HEADS_TRAIN["trainer"].items()},
                       data=HEADS_TRAIN["data"]), f)

    procs = []
    for group, (mesh, world, tasks) in GROUPS.items():
        for r in range(world):
            log = open(os.path.join(data, f"{group}_{r}.log"), "w")
            n = 2 if group.startswith("fake") and "known" in tasks else world
            procs.append((group, log, subprocess.Popen(
                [sys.executable, WORKER, data, group, str(r), str(n), mesh,
                 tasks], stdout=log, stderr=subprocess.STDOUT, env=_env())))
    # meanwhile, the JAX engines' streams
    prompts = [np.asarray(p, np.int32) for p in HEADS_SERVE["prompts"]]
    jsc = JaxServeConfig(**HEADS_SERVE["sc"])
    want = {name: [list(map(int, o)) for o in JaxEngine(c, p, jsc).generate(
        prompts, max_new_tokens=HEADS_SERVE["max_new"])]
        for name, (c, p) in models.items()}
    codes = {}
    for group, log, p in procs:
        try:
            codes.setdefault(group, []).append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.setdefault(group, []).append("timeout")
        log.close()
    results = {}
    for group, (_, world, _) in GROUPS.items():
        ranks = []
        for r in range(world):
            path = os.path.join(data, f"{group}_{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {})
        if codes[group] != [0] * world:
            logs = "".join(open(os.path.join(data, f"{group}_{r}.log"))
                           .read()[-3000:] for r in range(world))
            ranks[0]["failure"] = f"exit {codes[group]}: {logs}"
        results[group] = ranks
    return {"groups": results, "jax_streams": want,
            "jax_losses": {m["step"]: m["loss"]
                           for m in jtrainer.metrics_log}}


def _ranks(run, group):
    ranks = run["groups"][group]
    assert "failure" not in ranks[0], ranks[0].get("failure")
    return ranks


def _only(rec, op, n, nbytes):
    c = rec["collectives"]
    assert c["counts"] == {k: (n if k == op else 0) for k in c["counts"]}
    assert c["per_op_bytes"] == {k: (nbytes if k == op else 0)
                                 for k in c["per_op_bytes"]}
    assert c["total_bytes"] == nbytes
    assert c["by_link"] == {"nvlink": nbytes, "network": 0}  # ranks 0, 1


@pytest.mark.parametrize("group", ["c12", "fake12"])
def test_the_counter_on_cases_with_a_known_answer(run, group):
    k = {"B": 2, "S": 3, "F": 8, "D": 5, "G": 4, "H": 3}
    known = _ranks(run, group)[0]["known"]
    # (B, S, F) x (F, D), F split over 2 ranks: a pending sum of B·S·D
    # float32, all-reduced once; the FLOPs are the local (B·S, F/2) x
    # (F/2, D) product's, not the global one's
    _only(known["row_parallel"], "all-reduce", 1, k["B"] * k["S"] * k["D"]
          * 4)
    assert known["row_parallel"]["flops"] == \
        2 * k["B"] * k["S"] * (k["F"] // 2) * k["D"]
    # (G, 8) split on dim 0: each rank sends its (G/2, 8) shard
    _only(known["all_gather"], "all-gather", 1, k["G"] // 2 * 8 * 4)
    # the maxima (B, H), then the sums (B, H, D) and normalisers (B, H)
    _only(known["combine_softmax"], "all-reduce", 2,
          (k["B"] * k["H"] + k["B"] * k["H"] * (k["D"] + 1)) * 4)


def test_a_fake_group_counts_what_gloo_moves(run):
    assert _ranks(run, "fake12")[0]["known"] == \
        _ranks(run, "c12")[0]["known"]
    assert _ranks(run, "c12")[1]["known"] == _ranks(run, "c12")[0]["known"]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_predicted_equals_moved(run, mesh, case):
    real, fake = MESHES[mesh]
    moved = [r["steps"][case] for r in _ranks(run, real)]
    predicted = _ranks(run, fake)[0]["predict"][case]
    assert all(m == moved[0] for m in moved[1:]), moved
    for key in ("counts", "per_op_bytes", "total_bytes", "by_link"):
        assert predicted[key] == moved[0][key], (key, predicted, moved[0])
    if mesh == "1x2" or CASES[case]["kind"] != "decode":
        assert sum(moved[0]["counts"].values()) > 0


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("model", ["source", "merged"])
def test_heads_the_model_axis_does_not_divide_give_the_jax_streams(
        run, model, impl):
    res = _ranks(run, "c12")
    for r in res:
        assert r["heads"][f"{model}/{impl}"] == run["jax_streams"][model]
    # the projections stay split over "model" (a 48-column wk)
    assert res[0]["heads"][f"{model}/wk"] == "(Replicate(), Shard(dim=2))"


def test_heads_the_model_axis_does_not_divide_give_the_jax_losses(run):
    for r in _ranks(run, "c12"):
        losses = {int(k): v for k, v in r["heads"]["train_losses"].items()}
        assert sorted(losses) == [2, 3]
        for s, v in losses.items():
            want = run["jax_losses"][s]
            assert abs(v - want) <= RTOL * abs(want), (s, v, want)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "moonshot-v1-16b-a3b"])
@pytest.mark.parametrize("group", ["c22", "c21"])
def test_meshed_gradients_equal_the_unmeshed(run, group, arch):
    for r in _ranks(run, group):
        got = r["grads"][arch]
        meshed, plain = got["loss"]
        assert abs(meshed - plain) <= RTOL * abs(plain), got
        assert got["grad_rel"] <= RTOL, got

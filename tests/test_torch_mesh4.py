"""The port on four-rank meshes of CPU processes (gloo), (1, 4) and
(4, 1), held against the JAX package without a mesh, from the same numpy
and JAX seeds:

  * ``Engine`` on the dense cache, the paged pool and the int8 pool, the
    source and the qp-merged skipless Mistral-7B (reduced, cut to one
    layer so that the file runs alone within a minute), in two layouts:
    4 kv heads, which a model axis of 4 divides (MHA: G = 1), and 2,
    which it does not (whole heads on every rank): greedy streams equal
    to the JAX ``Engine``'s on the same cache kind;
  * ``ScheduledEngine`` on the three caches (the 4-kv-head models): the
    JAX engines' streams (the JAX ``ScheduledEngine``'s on the int8
    pool);
  * the kernel route (``impl="cuda"``, the device rule lifted so that each
    wrapper runs its plain version on the rank's shards): the JAX streams,
    and every logit it samples from within ``RTOL`` of the "torch"
    route's engine's;
  * (1, 4): Hymba-1.5B and Phi-3.5-MoE (reduced, one layer, the JAX
    package's weights) give the JAX engine's streams; the seams that keep
    DTensor's planner off the eager work (the encoder's convolution on a
    sequence-split input, the "torch" route's attention at G = 1 on
    head-split q/k/v and on a sequence-split decode cache) equal the same
    calls on whole tensors;
  * (4, 1): ``Trainer(mesh=)`` resumed from the JAX ``Trainer``'s step-1
    checkpoint gives the JAX losses within ``RTOL``;
  * ``chip_smoke_4.py`` refuses to start without four CUDA cards.

No process group is started in the test process: each mesh is one spawn
of four ranks (``tests/_torch_mesh4_worker.py``, gloo over a ``file://``
rendezvous in ``tmp_path``, ``OMP_NUM_THREADS=1``) that carries every
case, while the test process computes the JAX references."""
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
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import SchedConfig as JaxSchedConfig
from repro.serving import ScheduledEngine as JaxScheduledEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
WORKER = os.path.join(HERE, "_torch_mesh4_worker.py")
SRC = os.path.join(ROOT, "src")
RTOL = 1e-5  # tests/test_torch_dist.py's
TIMEOUT = 150

MESHES = {"1x4": "serve,kernels,families,seams", "4x1": "serve,kernels,train"}
LAYOUTS = {"kv4": 4, "kv2": 2}  # kv heads; a model axis of 4 divides 4 only
STYLES = ("source", "merged")
CACHES = ("dense", "paged", "paged_q8")
KERNEL_CASES = [("kv4", "merged", "dense"), ("kv4", "merged", "paged_q8"),
                ("kv4", "source", "paged"), ("kv2", "merged", "dense")]
SERVE = {"n_slots": 4, "max_len": 48, "max_new": 3, "block_size": 8,
         "sched": dict(token_budget=16, chunk_tokens=8),
         "prompts": [[(3 * i + 7 * j) % 128 for j in range(n)]
                     for i, n in enumerate((5, 11, 3, 8))],
         "sched_layouts": ["kv4"], "kernel_cases": KERNEL_CASES}
TRAIN = {"steps": 3,
         "trainer": dict(log_every=1, ckpt_every=1, keep_ckpts=10, lr=1e-3,
                         warmup=1),
         "data": dict(global_batch=4, seq_len=16, seed=0)}
FAMILIES = {"phi3.5-moe-42b-a6.6b": "skipless", "hymba-1.5b": "skipless"}
FAMILY_SERVE = {"sc": dict(n_slots=4, max_len=32, block_size=8),
                "max_new": 5}
SEAMS = ("conv_pos", "prefill_g1", "decode_g1")


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


def _publish(data, name, content):
    """``content`` (str or bytes) to ``data/name``, whole or not at all."""
    part = os.path.join(data, name + ".part")
    with open(part, "wb" if isinstance(content, bytes) else "w") as f:
        f.write(content)
    os.replace(part, os.path.join(data, name))


def _streams(outs):
    return [list(map(int, o)) for o in outs]


def _adapter(cache):
    bs = SERVE["block_size"]
    return {"paged": lambda: JaxPagedAdapter(block_size=bs),
            "paged_q8": lambda: JaxQ8Adapter(block_size=bs)}[cache]()


def _families(data):
    """The JAX weights of Hymba and Phi-3.5-MoE (reduced, one layer),
    saved for the workers with the port's config and the prompts."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in (5, 9, 3)]
    models = {}
    for i, (arch, style) in enumerate(FAMILIES.items()):
        jc = jcfg.reduce_config(jcfg.get_config(arch)).with_(
            block_style=style, dtype="float32", param_dtype="float32",
            n_layers=1)
        p = jax.tree.map(np.asarray,
                         jax_init_params(jax.random.PRNGKey(i), jc))
        tc = tcfg.ModelConfig(**{f.name: getattr(jc, f.name)
                                 for f in dataclasses.fields(jc)})
        models[arch] = (jc, tc, p)
    spec = dict(FAMILY_SERVE, prompts=prompts, vision=None,
                models={a: (tc, p) for a, (_, tc, p) in models.items()})
    _publish(data, "families.pkl", pickle.dumps(spec))
    return models, prompts


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("mesh4"))
    # the ranks start first and wait for their inputs, each of which
    # appears whole (``_publish``) after the files it names
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu")
    procs = []
    for shape, tasks in MESHES.items():
        for r in range(4):
            log = open(os.path.join(data, f"{shape}_{r}.log"), "w")
            procs.append((shape, log, subprocess.Popen(
                [sys.executable, WORKER, data, str(r), shape, tasks],
                stdout=log, stderr=subprocess.STDOUT, env=env)))
    mistral, cfgs = {}, {}
    for layout, kv in LAYOUTS.items():
        base = dict(block_style="skipless", dtype="float32",
                    param_dtype="float32", n_kv_heads=kv, n_layers=1)
        jm = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(**base)
        params = jax_init_params(jax.random.PRNGKey(0), jm)
        params["embed"]["table"] = params["embed"]["table"] * 50.0
        mp, mc = jax_merge(params, jm, "qp")
        for style, (c, p) in zip(STYLES, ((jm, params), (mc, mp))):
            _save_tree(os.path.join(data, f"serve_{layout}_{style}.npz"),
                       jax.tree.map(np.asarray, p))
            cfgs.setdefault(layout, {})[style] = dict(
                base, block_style=c.block_style,
                merged_variant=c.merged_variant)
            mistral[(layout, style)] = (c, p)
    _publish(data, "serve.json", json.dumps(dict(SERVE, cfgs=cfgs)))
    families, fprompts = _families(data)

    # meanwhile, the JAX Trainer, a checkpoint at every step ((4, 1)
    # resumes its first once ``train.json`` appears), then the JAX
    # engines' streams
    jc = jcfg.reduce_config(jcfg.get_config("llama3.2-1b"))
    jtrainer = jtr.Trainer(jc, jtr.TrainerConfig(
        ckpt_dir=os.path.join(data, "jax_ck"), steps=TRAIN["steps"],
        **TRAIN["trainer"]), jtr.DataConfig(**TRAIN["data"]))
    jtrainer.run()
    _publish(data, "train.json", json.dumps(TRAIN))
    prompts = [np.asarray(p, np.int32) for p in SERVE["prompts"]]
    jsc = JaxServeConfig(n_slots=SERVE["n_slots"], max_len=SERVE["max_len"])
    new = SERVE["max_new"]
    # the fp caches' streams are one set in the JAX package, for both
    # styles and both engines (its own contract: merged == source, paged
    # == dense, scheduled == synchronous, tested there), which its source
    # Engine on the dense cache gives; the int8 pool's part by style and
    # by chunking, and each gets its own JAX engine
    fp = {layout: _streams(JaxEngine(*mistral[(layout, "source")],
                                     jsc).generate(prompts,
                                                   max_new_tokens=new))
          for layout in LAYOUTS}
    want = {}
    for (layout, style), (c, p) in mistral.items():
        for cache in CACHES:
            key = f"{layout}/{style}/{cache}"
            if cache != "paged_q8":
                want[f"{key}/engine"] = want[f"{key}/sched"] = fp[layout]
                continue
            want[f"{key}/engine"] = _streams(JaxEngine(
                c, p, jsc, cache=_adapter(cache)).generate(
                    prompts, max_new_tokens=new))
            if layout in SERVE["sched_layouts"]:
                want[f"{key}/sched"] = _streams(JaxScheduledEngine(
                    c, p, jsc, scfg=JaxSchedConfig(**SERVE["sched"]),
                    impl="xla", cache=_adapter(cache)).generate(
                        prompts, max_new_tokens=new))
    for arch, (fjc, _, p) in families.items():
        want[arch] = _streams(JaxEngine(
            fjc, p, JaxServeConfig(**FAMILY_SERVE["sc"]),
            impl="xla").generate(fprompts,
                                 max_new_tokens=FAMILY_SERVE["max_new"]))

    codes = {}
    for shape, log, p in procs:
        try:
            codes.setdefault(shape, []).append(p.wait(timeout=TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.setdefault(shape, []).append("timeout")
        log.close()
    results = {}
    for shape in MESHES:
        ranks = []
        for r in range(4):
            path = os.path.join(data, f"{shape}_{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {})
        if codes[shape] != [0] * 4:
            logs = "".join(open(os.path.join(data, f"{shape}_{r}.log"))
                           .read()[-3000:] for r in range(4))
            ranks[0]["failure"] = f"exit {codes[shape]}: {logs}"
        results[shape] = ranks
    yield {"ranks": results, "want": want, "jax_train": jtrainer}
    if os.environ.get("MESH4_KEEP") is None:
        shutil.rmtree(data, ignore_errors=True)
    else:
        print("mesh4 data:", data)


def _rank0(run, shape):
    res = run["ranks"][shape][0]
    assert "failure" not in res, res.get("failure")
    return res


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_engine_on_four_ranks_gives_the_jax_engine_streams(run, shape,
                                                           layout, style,
                                                           cache):
    key = f"{layout}/{style}/{cache}/engine"
    assert _rank0(run, shape)["serve"][key] == run["want"][key]


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_scheduler_on_four_ranks_gives_the_jax_streams(run, shape, style,
                                                       cache):
    key = f"kv4/{style}/{cache}/sched"
    assert _rank0(run, shape)["serve"][key] == run["want"][key]


@pytest.mark.parametrize("case", KERNEL_CASES, ids="/".join)
@pytest.mark.parametrize("shape", sorted(MESHES))
def test_kernel_route_on_four_ranks_gives_the_torch_route_logits(run, shape,
                                                                 case):
    """The wrappers' plain versions on each rank's shards (heads for a
    prefill, a sequence slice or the rank's pages for a decode step,
    combined over the model axis): the JAX streams, and the "torch"
    route's logits within ``RTOL`` of its largest."""
    key = "/".join(case)
    got = _rank0(run, shape)["kernels"][key]
    assert got["streams"] == run["want"][f"{key}/engine"]
    assert got["logits_rel"] is not None and got["logits_rel"] <= RTOL, got


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_other_families_on_a_model_axis_of_4_give_the_jax_streams(run,
                                                                  arch):
    assert _rank0(run, "1x4")["families"][arch] == run["want"][arch]


def test_trainer_on_four_data_ranks_gives_the_jax_losses(run):
    res = _rank0(run, "4x1")
    losses = {int(k): v for k, v in res["train_losses"].items()}
    jax_losses = {m["step"]: m["loss"] for m in run["jax_train"].metrics_log}
    assert sorted(losses) == list(range(2, TRAIN["steps"] + 1))
    for s, v in losses.items():
        assert abs(v - jax_losses[s]) / abs(jax_losses[s]) <= RTOL, \
            (s, v, jax_losses[s])


@pytest.mark.parametrize("seam", SEAMS)
def test_seams_on_split_inputs_equal_the_whole_call(run, seam):
    """On a model axis of 4: the convolution's sequence-split input and
    the attention cores' head-split (prefill) or sequence-split (decode)
    operands give the whole call's output."""
    got = _rank0(run, "1x4")["seams"][seam]
    assert got["rel"] <= RTOL, got


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_every_rank_emits_the_same_tokens(run, shape):
    ranks = run["ranks"][shape]
    _rank0(run, shape)
    for r in ranks[1:]:
        assert r["serve"] == ranks[0]["serve"]
        assert {k: v["streams"] for k, v in r["kernels"].items()} == \
            {k: v["streams"] for k, v in ranks[0]["kernels"].items()}


def test_the_four_card_script_refuses_without_four_cards():
    """Here (no CUDA card) ``chip_smoke_4.py`` exits non-zero and prints no
    result line; it falls back to nothing."""
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke_4.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert r.returncode != 0
    assert "needs four CUDA cards" in r.stderr or "needs 4" in r.stderr, \
        r.stderr
    assert '"ok"' not in r.stdout

"""One rank of a four-rank gloo process group for
``tests/test_torch_mesh4.py``: the port's engines and trainer on a (1, 4)
or (4, 1) mesh of CPU processes.  Run as

  python tests/_torch_mesh4_worker.py <data dir> <rank> <mesh: 1x4 or 4x1>
      <task,task,...>

The rendezvous is ``file://<data dir>/pg_<mesh>``; each rank writes
``<data dir>/<mesh>_<rank>.json`` (its results and each task's
seconds)."""
import json
import os
import sys
import time
import traceback
import warnings

import numpy as np

warnings.filterwarnings("ignore")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_dist_worker import (_recording, _streams, load_tree,  # noqa: E402
                                task_families, task_train)

torch.set_num_threads(1)

# the logits each "torch"-route Engine sampled from, by case
_TORCH_LOGITS = {}


def _wait_for(data, name, seconds=120):
    """The test process writes the ranks' inputs while they start; each
    input's file (``name``) appears, whole, after what it names."""
    deadline = time.time() + seconds
    while not os.path.exists(os.path.join(data, name)):
        if time.time() > deadline:
            raise TimeoutError(f"{name} never appeared")
        time.sleep(0.1)


def _models(data):
    """(layout, style) -> (config, params) of the reduced Mistral-7B models
    the test process saved (``serve.json``, ``serve_<layout>_<style>.npz``)."""
    from repro_torch.configs import get_config, reduce_config
    _wait_for(data, "serve.json")
    spec = json.load(open(os.path.join(data, "serve.json")))
    base = reduce_config(get_config("mistral-7b"))
    return spec, {
        (layout, style): (base.with_(**kw), load_tree(os.path.join(
            data, f"serve_{layout}_{style}.npz")))
        for layout, styles in spec["cfgs"].items()
        for style, kw in styles.items()}


def _engines(spec, cfg, params, cache, mesh, impl, sched):
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)
    sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"],
                     block_size=spec["block_size"])
    kw = dict(impl=impl, device="cpu", cache=cache, mesh=mesh)
    if sched:
        return ScheduledEngine(cfg, params, sc, SchedConfig(**spec["sched"]),
                               **kw)
    return Engine(cfg, params, sc, **kw)


def task_serve(data, mesh, res):
    """The "torch" route: every model on the dense cache and both pools
    through ``Engine`` (its sampled logits recorded) and, for the models
    whose kv heads the model axis divides, ``ScheduledEngine``."""
    spec, models = _models(data)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out, secs = {}, {}
    for (layout, style), (cfg, params) in models.items():
        for cache in ("dense", "paged", "paged_q8"):
            key = f"{layout}/{style}/{cache}"
            t0 = time.perf_counter()
            eng = _recording(_engines(spec, cfg, params, cache, mesh, "torch",
                                      False),
                             _TORCH_LOGITS.setdefault(key, []))
            out[f"{key}/engine"] = _streams(eng.generate(
                prompts, max_new_tokens=spec["max_new"]))
            secs[f"{key}/engine"] = time.perf_counter() - t0
            if layout in spec["sched_layouts"]:
                t0 = time.perf_counter()
                eng = _engines(spec, cfg, params, cache, mesh, "torch", True)
                out[f"{key}/sched"] = _streams(eng.generate(
                    prompts, max_new_tokens=spec["max_new"]))
                secs[f"{key}/sched"] = time.perf_counter() - t0
    res["serve"], res["serve_seconds"] = out, secs


def task_kernels(data, mesh, res):
    """The kernel route (``impl="cuda"``) on CPU tensors, the device rule
    lifted (``serving.engine._IMPL_DEVICE``) so that each wrapper runs its
    plain version on the rank's shards: ``spec["kernel_cases"]``'s
    engines, their streams and the largest difference of their sampled
    logits from the "torch" route's (``task_serve``), relative to its
    largest logit."""
    from repro_torch.serving import engine as serving_engine

    spec, models = _models(data)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {}
    lifted = dict(serving_engine._IMPL_DEVICE)
    serving_engine._IMPL_DEVICE["cuda"] = "cpu"
    try:
        for layout, style, cache in spec["kernel_cases"]:
            key = f"{layout}/{style}/{cache}"
            cfg, params = models[(layout, style)]
            logits = []
            eng = _recording(_engines(spec, cfg, params, cache, mesh, "cuda",
                                      False), logits)
            got = _streams(eng.generate(prompts,
                                        max_new_tokens=spec["max_new"]))
            a, b = torch.cat(logits), torch.cat(_TORCH_LOGITS[key])
            out[key] = {"streams": got, "logits_rel": float(
                (a - b).abs().max() / b.abs().max())
                if a.shape == b.shape else None}
    finally:
        serving_engine._IMPL_DEVICE.update(lifted)
    res["kernels"] = out


def task_seams(data, mesh, res):
    """The two seams that keep DTensor's planner off the eager work where
    the model axis splits a head or sequence dim: the encoder's
    convolution on a sequence-split input (``placed.rows_call``), and the
    "torch" route's attention cores at G = 1 (MHA) on head-split q/k/v
    (``heads_call``) and on a sequence-split decode cache (``split_k_call``),
    each against the same call on whole tensors: the largest difference,
    relative to the largest |output|."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distribution.placed import full, on_mesh
    from repro_torch.models import attention
    from repro_torch.models.layers import apply_conv_pos

    g = torch.Generator().manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def split(x, dim):
        return distribute_tensor(x, mesh, [Replicate(), Shard(dim)])

    def rel(a, b):
        return float((full(a) - b).abs().max() / b.abs().max())

    out = {}
    B, S, D, W = 2, 12, 8, 5
    conv = {"kernel": randn(W, 1, D), "bias": randn(D)}
    x = randn(B, S, D)
    placed = {k: distribute_tensor(v, mesh, [Replicate(), Replicate()])
              for k, v in conv.items()}
    with on_mesh(mesh):
        got = apply_conv_pos(placed, split(x, 1))
    out["conv_pos"] = {"rel": rel(got, apply_conv_pos(conv, x)),
                       "placements": str(got.placements)}
    H, Dh, Sk = 4, 16, 16
    q, k, v = randn(B, S, H, Dh), randn(B, S, H, Dh), randn(B, S, H, Dh)
    pos = torch.arange(S)[None].expand(B, S)
    kw = dict(q_positions=pos, kv_positions=pos, causal=True, impl="torch")
    with on_mesh(mesh):
        got = attention.attention_core(split(q, 2), split(k, 2), split(v, 2),
                                       **kw)
    out["prefill_g1"] = {"rel": rel(got, attention.attention_core(q, k, v,
                                                                  **kw)),
                         "placements": str(got.placements)}
    qd, kc, vc = randn(B, H, Dh), randn(B, Sk, H, Dh), randn(B, Sk, H, Dh)
    kvp = torch.arange(Sk, dtype=torch.int32)[None].repeat(B, 1)
    kvp[1, 10:] = -1  # row 1: an unwritten tail
    qp = torch.tensor([Sk - 1, 9], dtype=torch.int32)
    dkw = dict(q_position=qp, impl="torch")
    with on_mesh(mesh):
        got = attention.decode_attention_core_positions(
            qd, split(kc, 1), split(vc, 1), kv_positions=split(kvp, 1),
            **dkw)
    out["decode_g1"] = {"rel": rel(got, attention.
                                   decode_attention_core_positions(
                                       qd, kc, vc, kv_positions=kvp, **dkw)),
                        "placements": str(got.placements)}
    res["seams"] = out


def _families(data, mesh, res):
    """``tests/_torch_dist_worker.py``'s ``task_families`` on the families
    of ``families.pkl``."""
    _wait_for(data, "families.pkl")
    task_families(data, None, mesh, res)


def _train(data, mesh, res):
    """``tests/_torch_dist_worker.py``'s ``task_train`` once the test
    process has written the JAX Trainer's checkpoints (``train.json``
    appears after them)."""
    _wait_for(data, "train.json")
    task_train(data, "mesh4", mesh, res)


TASKS = {"serve": task_serve, "kernels": task_kernels, "seams": task_seams,
         "families": _families, "train": _train}


def main():
    data, rank, shape, tasks = sys.argv[1:5]
    rank = int(rank)
    res = {"rank": rank, "seconds": {}}
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        data, "pg_" + shape), rank=rank, world_size=4)
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(*(int(x) for x in shape.split("x")),
                              device_type="cpu")
        for t in tasks.split(","):
            t0 = time.perf_counter()
            try:
                TASKS[t](data, mesh, res)
            except Exception:
                res[t + "_error"] = traceback.format_exc()
                raise
            res["seconds"][t] = time.perf_counter() - t0
    finally:
        with open(os.path.join(data, f"{shape}_{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

"""One rank of a gloo process group for ``tests/test_torch_dist.py``: the
port's ``Trainer``, ``Engine`` and ``ScheduledEngine`` on a device mesh
over CPU processes.  Run as

  python tests/_torch_dist_worker.py <data dir> <group> <rank> <world>
      <mesh, e.g. 2x2 or 2x2x2> <task,task,...>

The rendezvous is ``file://<data dir>/pg_<group>`` (no port to clash);
each rank writes ``<data dir>/<group>_<rank>.json`` (its results, each
task's seconds and the rank's CPU seconds)."""
import json
import os
import resource
import shutil
import sys
import time
import traceback
import warnings

import numpy as np

warnings.filterwarnings("ignore")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)


def load_tree(path):
    """A nested dict of tensors from an npz keyed by '/'-joined paths."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(z[key].copy())
    return out


def save_tree(path, tree, prefix=""):
    flat = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, p + (k,))
        else:
            flat["/".join(p)] = t.detach().cpu().numpy()

    walk(tree, ())
    np.savez(path, **flat)


def mesh_of(shape):
    from repro_torch.launch.mesh import make_mesh
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_mesh(shape, axes, device_type="cpu")


def task_train(data, tag, mesh, res):
    """Resume the JAX run's step-1 checkpoint on the mesh, to the last
    step (one step on a 3-d mesh).  First, at step 1: the loss of
    ``build_step``'s train step with its re-anchors (the stream
    sequence-parallel over "model", q/k/v over heads, the logits over
    vocab), which the test holds against the unmeshed step's."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.placed import full, on_mesh
    from repro_torch.launch import steps
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    spec = json.load(open(os.path.join(data, "train.json")))
    cfg = reduce_config(get_config("llama3.2-1b"))
    ck = os.path.join(data, f"ck_train_{tag}")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(data, "jax_ck", "step_00000001"),
                        os.path.join(ck, "step_00000001"))
    dist.barrier()
    n_steps = spec["steps"] if len(mesh.mesh.shape) == 2 else 2
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=ck, steps=n_steps,
                                    **spec["trainer"]),
                 DataConfig(**spec["data"]), device="cpu", mesh=mesh)
    assert tr.start_step == 1, tr.start_step
    with on_mesh(mesh):
        fn, _ = steps.build_step(
            cfg, "train", stream_sharding=shd.stream_pspec(tr.rules),
            qkv_sharding=shd.qkv_pspec(tr.rules),
            logits_sharding=shd.logits_pspec(tr.rules))
        params = tree_map(lambda t: t.clone(), tr.params)
        _, _, m = fn(params, tr.optimizer.init(params), tr._batch(1))
        res["anchored_loss"] = float(full(m["loss"]))
    tr.run()
    res["train_losses"] = {m["step"]: m["loss"] for m in tr.metrics_log}
    host = tr.host_params()
    if dist.get_rank() == 0:
        save_tree(os.path.join(data, f"train_{tag}.npz"), host)
    res["train_placements"] = str(
        tr.params["layers"]["ffn"]["w_up"].placements)


def task_elastic(data, tag, mesh, res):
    """Checkpoint at step 2 on (2, 2), resume on (1, 4); against a
    straight (1, 4) run."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    cfg = reduce_config(get_config("llama3.2-1b"))
    dc = DataConfig(global_batch=4, seq_len=16, seed=0)
    ck = os.path.join(data, "ck_elastic")
    kw = dict(steps=4, log_every=2, ckpt_every=2, ckpt_dir=ck, lr=1e-3,
              warmup=1)
    Trainer(cfg, TrainerConfig(stop_after=2, **kw), dc, device="cpu",
            mesh=mesh).run()
    m14 = mesh_of((1, 4))
    tr2 = Trainer(cfg, TrainerConfig(**kw), dc, device="cpu", mesh=m14)
    res["elastic_start"] = tr2.start_step
    tr2.run()
    straight = os.path.join(data, "ck_elastic_straight")
    tr3 = Trainer(cfg, TrainerConfig(**dict(kw, ckpt_dir=straight,
                                            ckpt_every=100)), dc,
                  device="cpu", mesh=m14)
    tr3.run()
    a, b = tr2.host_params(), tr3.host_params()
    res["elastic_rel"] = max(float((x - y).norm() / y.norm())
                             for x, y in zip(tree_leaves(a), tree_leaves(b)))
    res["elastic_loss"] = [tr2.metrics_log[-1]["loss"],
                           tr3.metrics_log[-1]["loss"]]


def _serve_models(data):
    from repro_torch.configs import get_config, reduce_config
    spec = json.load(open(os.path.join(data, "serve.json")))
    base = get_config("mistral-7b")
    out = {}
    for name, kw in spec["cfgs"].items():
        out[name] = (reduce_config(base).with_(**kw),
                     load_tree(os.path.join(data, f"serve_{name}.npz")))
    return spec, out


def task_serve(data, tag, mesh, res):
    """Engine and ScheduledEngine, source and merged, dense cache."""
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)

    spec, models = _serve_models(data)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {}
    for name, (cfg, params) in models.items():
        sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"])
        eng = Engine(cfg, params, sc, impl="torch", device="cpu", mesh=mesh)
        out[f"{name}/engine"] = [list(map(int, o)) for o in eng.generate(
            prompts, max_new_tokens=spec["max_new"])]
        out[f"{name}/engine_fast_path"] = eng.merged_fast_path
        eng = ScheduledEngine(cfg, params, sc, SchedConfig(**spec["sched"]),
                              impl="torch", device="cpu", mesh=mesh)
        out[f"{name}/sched"] = [list(map(int, o)) for o in eng.generate(
            prompts, max_new_tokens=spec["max_new"])]
        out[f"{name}/placements"] = {
            "k": str(eng.kv.device_cache().k.placements),
            "wk": str(eng.params["layers"]["attn"]["wk"].placements)}
    res["serve"] = out


def task_families(data, tag, mesh, res):
    """The other families on this mesh, on the dense cache: MoE, hybrid,
    SSM and the VLM with its vision tokens, from the JAX package's weights
    (``families.pkl``); their greedy streams, which the test holds against
    the JAX engine's and the unmeshed port's.  Then the refusals: the
    paged pools (NotImplementedError), ``impl="cuda"`` (ValueError) and a
    kernel wrapper given a DTensor (TypeError)."""
    import pickle

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.convert import to_torch
    from repro_torch.models import init_params
    from repro_torch.serving import Engine, ServeConfig

    with open(os.path.join(data, "families.pkl"), "rb") as f:
        spec = pickle.load(f)
    sc = ServeConfig(**spec["sc"])
    out = {}
    for arch, (cfg, w) in spec["models"].items():
        eng = Engine(cfg, to_torch(w, device="cpu"), sc, impl="torch",
                     device="cpu", mesh=mesh)
        out[arch] = [list(map(int, o)) for o in eng.generate(
            spec["prompts"], max_new_tokens=spec["max_new"],
            vision=spec["vision"] if cfg.n_vision_tokens else None)]
    cfg = reduce_config(get_config("mistral-7b"))
    params = init_params(cfg, seed=0, device="cpu")
    for kind in ("paged", "paged_q8"):
        try:
            Engine(cfg, params, sc, impl="torch", device="cpu", cache=kind,
                   mesh=mesh)
            out[kind] = "ran"
        except NotImplementedError as e:
            out[kind] = "NotImplementedError: " + str(e)
    try:
        Engine(cfg, params, sc, impl="cuda", device="cpu", mesh=mesh)
        out["cuda"] = "ran"
    except ValueError as e:
        out["cuda"] = "ValueError: " + str(e)
    # a kernel wrapper given a DTensor raises before any reshape
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels import ops
    q = DTensor.from_local(torch.zeros(2, 4, 16), mesh,
                           [Replicate()] * mesh.ndim)
    kv = DTensor.from_local(torch.zeros(2, 8, 4, 16), mesh,
                            [Replicate()] * mesh.ndim)
    pos = torch.zeros(2, 8, dtype=torch.int32)
    try:
        ops.decode_attention(q, kv, kv, kv_positions=pos,
                             q_position=torch.zeros(2, dtype=torch.int32))
        out["wrapper"] = "ran"
    except TypeError as e:
        out["wrapper"] = "TypeError: " + str(e)
    res["families"] = out


TASKS = {"train": task_train, "elastic": task_elastic, "serve": task_serve,
         "families": task_families}


def main():
    data, group, rank, world, shape, tasks = sys.argv[1:7]
    rank, world = int(rank), int(world)
    shape = tuple(int(x) for x in shape.split("x"))
    res = {"rank": rank}
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        data, "pg_" + group), rank=rank, world_size=world)
    try:
        mesh = mesh_of(shape)
        for t in tasks.split(","):
            t0 = time.perf_counter()
            try:
                TASKS[t](data, group, mesh, res)
                res.setdefault("seconds", {})[t] = time.perf_counter() - t0
            except Exception:
                res[t + "_error"] = traceback.format_exc()
                raise
    finally:
        res["cpu_s"] = resource.getrusage(resource.RUSAGE_SELF).ru_utime
        with open(os.path.join(data, f"{group}_{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

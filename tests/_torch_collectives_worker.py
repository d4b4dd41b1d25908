"""One process of ``tests/test_torch_collectives.py``: a rank of a gloo
group, or a process over torch's fake backend, counting collectives with
``repro_torch.distribution.collectives.StepCounter``.  Run as

  python tests/_torch_collectives_worker.py <data dir> <group> <rank>
      <world> <mesh, e.g. 1x2> <task,task,...>

A gloo group meets through ``file://<data dir>/pg_<group>``; a group
named "fake..." starts none (its "known" task runs over a fake group of
``world`` ranks, its "predict" task through ``launch.dryrun.run_cell``,
which starts its own).  Each process writes ``<data dir>/<group>_<rank>
.json``: its results and each task's seconds."""
import json
import os
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

# the known cases: a (B, S, F) x (F, D) product whose F the model axis
# splits, an all-gather of a (G, 8) tensor split on dim 0, the softmax
# states of (B, H) rows of head dim D
KNOWN = {"B": 2, "S": 3, "F": 8, "D": 5, "G": 4, "H": 3}


def task_known(data, mesh, res):
    """The three cases with a known answer, each under its own counter."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distribution.collectives import StepCounter
    from repro_torch.distribution.placed import combine_softmax, on_mesh

    k = KNOWN
    rep = [Replicate()] * mesh.ndim
    model = rep[:-1] + [Shard(2)]
    g = torch.Generator().manual_seed(0)
    x = distribute_tensor(torch.randn(k["B"], k["S"], k["F"], generator=g),
                          mesh, model)
    w = distribute_tensor(torch.randn(k["F"], k["D"], generator=g), mesh,
                          rep[:-1] + [Shard(0)])
    out = {}
    with on_mesh(mesh), StepCounter() as c:
        (x @ w).full_tensor()  # a pending sum over "model": one all-reduce
    out["row_parallel"] = c.record()
    y = distribute_tensor(torch.randn(k["G"], 8, generator=g), mesh,
                          rep[:-1] + [Shard(0)])
    with StepCounter() as c:
        y.full_tensor()
    out["all_gather"] = c.record()
    m = torch.randn(k["B"], k["H"], generator=g)
    lse = torch.rand(k["B"], k["H"], generator=g)
    o = torch.randn(k["B"], k["H"], k["D"], generator=g)
    with StepCounter() as c:
        combine_softmax(m, lse, o, group=mesh.get_group("model"))
    out["combine_softmax"] = c.record()
    res["known"] = out


def _cases(data):
    return json.load(open(os.path.join(data, "cases.json")))


def step_args(cfg, kind, batch, seq_len, merged):
    """Real arguments of ``build_step``'s step, in ``dryrun.meta_args``'
    structure: seeded params (the qp merge of the skipless ones for
    ``merged``), the AdamW state, seeded tokens, an empty dense cache."""
    from repro_torch.core import merge_skipless
    from repro_torch.models import init_cache, init_params
    from repro_torch.training.optimizer import make_optimizer

    params = init_params(cfg, seed=0, device="cpu")
    if merged:
        params, cfg = merge_skipless(params, cfg, "qp")
    g = torch.Generator().manual_seed(1)

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             dtype=torch.int32)

    if kind == "train":
        opt = make_optimizer("adamw", 3e-4, 100, 10_000).init(params)
        return cfg, (params, opt, {"inputs": ids(batch, seq_len),
                                   "labels": ids(batch, seq_len)})
    if kind == "prefill":
        return cfg, (params, {"inputs": ids(batch, seq_len)})
    return cfg, (params, ids(batch), init_cache(cfg, batch, seq_len,
                                                device="cpu"))


def task_steps(data, mesh, res):
    """Each case's step on this gloo mesh, its collectives counted."""
    from repro_torch.configs import get_config
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.collectives import StepCounter
    from repro_torch.distribution.placed import on_mesh
    from repro_torch.launch import dryrun, steps

    out = {}
    for name, case in _cases(data).items():
        base = get_config(case["arch"]).with_(**case["overrides"])
        cfg, args = step_args(base, case["kind"], case["batch"],
                              case["seq_len"], case["merged"])
        rules = shd.make_rules(mesh, batch=case["batch"])
        placed = dryrun.place_args(cfg, case["kind"], args, mesh, rules)
        fn, _ = steps.build_step(cfg, case["kind"])
        with on_mesh(mesh), StepCounter() as c:
            fn(*placed)
        out[name] = c.collectives()
    res["steps"] = out


def task_predict(data, mesh_shape, res):
    """``run_cell``'s record of each case on a CPU mesh of ``mesh_shape``
    over the fake group it starts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    out = {}
    for name, case in _cases(data).items():
        full = get_config(case["arch"])
        cfg = full.with_(**case["overrides"])
        if case["merged"]:  # ``merge_skipless``'s config
            cfg = cfg.with_(block_style="skipless_merged",
                            merged_variant="qp")
        over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                if getattr(cfg, f.name) != getattr(full, f.name)}
        rec = dryrun.run_cell(
            case["arch"], case["cell"], cfg_overrides=over,
            mesh_shape=mesh_shape, device_type="cpu",
            shape_overrides={"global_batch": case["batch"],
                             "seq_len": case["seq_len"]})
        out[name] = rec["collectives"]
    res["predict"] = out


def task_heads(data, mesh, res):
    """A model axis that does not divide the kv heads: ``Engine`` (source
    and merged) on both routes, the kernel route's device rule lifted so
    that its wrappers run their plain versions on each rank's shards, and
    ``Trainer`` resuming the JAX run's step-1 checkpoint."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distribution.placed import full
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving import engine as serving_engine
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    spec = json.load(open(os.path.join(data, "heads.json")))
    base = reduce_config(get_config("mistral-7b"))
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {}
    lifted = dict(serving_engine._IMPL_DEVICE)
    serving_engine._IMPL_DEVICE["cuda"] = "cpu"
    try:
        for name, kw in spec["cfgs"].items():
            cfg = base.with_(**kw)
            params = _load_tree(os.path.join(data, f"heads_{name}.npz"))
            for impl in ("torch", "cuda"):
                eng = Engine(cfg, params, ServeConfig(**spec["sc"]),
                             impl=impl, device="cpu", mesh=mesh)
                out[f"{name}/{impl}"] = [list(map(int, o)) for o in
                                         eng.generate(prompts, max_new_tokens=
                                                      spec["max_new"])]
                out[f"{name}/wk"] = str(eng.params["layers"]["attn"]["wk"]
                                        .placements)
    finally:
        serving_engine._IMPL_DEVICE.update(lifted)
    cfg = base.with_(**spec["train_cfg"])
    ck = os.path.join(data, "ck_heads")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(data, "jax_ck", "step_00000001"),
                        os.path.join(ck, "step_00000001"))
    dist.barrier()
    tr = Trainer(cfg, TrainerConfig(ckpt_dir=ck, **spec["trainer"]),
                 DataConfig(**spec["data"]), device="cpu", mesh=mesh)
    assert tr.start_step == 1, tr.start_step
    tr.run()
    out["train_losses"] = {m["step"]: float(full(m["loss"]))
                           if torch.is_tensor(m["loss"]) else m["loss"]
                           for m in tr.metrics_log}
    res["heads"] = out


# the families whose gradients a (2, 2) mesh checks: every placed seam of
# a train step (the vocabulary-parallel embedding, the SSD scan on each
# rank's heads, the MoE dispatch on each rank's groups)
GRAD_ARCHS = ("llama3.2-1b", "mamba2-2.7b", "moonshot-v1-16b-a3b")


def task_grads(data, mesh, res):
    """One loss and its gradients of each ``GRAD_ARCHS`` config (reduced,
    B 4 x S 16) on this mesh against the same without a mesh: the loss
    gap and each leaf's ||meshed - unmeshed|| / ||unmeshed||, the
    largest."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.placed import full, on_mesh
    from repro_torch.models import init_params
    from repro_torch.training.train_loop import _value_and_grad, make_loss_fn

    out = {}
    for arch in GRAD_ARCHS:
        cfg = reduce_config(get_config(arch))
        params = init_params(cfg, seed=0, device="cpu")
        g = torch.Generator().manual_seed(2)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                                  dtype=torch.int32)
                 for k in ("inputs", "labels")}
        loss_fn = make_loss_fn(cfg)
        m0, g0 = _value_and_grad(loss_fn, params, batch)
        rules = shd.make_rules(mesh, batch=4)
        pp = shd.distribute_tree(params, shd.param_pspecs(params, rules),
                                 mesh)
        pb = {k: shd.place(v, shd.batch_pspec(rules, 1), mesh)
              for k, v in batch.items()}
        with on_mesh(mesh):
            m1, g1 = _value_and_grad(loss_fn, pp, pb)
        rel = max(float((full(a) - b).norm() / b.norm())
                  for a, b in zip(tree_leaves(g1), tree_leaves(g0))
                  if b is not None and float(b.norm()) > 0)
        out[arch] = {"loss": [float(full(m1["loss"])), float(m0["loss"])],
                     "grad_rel": rel}
    res["grads"] = out


def _load_tree(path):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(z[key].copy())
    return out


TASKS = {"known": task_known, "steps": task_steps, "heads": task_heads,
         "grads": task_grads}


def main():
    data, group, rank, world, shape, tasks = sys.argv[1:7]
    rank, world = int(rank), int(world)
    shape = tuple(int(x) for x in shape.split("x"))
    res = {"rank": rank, "seconds": {}}
    try:
        from repro_torch.launch.mesh import make_mesh

        for t in tasks.split(","):
            t0 = time.perf_counter()
            if t == "predict":
                task_predict(data, shape, res)
            elif group.startswith("fake"):  # over a fake group
                from torch.testing._internal.distributed.fake_pg import \
                    FakeStore

                dist.init_process_group("fake", store=FakeStore(),
                                        rank=rank, world_size=world)
                try:
                    TASKS[t](data, make_mesh(shape, ("data", "model"),
                                             device_type="cpu"), res)
                finally:
                    dist.destroy_process_group()
            else:
                if not dist.is_initialized():
                    dist.init_process_group(
                        "gloo", init_method="file://" + os.path.join(
                            data, "pg_" + group), rank=rank,
                        world_size=world)
                TASKS[t](data, make_mesh(shape, ("data", "model"),
                                         device_type="cpu"), res)
            res["seconds"][t] = time.perf_counter() - t0
    except Exception:
        res["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(data, f"{group}_{rank}.json"), "w") as f:
            json.dump(res, f)
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()

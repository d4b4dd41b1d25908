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


def _streams(outs):
    return [list(map(int, o)) for o in outs]


# the logits each engine of the "torch" route sampled from, by case: the
# kernel route's are held against them (``task_kernels``)
_TORCH_LOGITS = {}


def _recording(eng, sink, every=None, prefill=None):
    """``eng`` with the rows of every logits batch it samples from
    appended to ``sink`` (the real vocabulary): a prefill's row, a decode
    step's active slots' rows (an idle slot's row is another view on
    each route); with ``every``, each whole batch, idle slots included,
    appended to it; with ``prefill``, each prefill's row to it."""
    from repro_torch.distribution.placed import full

    sample = eng._sample

    def rec(logits, slots, rows=None):
        x = full(logits)[:, :eng.cfg.vocab_size].float().clone()
        sink.append(x if rows is None else x[list(rows)])
        if every is not None:
            every.append(x)
        if prefill is not None and rows is None:
            prefill.append(x[0].tolist())
        return sample(logits, slots, rows)

    eng._sample = rec
    return eng


def task_serve(data, tag, mesh, res):
    """Engine and ScheduledEngine, source and merged, on the dense cache,
    the paged pool and the int8 pool (``_serve_paged``)."""
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)

    spec, models = _serve_models(data)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    out = {}
    for name, (cfg, params) in models.items():
        sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"])
        eng = _recording(Engine(cfg, params, sc, impl="torch", device="cpu",
                                mesh=mesh),
                         _TORCH_LOGITS.setdefault(f"dense/{name}", []))
        out[f"{name}/engine"] = _streams(eng.generate(
            prompts, max_new_tokens=spec["max_new"]))
        out[f"{name}/engine_fast_path"] = eng.merged_fast_path
        eng = ScheduledEngine(cfg, params, sc, SchedConfig(**spec["sched"]),
                              impl="torch", device="cpu", mesh=mesh)
        out[f"{name}/sched"] = _streams(eng.generate(
            prompts, max_new_tokens=spec["max_new"]))
        out[f"{name}/placements"] = {
            "k": str(eng.kv.device_cache().k.placements),
            "wk": str(eng.params["layers"]["attn"]["wk"].placements)}
    res["serve"] = out
    res["paged"] = _serve_paged(spec, models, prompts, mesh)


def _redistributed_shapes(step):
    """``step()``, and the global shapes of every DTensor redistributed
    while it ran (explicit ``redistribute``/``full_tensor`` and the
    dispatcher's implicit ones all reach ``redistribute_local_tensor``)."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redist

    orig, shapes = redist.redistribute_local_tensor, []

    def spy(local, current, target, *a, **kw):
        shapes.append(list(current.shape))
        return orig(local, current, target, *a, **kw)

    mods = (api, dispatch, redist)
    for m in mods:
        m.redistribute_local_tensor = spy
    try:
        step()
    finally:
        for m in mods:
            m.redistribute_local_tensor = orig
    return shapes


def _local_digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.to_local().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cow_on_placed_pools(mesh, src, dst):
    """Copy-on-write from page ``src`` to page ``dst`` on int8 pools and
    their scales placed over "model" (4 pages: where it has two ranks,
    pages 0-1 lie on one and 2-3 on the other): the placements, and
    whether the page and its scale rows arrived and nothing else
    changed."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.serving.paged_kv_cache import copy_block_q8

    L, NB = 2, 4
    want = [torch.arange(L * NB * 2 * 6, dtype=torch.float32).reshape(
        L, NB, 2, 1, 6) * (i + 1) for i in range(2)]
    want += [torch.arange(L * NB, dtype=torch.float32).reshape(L, NB, 1)
             * (i + 3) for i in range(2)]
    placed = [shd.place(w.clone(), shd.P(None, "model",
                                         *[None] * (w.ndim - 2)), mesh)
              for w in want]
    copy_block_q8(*placed, src, dst)
    for w in want:
        w[:, dst] = w[:, src]
    return {"split": [str(p.placements) for p in placed],
            "equal": all(torch.equal(p.full_tensor(), w)
                         for p, w in zip(placed, want))}


def _dtensor_vs_local(eng):
    """Model axis 1: the next decode step's logits on the engine's local
    route and on the DTensors (the paged cores take their ``local_call``
    seam, the pool an ``other`` operand); the largest difference.  Both
    write the same rows at the same positions, so the second write
    changes nothing."""
    from repro_torch.distribution.placed import full, on_mesh

    tokens = eng.host_to_device(eng._last_token)
    cache = eng.kv.device_cache()
    with on_mesh(eng.mesh):
        local = full(eng._decode(tokens, cache)[0])
        saved, eng._local_params = eng._local_params, None
        try:
            placed = full(eng._decode(tokens, cache)[0])
        finally:
            eng._local_params = saved
    return float((local - placed).abs().max() / local.abs().max())


def _serve_paged(spec, models, prompts, mesh):
    """The paged pools on the mesh: each model on ``paged`` and
    ``paged_q8``, through ``Engine`` and ``ScheduledEngine``; the source on
    the shared-prefix traffic through a starved ``Engine`` pool (prefix
    retention on: deferral, preemption, copy-on-write), then the pools'
    placements and, gathered from every rank, the digest of each rank's
    local pools; the shapes redistributed during one decode step; and a
    copy-on-write across ranks."""
    import torch.distributed as dist
    from repro_torch.serving import (Engine, Request, SchedConfig,
                                     ScheduledEngine, ServeConfig)

    pspec = spec["paged"]
    out = {}
    for kind in ("paged", "paged_q8"):
        for name, (cfg, params) in models.items():
            sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"],
                             block_size=pspec["block_size"])
            kw = dict(impl="torch", device="cpu", cache=kind, mesh=mesh)
            out[f"{kind}/{name}/engine"] = _streams(_recording(Engine(
                cfg, params, sc, **kw), _TORCH_LOGITS.setdefault(
                    f"{kind}/{name}", [])).generate(
                        prompts, max_new_tokens=spec["max_new"]))
            out[f"{kind}/{name}/sched"] = _streams(ScheduledEngine(
                cfg, params, sc, SchedConfig(**spec["sched"]), **kw).generate(
                    prompts, max_new_tokens=spec["max_new"]))
        cfg, params = models["source"]
        sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"],
                         block_size=pspec["block_size"],
                         n_blocks=pspec["starved_blocks"])
        eng = Engine(cfg, params, sc, impl="torch", device="cpu", cache=kind,
                     mesh=mesh)
        out[f"{kind}/prefix"] = _streams(eng.generate(
            [np.asarray(p, np.int32) for p in pspec["prefix_prompts"]],
            max_new_tokens=spec["max_new"]))
        pm = eng.pm
        out[f"{kind}/prefix_stats"] = dict(
            eng.stats, cow=int(pm.allocator.n_cow),
            hits=int(pm.allocator.n_shared_hits))
        pools = [pm.k, pm.v] + ([pm.k_scale, pm.v_scale]
                                if kind == "paged_q8" else [])
        dc = pm.device_cache()
        out[f"{kind}/placements"] = {
            "k": str(pm.k.placements), "v": str(pm.v.placements),
            "tables": str(dc.block_tables.placements),
            "length": str(dc.length.placements),
            "local_k": list(pm.k.to_local().shape),
            "global_k": list(pm.k.shape)}
        if kind == "paged_q8":
            out[f"{kind}/placements"].update(
                k_scale=str(pm.k_scale.placements),
                v_scale=str(pm.v_scale.placements))
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, (mesh.get_coordinate(),
                                         _local_digest(pools)))
        out[f"{kind}/digests"] = digests
        # one decode step of a full engine, its redistributions recorded
        eng = Engine(cfg, params, ServeConfig(
            n_slots=spec["n_slots"], max_len=spec["max_len"],
            block_size=pspec["block_size"]), impl="torch", device="cpu",
            cache=kind, mesh=mesh)
        for p in prompts[:spec["n_slots"]]:
            assert eng.submit(Request(prompt=p, max_new_tokens=4))
        out[f"{kind}/step_redistributed"] = _redistributed_shapes(eng.step)
        out[f"{kind}/pool_shapes"] = [list(eng.pm.k.shape),
                                      list(eng.pm.k.shape[1:])]
        if eng._local_params is not None:
            out[f"{kind}/dtensor_vs_local"] = _dtensor_vs_local(eng)
    out["cow_across_ranks"] = _cow_on_placed_pools(mesh, 0, 3)
    # one rank holds both pages: the other rank of the model axis must
    # not wait for a page it is not sent
    out["cow_within_a_shard"] = [_cow_on_placed_pools(mesh, s, d)
                                 for s, d in ((0, 1), (3, 2))]
    if dict(zip(mesh.mesh_dim_names, mesh.shape))["model"] > 1:
        out.update(_serve_whole_pool(spec, models, prompts, mesh))
    return out


def _serve_whole_pool(spec, models, prompts, mesh):
    """A pool whose page count the model axis does not divide stays whole
    on every rank (``sharding.evenly``): the source through ``Engine``
    and ``ScheduledEngine`` on both kinds, with the pool's placements."""
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)

    pspec, out = spec["paged"], {}
    cfg, params = models["source"]
    sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"],
                     block_size=pspec["block_size"],
                     n_blocks=pspec["odd_blocks"])
    for kind in ("paged", "paged_q8"):
        kw = dict(impl="torch", device="cpu", cache=kind, mesh=mesh)
        eng = Engine(cfg, params, sc, **kw)
        out[f"{kind}/odd/engine"] = _streams(eng.generate(
            prompts, max_new_tokens=spec["max_new"]))
        out[f"{kind}/odd/placements"] = str(eng.pm.k.placements)
        out[f"{kind}/odd/sched"] = _streams(ScheduledEngine(
            cfg, params, sc, SchedConfig(**spec["sched"]), **kw).generate(
                prompts, max_new_tokens=spec["max_new"]))
    return out


def task_families(data, tag, mesh, res):
    """The other families on this mesh, on the dense cache: MoE, hybrid,
    SSM and the VLM with its vision tokens, from the JAX package's weights
    (``families.pkl``); their greedy streams, which the test holds against
    the JAX engine's and the unmeshed port's.  Then the refusals:
    ``impl="cuda"`` on CPU tensors (the device rule's ValueError, on every
    mesh) and a kernel wrapper given a DTensor (TypeError)."""
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
        eng = _recording(Engine(cfg, to_torch(w, device="cpu"), sc,
                                impl="torch", device="cpu", mesh=mesh),
                         _TORCH_LOGITS.setdefault(arch, []))
        out[arch] = [list(map(int, o)) for o in eng.generate(
            spec["prompts"], max_new_tokens=spec["max_new"],
            vision=spec["vision"] if cfg.n_vision_tokens else None)]
    cfg = reduce_config(get_config("mistral-7b"))
    params = init_params(cfg, seed=0, device="cpu")
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


def task_kernels(data, tag, mesh, res):
    """The kernel route (``impl="cuda"``) on this mesh, whose model axis
    is 2, run on CPU tensors: the device rule is lifted for the task
    (``serving.engine._IMPL_DEVICE``), so every kernel wrapper runs its
    plain version on each rank's local shards (heads for a prefill, the
    cross decode and the SSD scan; the sequence or pages for a decode
    step, combined across the model axis).  ``Engine`` and
    ``ScheduledEngine`` on the Mistral models (dense cache, paged and int8
    pools), ``Engine`` on the 25-page pools "model" keeps whole and on the
    other families: streams, the largest logit difference from the
    "torch" route's engine (``_TORCH_LOGITS``, relative to its largest
    logit), whether every logit (idle slots' too) is finite, the prefill
    logits of each request (for the JAX forward), and the kernel wrappers
    and partial-state twins each run reached."""
    import pickle

    from repro_torch.convert import to_torch
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)
    from repro_torch.serving import engine as serving_engine

    spec, models = _serve_models(data)
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    with open(os.path.join(data, "families.pkl"), "rb") as f:
        fspec = pickle.load(f)
    calls = {}
    check_call, decode_states = _build.check_call, ops.decode_states

    def counted(name, *a, **k):
        calls[name] = calls.get(name, 0) + 1
        return check_call(name, *a, **k)

    def counted_states(name, *a, **k):
        calls[name + "_states"] = calls.get(name + "_states", 0) + 1
        return decode_states(name, *a, **k)

    def run(key, make, generate):
        calls.clear()
        logits, every, prefill = [], [], []
        eng = _recording(make(), logits, every, prefill)
        got = {"streams": _streams(generate(eng))}
        want = _TORCH_LOGITS.get(key)
        if want is not None:
            a, b = torch.cat(logits), torch.cat(want)
            got["logits_rel"] = float((a - b).abs().max() / b.abs().max()) \
                if a.shape == b.shape else None
        got["finite"] = all(bool(torch.isfinite(x).all()) for x in every)
        got["prefill"] = prefill
        got["calls"] = dict(calls)
        return got

    out = {}
    lifted = dict(serving_engine._IMPL_DEVICE)
    serving_engine._IMPL_DEVICE["cuda"] = "cpu"
    _build.check_call, ops.decode_states = counted, counted_states
    try:
        pspec, new = spec["paged"], spec["max_new"]
        for kind in ("dense", "paged", "paged_q8"):
            for name, (cfg, params) in models.items():
                sc = ServeConfig(n_slots=spec["n_slots"],
                                 max_len=spec["max_len"],
                                 block_size=pspec["block_size"])
                kw = dict(impl="cuda", device="cpu", cache=kind, mesh=mesh)
                out[f"{kind}/{name}/engine"] = run(
                    f"{kind}/{name}", lambda: Engine(cfg, params, sc, **kw),
                    lambda e: e.generate(prompts, max_new_tokens=new))
                out[f"{kind}/{name}/sched"] = run(
                    None, lambda: ScheduledEngine(
                        cfg, params, sc, SchedConfig(**spec["sched"]), **kw),
                    lambda e: e.generate(prompts, max_new_tokens=new))
            if kind != "dense":
                cfg, params = models["source"]
                sc = ServeConfig(n_slots=spec["n_slots"],
                                 max_len=spec["max_len"],
                                 block_size=pspec["block_size"],
                                 n_blocks=pspec["odd_blocks"])
                out[f"{kind}/odd/engine"] = run(
                    None, lambda: Engine(cfg, params, sc, impl="cuda",
                                         device="cpu", cache=kind,
                                         mesh=mesh),
                    lambda e: e.generate(prompts, max_new_tokens=new))
        # no window: the scheduler chunks the dense cache, whose sequence
        # the model axis splits (a chunk's writes miss one rank's shard)
        cfg, params = models["source"]
        cfg = cfg.with_(sliding_window=0)
        sc = ServeConfig(n_slots=spec["n_slots"], max_len=spec["max_len"])
        sched = SchedConfig(**spec["sched"])
        for impl in ("torch", "cuda"):
            kw = dict(impl=impl, device="cpu", mesh=mesh)
            eng = ScheduledEngine(cfg, params, sc, sched, **kw)
            out[f"nowindow/{impl}/chunked"] = eng._chunked
            out[f"nowindow/{impl}/sched"] = _streams(eng.generate(
                prompts, max_new_tokens=new))
        out["nowindow/torch/engine"] = _streams(Engine(
            cfg, params, sc, impl="torch", device="cpu", mesh=mesh).generate(
                prompts, max_new_tokens=new))
        sc = ServeConfig(**fspec["sc"])
        for arch, (cfg, w) in fspec["models"].items():
            vis = fspec["vision"] if cfg.n_vision_tokens else None
            out[arch] = run(
                arch, lambda: Engine(cfg, to_torch(w, device="cpu"), sc,
                                     impl="cuda", device="cpu", mesh=mesh),
                lambda e: e.generate(fspec["prompts"],
                                     max_new_tokens=fspec["max_new"],
                                     vision=vis))
    finally:
        serving_engine._IMPL_DEVICE.update(lifted)
        _build.check_call, ops.decode_states = check_call, decode_states
    res["kernels"] = out


TASKS = {"train": task_train, "elastic": task_elastic, "serve": task_serve,
         "families": task_families, "kernels": task_kernels}


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

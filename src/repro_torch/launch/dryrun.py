"""Dry run of every (arch × shape × mesh) cell on the meta device: the
counterpart of ``repro.launch.dryrun``.

Per cell this script:
  1. applies ``configs.shapes.shape_applicable``'s skip;
  2. builds the cell's step (``launch.steps.build_step``: the train step,
     the serving prefill or the decode step) and RUNS it on the ``meta``
     device at the cell's full shape, full width and full depth: every
     shape must cohere, and nothing is allocated;
  3. runs the step a second time PLACED (``_run_placed``, the counterpart
     of the reference's lower + compile with in and out shardings): the
     params, the AdamW state (``opt_pspecs``, ``zero1``), the decode cache
     and the inputs are DTensors placed per the specs below on a
     ``DeviceMesh`` of the production shape (16x16, or 2x16x16 with "pod"
     and "data" flattened, as ``sharding.torch_mesh`` does), whose local
     shards are meta tensors, with DTensor's collectives as on a CUDA mesh
     (``cuda_collectives``; no card is touched).  The mesh lies over a process group of 256
     or 512 ranks of torch's fake backend (``torch.testing._internal
     .distributed.fake_pg``: its collectives return at once and move
     nothing), this process rank 0; ``null_world`` starts it for the run
     and ends it after.  The step must run: the sharded program coheres
     (every reshape of a split dim, every redistribution DTensor plans);
  4. records, for the production mesh:
       * ``n_params``;
       * the per-device ARGUMENT bytes under the specs after ``evenly``:
         params, plus the AdamW moments for ``train`` or the cache for
         ``decode``, plus the inputs;
       * ``uneven_shardings`` (``distribution.sharding.check_divisibility``);
       * ``model_flops_per_device``: 6·N·D train, 2·N·D prefill, 2·N per
         decoded token, N the matmul weights (MoE: active experts), from
         ``core.analysis.weight_table``;
       * from the placed run, counted by ``distribution.collectives
         .StepCounter`` on rank 0: ``collectives`` (``per_op_bytes``,
         ``counts``, ``total_bytes`` under the reference's op names, and
         ``by_link``: bytes of groups inside one 8-GPU node, "nvlink", and
         across nodes, "network"; the model axis of 16 spans two nodes),
         ``flops_per_device`` (``torch.utils.flop_counter``'s formulas over
         each local op's shards) and ``bytes_accessed_per_device`` (each
         local op's operand and result bytes: nothing is fused, so it is
         an upper bound of XLA's fused count), and ``model_flops_ratio``;
       * ``roofline``: compute, memory and collective terms at the H100's
         peaks (``PEAK_FLOPS``, ``HBM_BW``, ``NVLINK_BW``, ``NETWORK_BW``),
         ``dominant`` the largest.

The reference's XLA cost model counts a loop body once, so it lowers two
loop-free variants at small depths and extrapolates to the full depth.
The port loops over layers in Python: the placed run executes (and the
counter sees) every layer and every chunk, so its counts are the full
depth's and no extrapolation is needed.

``--no-analysis`` (``run_cell(analysis=False)``) keeps the meta-only
record: no placed run, no counts, a roofline of model FLOPs and argument
bytes.  Importing this module changes no environment and starts no
process group.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR] \\
      [--jobs 8] [--no-analysis]
  python -m repro_torch.launch.dryrun --arch mistral-7b --shape decode_32k \\
      --mesh 1x2 --impl cuda --batch 2 --seq-len 512 --print-record

``--cells arch:shape,...`` runs the cells listed.  ``--jobs N`` runs the
archs in N worker processes (each arch's cells in
one worker, in order); the records and the printed lines are the same.
``--mesh DxM`` (or ``PxDxM``) places the step on a mesh of that shape in
place of the production one, ``--batch`` / ``--seq-len`` cut the cell's
shape (``shape_applicable`` reads the uncut one), ``--overrides JSON``
sets config fields, and ``--print-record`` prints the record as the last
line but one: what a real group's run is held against.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence

# H100 SXM peaks (NVIDIA H100 datasheet): dense bf16 tensor-core FLOP/s,
# HBM3 bytes/s; NVLink 4 bytes/s per direction per GPU (900 GB/s both
# directions); 400 Gb/s NDR InfiniBand, one adapter per GPU
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NETWORK_BW = 50e9


def _per_device_bytes(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree`` placed per ``specs`` (already
    through ``evenly``): each leaf's bytes over the product of the mesh
    axes that split it."""
    from repro_torch.distribution import sharding as shd

    sizes = shd.axis_sizes(mesh)
    total = [0]

    def leaf(spec, x):
        if x is None:
            return spec
        n = x.numel() * x.element_size()
        split = 1
        for ax in (spec or ()):
            if ax is not None:
                split *= shd._size(sizes, ax)
        total[0] += n // split
        return spec

    shd._map_specs(leaf, specs, tree)
    return total[0]


def _model_flops(cfg, shape) -> float:
    """Analytic useful-work FLOPs for the whole step (all chips): 6·N·D
    train, 2·N·D prefill, 2·N_active per decoded token; N is the matmul
    weights (the input embedding is a gather, the unembedding a matmul)."""
    from repro_torch.core.analysis import weight_table

    wt = weight_table(cfg)
    n_matmul = wt["total"] - cfg.d_model * cfg.vocab_size  # minus input embed
    if cfg.n_experts:
        frac_active = cfg.experts_per_token / cfg.n_experts
        n_matmul -= cfg.n_layers * wt["ffn_per_layer"] * (1 - frac_active)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_matmul * tokens


def roofline_terms(record: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline of a record (per-device quantities, H100 peaks):
    compute, memory and collective terms from the placed run's counts
    (``by_link``: NVLink and network bytes at their rates), or, for a
    meta-only record, compute and memory terms from the model FLOPs and
    the argument bytes.  ``dominant`` is the largest term."""
    if record.get("skipped"):
        return {}
    if "collectives" not in record:
        terms = {"compute_s": record["model_flops_per_device"] / PEAK_FLOPS,
                 "memory_s": record["memory"]["argument_bytes"] / HBM_BW}
    else:
        link = record["collectives"]["by_link"]
        terms = {"compute_s": record["flops_per_device"] / PEAK_FLOPS,
                 "memory_s": record["bytes_accessed_per_device"] / HBM_BW,
                 "collective_s": link["nvlink"] / NVLINK_BW
                 + link["network"] / NETWORK_BW}
    terms["dominant"] = max(terms, key=terms.get)[:-2]
    return terms


def meta_args(cfg, shape):
    """The arguments of the cell's step as ``launch.steps``' meta
    stand-ins: (params, opt_state, batch) for ``train``, (params, batch)
    for ``prefill``, (params, token, cache) for ``decode``."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.training.optimizer import make_optimizer

    params = steps_lib.param_specs(cfg)
    ins = steps_lib.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = make_optimizer("adamw", 3e-4, 100, 10_000).init(params)
        return params, opt, ins
    if shape.kind == "prefill":
        return params, ins
    return params, ins["token"], ins["cache"]


def _run_meta(cfg, shape, *, grad_accum, remat) -> float:
    """Run the cell's step on the meta device; returns its seconds.  (The
    step's sharding re-anchors act on DTensors only: on meta tensors there
    is nothing for them to do, so none is passed.)"""
    from repro_torch.launch import steps as steps_lib

    t0 = time.time()
    fn, _ = steps_lib.build_step(cfg, shape.kind, grad_accum=grad_accum,
                                 remat=remat)
    out = fn(*meta_args(cfg, shape))
    del out
    return time.time() - t0


# ---------------------------------------------------------------------------
# the placed run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def null_world(size: int):
    """The default process group for a placed run: ``size`` ranks of
    torch's fake backend, this process rank 0, started on entry and ended
    on exit.  A fake group of that size already running is used as it is
    (and left running).  A process that holds a real group cannot host a
    placed dry run: it raises (run one in a process of its own)."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != size:
            raise RuntimeError(
                f"a placed dry run of {size} ranks needs a process without "
                f"a process group; this one holds a {dist.get_backend()!r} "
                f"group of {dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def cuda_collectives():
    """The one collective DTensor picks by the mesh's device type, as on a
    CUDA mesh: a Shard -> Shard redistribution is an all-to-all there
    (``_dtensor.shard_dim_alltoall``), and an all-gather and a chunk on a
    CPU mesh (gloo has no all-to-all).  A placed run that predicts a CUDA
    mesh's program runs on a CPU mesh (this process needs no CUDA, and
    DTensor's sharding propagation makes tensors on the mesh's device)
    inside this context.  DTensor's cost model, which reads the devices
    of a host, sees every dim of a production mesh (a model axis of 16)
    span hosts either way."""
    import torch
    from torch.distributed.tensor import placement_types

    orig = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def mesh_axes(shape: Sequence[int]):
    """The axis names of a mesh of ``shape``: ("data", "model") or ("pod",
    "data", "model")."""
    if len(shape) not in (2, 3):
        raise ValueError(f"a mesh is (data, model) or (pod, data, model), "
                         f"got {tuple(shape)}")
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def place_args(cfg, kind: str, args, mesh, rules, *, zero1: bool = False):
    """The step's arguments (``meta_args``' structure, plain tensors: meta
    stand-ins or real ones) placed on ``mesh`` (a ``DeviceMesh``) per the
    specs the record counts: ``param_pspecs``, ``opt_pspecs`` (``zero1``),
    ``batch_pspec`` for the inputs and the token, ``serving_cache_pspecs``
    for the cache, each after ``evenly``.  Params already placed (by
    ``distribute_tree`` with the same specs) are taken as they lie."""
    from repro_torch._tree import tree_leaves
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.placed import is_placed

    params, *rest = args
    ppspec = shd.evenly(shd.param_pspecs(params, rules), params, mesh)
    out = [params if is_placed(tree_leaves(params)[0]) else
           shd.distribute_tree(params, ppspec, mesh)]
    if kind == "train":
        opt = rest.pop(0)
        out.append(shd.distribute_tree(opt, shd.opt_pspecs(
            opt, ppspec, mesh, zero1=zero1, dp_axes=rules.dp), mesh))
    if kind == "decode":
        token, cache = rest
        out.append(shd.place(token, shd.batch_pspec(rules, 0), mesh))
        out.append(shd.distribute_tree(
            cache, shd.serving_cache_pspecs(cfg, rules, cache), mesh))
    else:
        batch, = rest
        out.append(shd.distribute_tree(
            batch, {k: shd.batch_pspec(rules, v.ndim - 1)
                    for k, v in batch.items()}, mesh))
    return tuple(out)


def _run_placed(cfg, shape, mesh_shape, *, grad_accum, remat, impl,
                zero1, device_type, rules_kw) -> Dict[str, Any]:
    """The step on DTensors over a fake group of the mesh's size, counted
    on rank 0 -> ``StepCounter.record()`` plus ``placed_run`` seconds."""
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.collectives import StepCounter
    from repro_torch.distribution.placed import on_mesh
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_mesh

    t0 = time.time()
    with null_world(math.prod(mesh_shape)):
        mesh = make_mesh(mesh_shape, mesh_axes(mesh_shape),
                         device_type="cpu")
        rules = shd.make_rules(mesh, batch=shape.global_batch, **rules_kw)
        args = place_args(cfg, shape.kind, meta_args(cfg, shape), mesh,
                          rules, zero1=zero1)
        fn, _ = steps_lib.build_step(cfg, shape.kind, grad_accum=grad_accum,
                                     remat=remat, impl=impl)
        counter = StepCounter()
        with on_mesh(shd.torch_mesh(mesh)), counter, (
                cuda_collectives() if device_type == "cuda"
                else contextlib.nullcontext()):
            out = fn(*args)
        del out, args
    rec = counter.record()
    rec["placed_run"] = round(time.time() - t0, 2)
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             block_style: Optional[str] = None,
             rules_kw: Optional[dict] = None, grad_accum: int = 1,
             remat: bool = True, cfg_overrides: Optional[dict] = None,
             zero1: bool = False, analysis: bool = True,
             impl: str = "torch", mesh_shape: Optional[Sequence[int]] = None,
             shape_overrides: Optional[dict] = None,
             device_type: str = "cuda",
             ran: Optional[Dict[tuple, float]] = None) -> Dict[str, Any]:
    """Run one cell; returns its record.  ``analysis`` adds the placed run
    and its counts (``False``: the meta-only record); ``impl`` is the
    step's route ("cuda": the kernel operators' fakes give their results
    on meta tensors); ``mesh_shape`` replaces the production mesh (a
    (data, model) or (pod, data, model) shape); ``shape_overrides``
    (``seq_len``, ``global_batch``) cut the cell's shape, whose
    applicability is read uncut; ``device_type``: the device of the mesh
    whose program is predicted ("cuda", as in production: DTensor picks
    one collective by it, ``cuda_collectives``; "cpu" for a CPU group's
    run).  ``ran`` (config, shape, grad_accum,
    remat) -> seconds: the meta run depends on those, not on the mesh, so
    a caller that passes the same dict for both meshes runs each step
    once."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import MeshShape, make_production_mesh
    from repro_torch.training.optimizer import make_optimizer

    t0 = time.time()
    cfg = get_config(arch)
    if block_style:
        cfg = cfg.with_(block_style=block_style)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    cfg.validate_style()
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)

    mesh = make_production_mesh(multi_pod=multi_pod) if mesh_shape is None \
        else MeshShape(mesh_shape, mesh_axes(mesh_shape))
    chips = mesh.size
    rules = shd.make_rules(mesh, batch=shape.global_batch,
                           **(rules_kw or {}))
    key = (cfg, shape, grad_accum, remat)
    ran = {} if ran is None else ran
    if key not in ran:
        ran[key] = _run_meta(cfg, shape, grad_accum=grad_accum, remat=remat)
    t_run = ran[key]

    pshape = steps_lib.param_specs(cfg)
    ppspec = shd.evenly(shd.param_pspecs(pshape, rules), pshape, mesh)
    n_params = sum(x.numel() for x in tree_leaves(pshape))
    ispecs = steps_lib.input_specs(cfg, shape)
    mem = {"params_bytes": _per_device_bytes(pshape, ppspec, mesh)}
    if shape.kind == "train":
        oshape = make_optimizer("adamw", 3e-4, 100, 10_000).init(pshape)
        ospec = shd.evenly(shd.opt_pspecs(oshape, ppspec, mesh, zero1=zero1,
                                          dp_axes=rules.dp), oshape, mesh)
        mem["opt_bytes"] = _per_device_bytes(oshape, ospec, mesh)
    batch = {k: v for k, v in ispecs.items() if k != "cache"}
    if shape.kind == "decode":
        cache = ispecs["cache"]
        cspec = shd.evenly(shd.serving_cache_pspecs(cfg, rules, cache),
                           cache, mesh)
        mem["cache_bytes"] = _per_device_bytes(cache, cspec, mesh)
    bspec = shd.evenly({k: shd.batch_pspec(rules, v.ndim - 1)
                        for k, v in batch.items()}, batch, mesh)
    mem["input_bytes"] = _per_device_bytes(batch, bspec, mesh)
    mem["argument_bytes"] = sum(mem.values())

    record = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": {"multi_pod": multi_pod, "shape": dict(mesh.shape),
                 "chips": chips},
        "block_style": cfg.block_style,
        "n_params": n_params,
        "memory": mem,
        "uneven_shardings": shd.check_divisibility(pshape, mesh, rules),
        "model_flops_per_device": _model_flops(cfg, shape) / chips,
        "skipped": False,
    }
    timings = {"meta_run": round(t_run, 2)}
    if shape_overrides:
        record["shape_overrides"] = dict(shape_overrides)
    if analysis:
        placed = _run_placed(cfg, shape, tuple(mesh.shape.values()),
                             grad_accum=grad_accum, remat=remat, impl=impl,
                             zero1=zero1, device_type=device_type,
                             rules_kw=rules_kw or {})
        timings["placed_run"] = placed.pop("placed_run")
        record.update(impl=impl, collectives=placed["collectives"],
                      flops_per_device=placed["flops"],
                      bytes_accessed_per_device=placed["bytes_accessed"])
        if placed["flops"] > 0:
            record["model_flops_ratio"] = (record["model_flops_per_device"]
                                           / placed["flops"])
    record["roofline"] = roofline_terms(record)
    timings["total"] = round(time.time() - t0, 2)
    record["timings_s"] = timings
    return record


def _line(rec) -> str:
    if rec["skipped"]:
        return "SKIP: " + rec["reason"]
    r, t = rec["roofline"], rec["timings_s"]
    line = (f"ok meta_run={t['meta_run']}s args/device="
            f"{rec['memory']['argument_bytes'] / 2**30:.2f}GiB "
            f"dominant={r['dominant']} "
            f"uneven={len(rec['uneven_shardings'])}")
    if "collectives" in rec:
        c = rec["collectives"]
        line += (f" placed_run={t['placed_run']}s collectives="
                 f"{sum(c['counts'].values())} "
                 f"({c['total_bytes'] / 2**20:.1f}MiB) "
                 f"mfr={rec.get('model_flops_ratio', 0):.2f}")
    return line


def _arch_cells(arch, shapes, meshes, kw):
    """Every (shape, mesh) cell of one arch -> [(tag, multi_pod, record,
    line)], in (shape, mesh) order.  The cells run mesh by mesh: a placed
    run's fake group has the mesh's size."""
    out, ran = {}, {}
    for mp in meshes:
        for shape in shapes:
            tag = f"{arch}|{shape}|{'multi' if mp else 'single'}"
            try:
                rec = run_cell(arch, shape, multi_pod=mp, ran=ran, **kw)
                line = _line(rec)
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "skipped": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                line = f"FAIL {type(e).__name__}: {e}"
            out[(shape, mp)] = (tag, mp, rec, line)
    return [out[(s, mp)] for s in shapes for mp in meshes]


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="arch:shape,arch:shape,... in place of --arch, "
                         "--shape and --all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--block-style", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--no-analysis", action="store_true",
                    help="the meta-only record: no placed run, no counts")
    ap.add_argument("--impl", default="torch", choices=("torch", "cuda"))
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM in place of the production mesh")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--overrides", default=None,
                    help="JSON object of config fields")
    ap.add_argument("--print-record", action="store_true")
    ap.add_argument("--out", default=None, help="artifact dir (json per cell)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (one arch per task)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    style = args.block_style or "default"
    cut = {k: v for k, v in (("global_batch", args.batch),
                             ("seq_len", args.seq_len)) if v is not None}
    kw = dict(block_style=args.block_style, grad_accum=args.grad_accum,
              remat=not args.no_remat, analysis=not args.no_analysis,
              impl=args.impl, shape_overrides=cut or None,
              cfg_overrides=json.loads(args.overrides)
              if args.overrides else None,
              mesh_shape=tuple(int(x) for x in args.mesh.split("x"))
              if args.mesh else None)

    def out_path(arch, shape, mp):
        return None if not args.out else os.path.join(
            args.out, f"{arch}__{shape}__{'multi' if mp else 'single'}"
                      f"__{style}.json")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    todo = []
    if args.cells:  # each arch with its listed shapes, in the given order
        picked: Dict[str, list] = {}
        for cell in args.cells.split(","):
            arch, shape = cell.split(":")
            picked.setdefault(arch, []).append(shape)
        archs, shapes = [], []
        todo = list(picked.items())
    for arch in archs:
        mine = [s for s in shapes if not (
            args.skip_existing and args.out and all(
                os.path.exists(out_path(arch, s, mp)) for mp in meshes))]
        for s in shapes:
            if s not in mine:
                print(f"[skip existing] {arch}|{s}", flush=True)
        if mine:
            todo.append(arch if len(mine) == len(shapes) else (arch, mine))
    tasks = [(t, shapes) if isinstance(t, str) else t for t in todo]
    if args.jobs > 1 and len(tasks) > 1:
        import multiprocessing as mp_

        with mp_.get_context("spawn").Pool(min(args.jobs, len(tasks))) \
                as pool:
            results = pool.starmap(_arch_cells, [(a, s, meshes, kw)
                                                 for a, s in tasks])
    else:
        results = [_arch_cells(a, s, meshes, kw) for a, s in tasks]
    counts = {"run": 0, "skipped": 0, "failed": 0}
    for cells in results:
        for tag, mp, rec, line in cells:
            if "error" in rec:
                counts["failed"] += 1
            elif rec["skipped"]:
                counts["skipped"] += 1
            else:
                counts["run"] += 1
            print(f"[{tag}] {line}", flush=True)
            path = out_path(rec["arch"], rec["shape"], mp)
            if path:
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    if args.print_record:
        print(json.dumps([rec for cells in results for *_, rec, _ in cells]),
              flush=True)
    print(json.dumps({"dryrun_cells": counts}), flush=True)
    if counts["failed"]:
        sys.exit(1)
    return counts


if __name__ == "__main__":
    main()

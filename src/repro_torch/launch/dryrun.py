"""Meta-device dry run of every (arch × shape × mesh) cell: the
counterpart of ``repro.launch.dryrun``'s accounting.

Per cell this script:
  1. applies ``configs.shapes.shape_applicable``'s skip;
  2. builds the cell's step (``launch.steps.build_step``: the train step,
     the serving prefill or the decode step) and RUNS it on the ``meta``
     device at the cell's full shape, full width and full depth: every
     shape must cohere (the counterpart of the reference's lower +
     compile), and nothing is allocated;
  3. records, for the production mesh (16x16, or 2x16x16 multi-pod: shapes
     only, ``launch.mesh.make_production_mesh``):
       * ``n_params``;
       * the per-device ARGUMENT bytes under the specs after ``evenly``:
         params, plus the AdamW moments for ``train`` or the cache for
         ``decode``, plus the inputs;
       * ``uneven_shardings`` (``distribution.sharding.check_divisibility``);
       * ``model_flops_per_device``: 6·N·D train, 2·N·D prefill, 2·N per
         decoded token, N the matmul weights (MoE: active experts), from
         ``core.analysis.weight_table``;
       * ``roofline``: compute and memory terms over model FLOPs and
         argument bytes at the H100's peaks (989e12 bf16 FLOP/s dense,
         3.35e12 B/s HBM3).

The reference's collective term (parsed from post-SPMD HLO), its XLA
cost-model numbers and their two-depth extrapolation have no counterpart:
no compiler partitions the program here.  Importing this module changes
no environment.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR] \
      [--jobs 8]

``--jobs N`` runs the archs in N worker processes (each arch's cells in
one worker, in order); the records and the printed lines are the same.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

# H100 SXM peaks (dense bf16 tensor-core FLOP/s, HBM3 bytes/s)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


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
    """Compute and memory terms of a record (per-device quantities, H100
    peaks); no collective term (no partitioned program to read it from)."""
    if record.get("skipped"):
        return {}
    compute_s = record["model_flops_per_device"] / PEAK_FLOPS
    memory_s = record["memory"]["argument_bytes"] / HBM_BW
    return {"compute_s": compute_s, "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory"}


def _run_meta(cfg, shape, *, grad_accum, remat) -> float:
    """Run the cell's step on the meta device; returns its seconds.  (The
    step's sharding re-anchors act on DTensors only: on meta tensors there
    is nothing for them to do, so none is passed.)"""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.training.optimizer import make_optimizer

    t0 = time.time()
    fn, _ = steps_lib.build_step(cfg, shape.kind, grad_accum=grad_accum,
                                 remat=remat)
    params = steps_lib.param_specs(cfg)
    ins = steps_lib.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = make_optimizer("adamw", 3e-4, 100, 10_000).init(params)
        out = fn(params, opt, ins)
    elif shape.kind == "prefill":
        out = fn(params, ins)
    else:
        out = fn(params, ins["token"], ins["cache"])
    del out
    return time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             block_style: Optional[str] = None,
             rules_kw: Optional[dict] = None, grad_accum: int = 1,
             remat: bool = True, cfg_overrides: Optional[dict] = None,
             zero1: bool = False,
             ran: Optional[Dict[tuple, float]] = None) -> Dict[str, Any]:
    """Run one cell on the meta device; returns its record.  ``ran``
    (config, shape, grad_accum, remat) -> seconds: the meta run depends
    on those, not on the mesh, so a caller that passes the same dict for
    both meshes runs each step once."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.distribution import sharding as shd
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_production_mesh
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

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rules = shd.make_rules(mesh, batch=shape.global_batch,
                           **(rules_kw or {}))
    key = (cfg, shape_name, grad_accum, remat)
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
    record["roofline"] = roofline_terms(record)
    record["timings_s"] = {"meta_run": round(t_run, 2),
                           "total": round(time.time() - t0, 2)}
    return record


def _arch_cells(arch, shapes, meshes, kw):
    """Every (shape, mesh) cell of one arch -> [(tag, multi_pod, record,
    line)]."""
    out, ran = [], {}
    for shape in shapes:
        for mp in meshes:
            tag = f"{arch}|{shape}|{'multi' if mp else 'single'}"
            try:
                rec = run_cell(arch, shape, multi_pod=mp, ran=ran, **kw)
                if rec["skipped"]:
                    line = "SKIP: " + rec["reason"]
                else:
                    r = rec["roofline"]
                    line = (f"ok meta_run={rec['timings_s']['meta_run']}s "
                            f"args/device="
                            f"{rec['memory']['argument_bytes'] / 2**30:.2f}"
                            f"GiB dominant={r['dominant']} "
                            f"uneven={len(rec['uneven_shardings'])}")
            except Exception as e:
                rec = {"arch": arch, "shape": shape, "skipped": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()}
                line = f"FAIL {type(e).__name__}: {e}"
            out.append((tag, mp, rec, line))
    return out


def main(argv=None) -> Dict[str, int]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--block-style", default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
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
    kw = dict(block_style=args.block_style, grad_accum=args.grad_accum,
              remat=not args.no_remat)

    def out_path(arch, shape, mp):
        return None if not args.out else os.path.join(
            args.out, f"{arch}__{shape}__{'multi' if mp else 'single'}"
                      f"__{style}.json")

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    todo = []
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
    print(json.dumps({"dryrun_cells": counts}), flush=True)
    if counts["failed"]:
        sys.exit(1)
    return counts


if __name__ == "__main__":
    main()

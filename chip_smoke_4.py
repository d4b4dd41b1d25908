#!/usr/bin/env python3
"""Four-card smoke test of the PyTorch/CUDA port's device mesh: the
engines and the trainer on four NVIDIA cards, one process per card, over
NCCL.  Run from the repository root on a machine with four cards:

    python3 chip_smoke_4.py

It refuses to start (non-zero exit, the card count in the message) where
``torch.cuda.device_count()`` is below 4 or CUDA is missing; it never
falls back to gloo, to fewer ranks or to the CPU.

1. prints each card's name and power limit (nvidia-smi), builds the
   kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
   parallel), and starts the dry run's predictions of (d) on the host's
   CPU (``chip_smoke.start_prediction``: subprocesses over fake groups, no
   card), one per mesh and step;
2. the reference (``--reference``, card 0, its own process, before the
   process group starts): the unmeshed engines and trainer on the
   models below; it writes their streams, per-run launch counts, tok/s,
   the float32 prefill logits and the losses to
   ``build/mesh4_reference.json`` (logits: ``build/mesh4_reference.pt``);
3. four ranks (``--rank R``, card R), one NCCL process group (rendezvous
   ``build/mesh4_pg``, timeout ``PG_TIMEOUT_S``, asynchronous error
   handling: a collective one rank misses ends in an error, not a hang),
   and on each of the meshes ``MESHES`` (``launch.mesh.make_host_mesh`` on
   "cuda"):
   (a) at ``EQ_LAYERS`` calibrated float32 layers, merged skipless
       Mistral-7B at full width and its source through ``Engine(mesh=,
       impl="cuda")`` on the dense cache, the paged pool and the int8
       pool (``chip_smoke.model_axis_f32``, pools of ``MODEL_AXIS_PAGES``
       pages that every rank of a model axis of 4 holds): on the fp
       caches the greedy streams equal the reference's, the prefill
       logits are within ``MESH_LOGIT_RTOL`` of its, and merged ==
       source; on the int8 pool ``chip_smoke.q8_on_the_mesh``'s gates
       (pages == the quantiser's bits, the meshed int8 values replayed
       unmeshed give the meshed prefill logits within 1e-4, every split-K
       decode within ``TOL_F32`` of the whole-pool kernel);
   (b) at 32 bfloat16 layers, merged Mistral-7B through ``Engine`` and
       ``ScheduledEngine`` on the three caches: each rank's launches are
       the unmeshed engine's (one flash per layer and prefill, one decode
       per layer and step, in the partial-state mode where the model axis
       is above 1); the tokens each stream shares with the unmeshed one,
       tok/s and TTFT are printed (one run each, not gated);
   (c) Hymba-1.5B's qp merge (4 calibrated float32 layers; rows 1, 4 at
       D 64 and 10) and Phi-3.5-MoE's (4 calibrated float32 layers at the
       no-drop capacity, dense and paged): the reference's streams; then
       Phi-3.5-MoE's merge in bfloat16 at ``MOE_BF16_LAYERS`` layers:
       launches == unmeshed, tok/s printed;
   (d) ``build_step``'s prefill and decode (``impl="cuda"``,
       ``MESH4_STEPS``) of the 32-layer bfloat16 merge under
       ``StepCounter``: each op's count and bytes equal on the
       four ranks and equal to the dry run's prediction (checked by the
       parent); the seconds inside the NCCL collectives are printed, and
       one more ``Engine`` decode step's per cache;
   (e) on ``TRAIN_MESHES``, ``Trainer(mesh=)`` on Llama-3.2-1B whole for
       ``MESH_TRAIN_STEPS`` steps in float32 compute: losses within
       ``MESH_TRAIN_RTOL`` of the reference's; then in bfloat16 (printed:
       the model axis's partial sums round to bfloat16 before their sum);
       step seconds and peak memory per rank printed.
   A part that fails on every rank is recorded and the next one runs (the
   ranks agree by an all-reduce after each part); the script fails if any
   part failed.  The parent kills every rank at its deadline and exits
   non-zero, naming each rank's phase (``build/mesh4_rank_R.phase``);
4. prints each rank's launch counts, then, as the last line,
   ``{"ok": true, "device": {"platform": "gpu", ..., "count": 4}}``.

Everything printed is also written to ``build/chip_smoke_4.log``; the
reference's and the ranks' own logs are ``build/mesh4_reference.log`` and
``build/mesh4_rank_R.log``.  No kernel's launches here join
``chip_smoke.py``'s ``kernels`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

N_RANKS = 4
MESHES = ((1, 4), (2, 2), (4, 1))  # (data, model)
TRAIN_MESHES = ((4, 1), (2, 2))
# the Trainer's compute: float32 gated against the unmeshed losses
# (``MESH_TRAIN_RTOL``), then bfloat16, printed
TRAIN_DTYPES = ("float32", "bfloat16")
# ``build_step``'s steps under the collective counter, kind -> (dry-run
# cell, batch, prompt or cache length): a batch of 4 that every data axis
# of ``MESHES`` splits
MESH4_STEPS = {"prefill": ("prefill_32k", 4, 256),
               "decode": ("decode_32k", 4, 512)}
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
HYMBA_ARCH = "hymba-1.5b"
MOE_BF16_LAYERS = 6  # chip_smoke.MOE_DEPTH's for Phi-3.5-MoE
MISTRAL_LENS = (16, 37, 100, 250)
PG_TIMEOUT_S = 180  # a collective that a rank misses errors after this
DEADLINE_S = 1140  # from the script's start: the parent kills the ranks
PG_FILE = os.path.join(ROOT, "build", "mesh4_pg")
REF_JSON = os.path.join(ROOT, "build", "mesh4_reference.json")
REF_PT = os.path.join(ROOT, "build", "mesh4_reference.pt")


def log(msg: str) -> None:
    print(msg, flush=True)


def cs():
    """``chip_smoke`` (beside this script), with ``src`` importable."""
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import chip_smoke
    return chip_smoke


def mesh_name(shape) -> str:
    return f"({shape[0]}, {shape[1]})"


def mesh_key(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def mistral_prompts():
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, 32000, n) for n in MISTRAL_LENS]


def moe_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, n) for n in MISTRAL_LENS]


def moe_merge(n_layers, dtype=None):
    """Phi-3.5-MoE's merge at ``n_layers``: float32 calibrated at the
    no-drop capacity (``capacity_factor = n_experts``), or bfloat16 at
    the config's capacity; the source is dropped."""
    from repro_torch.configs import get_config
    c = cs()
    if dtype is None:
        full = get_config(MOE_ARCH)
        return c.build(n_layers, True, MOE_ARCH,
                       capacity_factor=float(full.n_experts))[2:]
    return c.build(n_layers, False, MOE_ARCH, dtype=dtype)[2:]


def train_run(mesh, dtype):
    """``Trainer`` on Llama-3.2-1B whole (``chip_smoke.mesh_train``'s
    run: B 8 x S 1024, remat, no checkpoint written) for
    ``MESH_TRAIN_STEPS`` steps in ``dtype`` compute (float32 params
    either way), on ``mesh`` or unmeshed: losses, step seconds and this
    card's peak memory."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    c = cs()
    r = c.TRAIN_RUN
    cfg = get_config(c.TRAIN_ARCH).with_(block_style="residual_qpfree",
                                         dtype=dtype)
    ckdir = tempfile.mkdtemp(prefix="mesh4_ckpt_",
                             dir=os.path.join(ROOT, "build"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        tc = TrainerConfig(steps=c.MESH_TRAIN_STEPS, log_every=1,
                           ckpt_every=10 ** 9, ckpt_dir=ckdir, keep_ckpts=1,
                           lr=r["lr"], warmup=r["warmup"], remat=True)
        tr = Trainer(cfg, tc, DataConfig(global_batch=r["batch"],
                                         seq_len=r["seq_len"], seed=0),
                     device="cuda", mesh=mesh)
        tr._save = lambda step: None  # no 13 GB checkpoint here
        tr.run()
        out = {"losses": [x["loss"] for x in tr.metrics_log],
               "step_s": list(tr.straggler.durations),
               "peak_bytes": torch.cuda.max_memory_allocated()}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the reference: the unmeshed port on card 0
# ---------------------------------------------------------------------------

def reference() -> int:
    """The unmeshed runs the ranks are held against (see the module
    docstring, step 2)."""
    import torch

    c = cs()
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    prompts = mistral_prompts()
    new = c.MODEL_AXIS_NEW
    out = {"f32": {}, "bf16": {}, "hymba": {}, "moe": {}, "moe_bf16": {}}
    logits = {}

    def run(key, cfg, params, ps, merged, cache="dense", sched=False,
            probe=None, max_len=512, **kw):
        eng, res, counts, wall = c.serve(cfg, params, ps, new, cache=cache,
                                         sched=sched, probe=probe,
                                         max_len=max_len, **kw)
        tag = f"reference {key} {cache}"
        if sched:
            c.check_sched_counts(tag, counts, eng, merged)
        else:
            c.check_counts(tag, counts, eng, cfg.n_layers, len(ps), merged)
        return {"streams": c.streams(res), "counts": counts, "report":
                c.report(tag + (" scheduled" if sched else ""), res, wall)}

    with torch.no_grad():
        cfg, params, mcfg, mparams = c.build(c.EQ_LAYERS, calibrate=True)
        for cache in ("dense", "paged"):
            lg = []
            out["f32"][cache] = run("merged float32", mcfg, mparams, prompts,
                                    True, cache, probe=c.prefill_logits(lg),
                                    **c.pool_size(cache))
            logits[cache] = [t.cpu() for t in lg]
        del cfg, params, mparams
        torch.cuda.empty_cache()

        mcfg, mparams = c.build(32, calibrate=False, dtype="bfloat16")[2:]
        torch.cuda.empty_cache()
        c.serve(mcfg, mparams, prompts, new)  # warm-up
        for cache in ("dense", "paged", "paged_q8"):
            for sched in (False, True):
                out["bf16"][f"{cache}/{'sched' if sched else 'engine'}"] = \
                    run("merged bfloat16", mcfg, mparams, prompts, True,
                        cache, sched=c.MODEL_AXIS_SCHED if sched else False,
                        **c.pool_size(cache))
        del mparams
        torch.cuda.empty_cache()

        hcfg, hparams = c.build(c.EQ_LAYERS, True, HYMBA_ARCH)[2:]
        out["hymba"]["dense"] = run("hymba merged float32", hcfg, hparams,
                                    c.ssm_prompts(hcfg.vocab_size), False,
                                    max_len=c.SSM_MAX_LEN)
        del hparams
        torch.cuda.empty_cache()

        ecfg, eparams = moe_merge(c.EQ_LAYERS)
        mp = moe_prompts(ecfg.vocab_size)
        for cache in ("dense", "paged"):
            out["moe"][cache] = run("phi3.5-moe merged float32 no-drop",
                                    ecfg, eparams, mp, True, cache)
        del eparams
        torch.cuda.empty_cache()
        ecfg, eparams = moe_merge(MOE_BF16_LAYERS, "bfloat16")
        c.serve(ecfg, eparams, mp, new)  # warm-up
        out["moe_bf16"]["dense"] = run("phi3.5-moe merged bfloat16", ecfg,
                                       eparams, mp, True)
        del eparams
        torch.cuda.empty_cache()
    out["train"] = {dtype: train_run(None, dtype) for dtype in TRAIN_DTYPES}
    for dtype, x in out["train"].items():
        log(f"reference Trainer, {dtype}: losses {x['losses']}, step s "
            f"{[round(t, 3) for t in x['step_s']]}, peak "
            f"{x['peak_bytes'] / 1e9:.2f} GB")
    out["seconds"] = time.perf_counter() - t0
    torch.save(logits, REF_PT)
    with open(REF_JSON, "w") as f:
        json.dump(out, f)
    log(f"reference: {out['seconds']:.1f} s")
    return 0


# ---------------------------------------------------------------------------
# a rank
# ---------------------------------------------------------------------------

class Rank:
    """One rank's state: its parts' results, failures and launches."""

    def __init__(self, rank):
        from repro_torch.kernels import launch_counts
        self.rank = rank
        self.res = {"rank": rank, "failed": [], "streams": {}, "parts": {},
                    "collectives": {}, "engine_step": {}, "train": {}}
        self.launches = {k: 0 for k in launch_counts()}

    def phase(self, name):
        with open(os.path.join(ROOT, "build",
                               f"mesh4_rank_{self.rank}.phase"), "w") as f:
            f.write(name)
        log(f"[{time.strftime('%H:%M:%S')}] {name}")

    def part(self, name, fn, *args):
        """``fn(*args)`` as the part ``name``; afterwards every rank learns
        whether it failed on any rank (an all-reduce MIN of an int32
        flag), so that all of them go on to the next part together."""
        import torch
        import torch.distributed as dist

        self.phase(name)
        t0 = time.perf_counter()
        ok = 1
        try:
            self.res["parts"][name] = fn(*args)
        except Exception:  # recorded; the script fails at its end
            ok = 0
            log(f"FAILED {name}:\n{traceback.format_exc()}")
        flag = torch.tensor([ok], dtype=torch.int32, device="cuda")
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not int(flag.item()):
            self.res["failed"].append(name)
        log(f"{name}: {time.perf_counter() - t0:.1f} s"
            f"{'' if ok else ' (failed here)'}"
            f"{'' if flag.item() else ' (failed on a rank)'}")

    def count(self, counts):
        for k in self.launches:
            self.launches[k] += counts[k]


def serve_checked(R, tag, cfg, params, prompts, mesh, want, merged,
                  cache="dense", sched=False, max_len=512, **kw):
    """A meshed serve whose launches follow ``chip_smoke.check_counts``
    (``check_sched_counts``) and equal the reference's ``want`` run, and
    whose streams this rank records; returns (engine, streams, report)."""
    c = cs()
    eng, res, counts, wall = c.serve(cfg, params, prompts, c.MODEL_AXIS_NEW,
                                     cache=cache, sched=sched, mesh=mesh,
                                     max_len=max_len, **kw)
    if sched:
        c.check_sched_counts(tag, counts, eng, merged)
    else:
        c.check_counts(tag, counts, eng, cfg.n_layers, len(prompts), merged)
    if counts != want["counts"]:
        raise AssertionError(f"{tag}: launches {counts} != unmeshed "
                             f"{want['counts']}")
    R.count(counts)
    return eng, c.streams(res), c.report(tag, res, wall)


def part_a(R, mesh, shape, ref, logits):
    c = cs()
    emitted = {}
    want = {cache: (ref["f32"][cache]["streams"], logits[cache])
            for cache in ("dense", "paged")}
    out = c.model_axis_f32(mesh, mistral_prompts(), emitted,
                           name=mesh_name(shape), want=want)
    R.res["streams"][f"{mesh_key(shape)}/f32"] = emitted
    return out


def part_b(R, mesh, shape, ref, mcfg, placed):
    """(b) and (d) on the 32-layer bfloat16 merge."""
    import torch
    c = cs()
    prompts, name, out = mistral_prompts(), mesh_name(shape), {}
    emitted = R.res["streams"].setdefault(f"{mesh_key(shape)}/bf16", {})
    for cache in ("dense", "paged", "paged_q8"):
        for sched in (False, True):
            key = f"{cache}/{'sched' if sched else 'engine'}"
            want = ref["bf16"][key]
            tag = f"merged bfloat16 {cache}, {name} mesh"
            eng, got, rep = serve_checked(
                R, tag, mcfg, placed, prompts, mesh, want, True, cache,
                sched=c.MODEL_AXIS_SCHED if sched else False,
                **c.pool_size(cache))
            emitted[key] = got
            out[key] = {"agree_unmeshed": c.agreement(got, want["streams"]),
                        "meshed": rep, "unmeshed": want["report"]}
            log(f"  {name} mesh, bfloat16 32 layers, {key}: tokens shared "
                f"with the unmeshed engine {out[key]['agree_unmeshed']} (of "
                f"{c.MODEL_AXIS_NEW}); tok/s {rep['tok_s']:.2f} vs unmeshed "
                f"{want['report']['tok_s']:.2f}, TTFT mean "
                f"{rep['ttft_mean_s'] * 1e3:.1f} vs "
                f"{want['report']['ttft_mean_s'] * 1e3:.1f} ms")
            if not sched:
                R.res["engine_step"].setdefault(mesh_key(shape), {})[cache] \
                    = c.engine_step_collectives(eng)
            del eng
            torch.cuda.empty_cache()
    return out


def part_d(R, mesh, shape, mcfg, placed):
    c = cs()
    got = c.counted_steps(mcfg, placed, mesh, sizes=MESH4_STEPS)
    R.res["collectives"][mesh_key(shape)] = got
    for kind, x in got.items():
        log(c.moved_line(f"{mesh_name(shape)} mesh, {kind}", x, "NCCL"))
    return {k: {"comm_s": v["comm_s"], "wall_s": v["wall_s"]}
            for k, v in got.items()}


def part_c_f32(R, mesh, shape, ref, fam, model):
    """Hymba's (``fam`` "hymba": dense cache) or Phi-3.5-MoE's ("moe":
    dense and paged) merge at 4 calibrated float32 layers: the reference's
    streams."""
    c = cs()
    cfg, params = model
    if fam == "hymba":
        caches, ps, max_len, merged = (
            ("dense",), c.ssm_prompts(cfg.vocab_size), c.SSM_MAX_LEN, False)
    else:
        caches, ps, max_len, merged = (
            ("dense", "paged"), moe_prompts(cfg.vocab_size), 512, True)
    emitted = R.res["streams"].setdefault(f"{mesh_key(shape)}/families", {})
    placed = c.place_params(params, mesh)
    for cache in caches:
        want = ref[fam][cache]
        tag = f"{cfg.name} merged float32 {cache}, {mesh_name(shape)} mesh"
        eng, got, _ = serve_checked(R, tag, cfg, placed, ps, mesh, want,
                                    merged, cache, max_len=max_len)
        del eng
        emitted[f"{fam}/{cache}"] = got
        if got != want["streams"]:
            raise AssertionError(f"{tag}: streams {got} != unmeshed "
                                 f"{want['streams']}")
        log(f"  {tag}: streams == the unmeshed engine's")
    return list(caches)


def part_c_bf16(R, mesh, shape, ref, moe):
    c = cs()
    cfg, params = moe
    placed = c.place_params(params, mesh)
    want = ref["moe_bf16"]["dense"]
    tag = (f"{cfg.name} merged bfloat16 {cfg.n_layers} layers, "
           f"{mesh_name(shape)} mesh")
    eng, got, rep = serve_checked(R, tag, cfg, placed, moe_prompts(
        cfg.vocab_size), mesh, want, True)
    del eng, placed
    agree = c.agreement(got, want["streams"])
    log(f"  {tag}: launches == unmeshed; tokens shared {agree}; tok/s "
        f"{rep['tok_s']:.2f} vs unmeshed {want['report']['tok_s']:.2f}")
    return {"agree_unmeshed": agree, "meshed": rep,
            "unmeshed": want["report"]}


def part_e(R, mesh, shape, ref):
    """The float32 run is gated; the bfloat16 run (the training config's
    compute) is printed: there the model axis's row-parallel partial
    sums round to bfloat16 before they are summed, which the unmeshed
    product does not."""
    c = cs()
    out = {}
    for dtype in TRAIN_DTYPES:
        got = train_run(mesh, dtype)
        want = ref["train"][dtype]
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(got["losses"], want["losses"]))
        R.res["train"].setdefault(mesh_key(shape), {})[dtype] = dict(
            got, max_rel=rel)
        out[dtype] = rel
        log(f"  Trainer {c.TRAIN_ARCH} residual_qpfree whole, {dtype}, "
            f"{mesh_name(shape)} mesh, {c.MESH_TRAIN_STEPS} steps: losses "
            f"{got['losses']} vs unmeshed {want['losses']} (max rel "
            f"{rel:.2e}{'' if dtype == 'float32' else ', not gated'}); "
            f"step s {[round(x, 3) for x in got['step_s']]} vs unmeshed "
            f"{[round(x, 3) for x in want['step_s']]}; peak "
            f"{got['peak_bytes'] / 1e9:.2f} GB on this card")
        if len(got["losses"]) != c.MESH_TRAIN_STEPS or (
                dtype == "float32" and not rel <= c.MESH_TRAIN_RTOL):
            raise AssertionError(f"{dtype} meshed losses {got['losses']} vs "
                                 f"unmeshed {want['losses']}: rel {rel} > "
                                 f"{c.MESH_TRAIN_RTOL}")
    return out


def rank_main(rank: int) -> int:
    """One rank (card ``rank``): parts (a)-(e) on every mesh; writes
    ``build/mesh4_rank_<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    c = cs()
    from repro_torch.launch.mesh import make_host_mesh

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    R = Rank(rank)
    R.phase("init_process_group")
    dist.init_process_group(
        "nccl", init_method="file://" + PG_FILE, rank=rank,
        world_size=N_RANKS, device_id=torch.device("cuda", rank),
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    t0 = time.perf_counter()
    try:
        meshes = {s: make_host_mesh(*s, device_type="cuda") for s in MESHES}
        ref = json.load(open(REF_JSON))
        logits = torch.load(REF_PT)
        with torch.no_grad():
            for s, mesh in meshes.items():
                R.part(f"{mesh_key(s)} (a) float32 Mistral-7B", part_a, R,
                       mesh, s, ref, logits)
            R.phase("build bfloat16 Mistral-7B")
            mcfg, mparams = c.build(32, calibrate=False,
                                    dtype="bfloat16")[2:]
            torch.cuda.empty_cache()
            for s, mesh in meshes.items():
                # the full leaves stay for the next mesh: a replicated
                # leaf's placement is the leaf itself, a split one's a
                # copy of this rank's shard
                placed = c.place_params(mparams, mesh)
                R.part(f"{mesh_key(s)} (b) bfloat16 Mistral-7B", part_b, R,
                       mesh, s, ref, mcfg, placed)
                R.part(f"{mesh_key(s)} (d) collectives", part_d, R, mesh, s,
                       mcfg, placed)
                del placed
                torch.cuda.empty_cache()
            del mparams
            torch.cuda.empty_cache()
            R.phase("build Hymba-1.5B and Phi-3.5-MoE float32")
            hymba = tuple(c.build(c.EQ_LAYERS, True, HYMBA_ARCH)[2:])
            moe = tuple(moe_merge(c.EQ_LAYERS))
            torch.cuda.empty_cache()
            for s, mesh in meshes.items():
                for fam, model in (("hymba", hymba), ("moe", moe)):
                    R.part(f"{mesh_key(s)} (c) {fam} float32", part_c_f32, R,
                           mesh, s, ref, fam, model)
            del hymba, moe
            torch.cuda.empty_cache()
            R.phase("build Phi-3.5-MoE bfloat16")
            moe = tuple(moe_merge(MOE_BF16_LAYERS, "bfloat16"))
            torch.cuda.empty_cache()
            for s, mesh in meshes.items():
                R.part(f"{mesh_key(s)} (c) Phi-3.5-MoE bfloat16",
                       part_c_bf16, R, mesh, s, ref, moe)
            del moe
            torch.cuda.empty_cache()
        # the serving parts' peak: each Trainer run resets the counter
        R.res["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
        for s in TRAIN_MESHES:
            R.part(f"{mesh_key(s)} (e) Trainer", part_e, R, meshes[s], s, ref)
        R.res["launches"] = R.launches
        R.res["seconds"] = time.perf_counter() - t0
        with open(os.path.join(ROOT, "build", f"mesh4_rank_{rank}.json"),
                  "w") as f:
            json.dump(R.res, f)
        R.phase("done")
    finally:
        dist.destroy_process_group()
    return 1 if R.res["failed"] else 0


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------

def run_child(args, log_path, deadline):
    """``python3 chip_smoke_4.py <args>`` to its end or ``deadline``
    (killed there); returns its exit code (None if killed)."""
    with open(log_path, "w") as f:
        p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              *args], cwd=ROOT, stdout=f,
                             stderr=subprocess.STDOUT)
        try:
            return p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            return None


def run_ranks(deadline):
    """The four ranks, each to its end or ``deadline``: every rank is
    killed there.  Returns their exit codes (None: killed)."""
    procs = []
    for r in range(N_RANKS):
        phase = os.path.join(ROOT, "build", f"mesh4_rank_{r}.phase")
        if os.path.exists(phase):
            os.remove(phase)
        f = open(os.path.join(ROOT, "build", f"mesh4_rank_{r}.log"), "w")
        procs.append((f, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)))
    while time.time() < deadline and any(p.poll() is None
                                         for _, p in procs):
        time.sleep(1.0)
    codes = []
    for f, p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
            codes.append(None)
        else:
            codes.append(p.returncode)
        f.close()
    return codes


def rank_phase(r) -> str:
    path = os.path.join(ROOT, "build", f"mesh4_rank_{r}.phase")
    return open(path).read() if os.path.exists(path) else "not started"


def rank_outcome(r, code) -> str:
    """How rank ``r`` ended: killed at the deadline, or its exit code, and
    its last phase and failed parts."""
    how = "killed at the deadline" if code is None else f"exit {code}"
    path = os.path.join(ROOT, "build", f"mesh4_rank_{r}.json")
    failed = json.load(open(path))["failed"] if os.path.exists(path) \
        else None
    return (f"rank {r} {how} in phase {rank_phase(r)!r}"
            + ("" if failed is None else f", failed parts {failed}"))


def tail(path, n=40):
    return open(path).read().splitlines()[-n:] if os.path.exists(path) \
        else []


def check_collectives(res, preds):
    """(d): on every mesh each step's per-op counts and bytes, equal on
    the four ranks and equal to the dry run's prediction."""
    c = cs()
    keys = ("counts", "per_op_bytes", "total_bytes", "by_link")
    for s in MESHES:
        want = c.predicted(preds[s])
        if mesh_key(s) not in res[0]["collectives"]:
            continue  # (d) failed there: the ranks' exit codes say so
        for kind in MESH4_STEPS:
            for r, x in enumerate(res):
                got = x["collectives"][mesh_key(s)][kind]
                for k in keys:
                    if got[k] != want[kind][k]:
                        raise AssertionError(
                            f"{mesh_name(s)} mesh, {kind} step, rank {r}: "
                            f"{k} moved {got[k]} != the dry run's "
                            f"{want[kind][k]}")
            x = res[0]["collectives"][mesh_key(s)][kind]
            n = sum(x["counts"].values())
            _, B, S = MESH4_STEPS[kind]
            log(c.moved_line(
                f"{mesh_name(s)} mesh, merged bfloat16 32 layers, "
                f"build_step {kind} (B {B}, S {S}, impl cuda), ranks 0-3 == "
                f"the dry run's prediction", x, "NCCL")
                + f" (synchronised around each; "
                f"{1e3 * x['comm_s'] / max(n, 1):.3f} ms a collective, "
                f"per rank: {[round(y['collectives'][mesh_key(s)][kind]['comm_s'] * 1e3, 1) for y in res]} ms)")
        for cache, x in res[0]["engine_step"].get(mesh_key(s), {}).items():
            log(c.moved_line(f"{mesh_name(s)} mesh, Engine decode step, "
                             f"{cache}, rank 0", x, "NCCL"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke_4: torch.cuda.is_available() is False; this "
              "script needs four CUDA cards", file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    if n < N_RANKS:
        print(f"chip_smoke_4: needs {N_RANKS} CUDA cards (one NCCL rank "
              f"each); torch.cuda.device_count() is {n}", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")) or \
            not os.path.exists(os.path.join(ROOT, "chip_smoke.py")):
        print("chip_smoke_4: run it from the repository (src/ and "
              "chip_smoke.py beside it)", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    c = cs()
    stdout = sys.stdout
    with open(os.path.join(ROOT, "build", "chip_smoke_4.log"), "w") as f:
        sys.stdout = c.Tee(stdout, f)
        try:
            return run()
        finally:
            sys.stdout = stdout


def run() -> int:
    import torch
    from repro_torch.kernels import _build

    c = cs()
    t_start = time.time()
    deadline = t_start + DEADLINE_S
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for ln in smi:
        print(ln, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SOURCES)} CUDA sources with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    preds = {s: c.start_prediction(mesh_key(s), MESH4_STEPS)
             for s in MESHES}
    try:
        for path in (REF_JSON, REF_PT, PG_FILE, *[os.path.join(
                ROOT, "build", f"mesh4_rank_{r}.json")
                for r in range(N_RANKS)]):
            if os.path.exists(path):
                os.remove(path)
        t0 = time.perf_counter()
        ref_log = os.path.join(ROOT, "build", "mesh4_reference.log")
        code = run_child(["--reference"], ref_log, deadline)
        for ln in tail(ref_log, 10 ** 6):
            log(f"  [reference] {ln}")
        if code != 0:
            raise AssertionError(f"the reference exited {code}")
        log(f"reference (card 0, unmeshed): "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        codes = run_ranks(deadline)
        log(f"ranks: exit codes {codes} in {time.perf_counter() - t0:.1f} s")
        for r in range(N_RANKS):
            for ln in tail(os.path.join(ROOT, "build", f"mesh4_rank_{r}.log"),
                           10 ** 6 if r == 0 or codes[r] != 0 else 0):
                log(f"  [rank {r}] {ln}")
        paths = [os.path.join(ROOT, "build", f"mesh4_rank_{r}.json")
                 for r in range(N_RANKS)]
        if not all(os.path.exists(p) for p in paths):
            raise AssertionError("the ranks: " + "; ".join(
                rank_outcome(r, x) for r, x in enumerate(codes)))
        # every rank ran to its end: its failed parts are reported after
        # the checks that need no more than its results
        res = [json.load(open(p)) for p in paths]
        for r in range(1, N_RANKS):
            if res[r]["streams"] != res[0]["streams"]:
                raise AssertionError(f"rank {r} emitted other tokens than "
                                     f"rank 0")
        errors = []
        try:
            check_collectives(res, preds)
        except AssertionError as e:
            errors.append(str(e))
        if codes != [0] * N_RANKS:
            errors.append("the ranks: " + "; ".join(
                rank_outcome(r, x) for r, x in enumerate(codes)))
        if errors:
            raise AssertionError("; ".join(errors))
    finally:
        for procs in preds.values():
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if os.path.exists(PG_FILE):
            os.remove(PG_FILE)
    for r, x in enumerate(res):
        log(f"rank {r}: launches of (b) and (c) "
            f"{ {k: v for k, v in x['launches'].items() if v} }; "
            f"{x['seconds']:.1f} s; peak memory while serving "
            f"{x['serve_peak_bytes'] / 1e9:.2f} GB")
    log(f"cards: {smi}")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"launches_per_rank": [x["launches"] for x in res]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--reference"]:
        sys.exit(reference())
    sys.exit(main())

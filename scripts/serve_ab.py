"""Times the port's unmeshed serving path in two or more source trees, in
one process per tree run one after another on the same card, so that
their numbers share a host:

  python3 scripts/serve_ab.py build/parent . . build/parent

Each ROOT is a checkout of the repo (its ``chip_smoke.py`` and ``src/``).
In a process of its own, each builds its CUDA kernels, then serves merged
skipless Mistral-7B (full width, 32 layers, bfloat16, random weights from
seed 0, ``chip_smoke.build``) on the dense cache through
``Engine(impl="cuda")`` without a mesh: the path phase's four prompts
(16, 37, 100 and 250 tokens, 16 new tokens each, 4 slots), once to warm
up, then ``--reps`` times.  It reports the tok/s of each run and the wall
time of every decode step (``Engine.step``, which ends on the host copy
of the sampled tokens, so a step's wall time is its whole cost).  The
last line is one JSON object: the card (``nvidia-smi``'s name and power
limit) and, per run in order, the root, the tok/s and the step times'
median and mean in ms.  Needs a CUDA card.

``--checks`` instead times, on the host's CPU and without a card, the
mesh checks that a tree with ``repro_torch.distribution`` runs on the
unmeshed path (per call, in microseconds): ``placed.on_shards`` (once per
attention core), ``_build.refuse_placed`` on eight operands (twice per
kernel call: the ``ops`` wrapper and ``on_cuda``), ``placed.put_`` against
the plain indexed write it replaces (twice per layer), and
``placed.on_mesh(None)`` (once per step and per submit)."""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

PROMPT_LENS = (16, 37, 100, 250)
MAX_NEW = 16


def one(root: str, reps: int) -> dict:
    root = os.path.abspath(root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.serving import Engine

    _build.build_all()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, n) for n in PROMPT_LENS]
    steps = []
    real = Engine.step

    def timed(self):
        t0 = time.perf_counter()
        out = real(self)
        steps.append(time.perf_counter() - t0)
        return out

    Engine.step = timed
    tok_s = []
    with torch.no_grad():
        _, _, mcfg, mparams = chip_smoke.build(32, calibrate=False,
                                               dtype="bfloat16")
        chip_smoke.serve(mcfg, mparams, prompts, MAX_NEW)  # warm-up
        steps.clear()
        for _ in range(reps):
            _, outs, _, wall = chip_smoke.serve(mcfg, mparams, prompts,
                                                MAX_NEW)
            tok_s.append(sum(len(o) for o in outs) / wall)
    ms = [s * 1e3 for s in steps]
    return {"root": root, "tok_s": tok_s, "step_ms_median":
            statistics.median(ms), "step_ms_mean": statistics.fmean(ms),
            "steps": len(ms)}


def checks_us(root: str, n: int = 200000) -> dict:
    import timeit

    sys.path[:0] = [os.path.join(os.path.abspath(root), "src")]
    import torch

    from repro_torch.distribution.placed import on_mesh, on_shards, put_
    from repro_torch.kernels import _build

    q, k = torch.zeros(4, 32, 128), torch.zeros(4, 64, 8, 128)
    dst, v = torch.zeros(4, 64, 8, 128), torch.zeros(4, 8, 128)
    rows, slot = torch.arange(4), torch.zeros(4, dtype=torch.long)
    args = (q, k, k, k, q, None, 1, 2.0)

    def write():
        dst[rows, slot] = v

    def mesh_none():
        with on_mesh(None):
            pass

    cases = {"on_shards": lambda: on_shards("cuda", q, k, k),
             "refuse_placed": lambda: _build.refuse_placed("x", *args),
             "put_": lambda: put_(dst, (rows, slot), v),
             "indexed_write": write, "on_mesh_none": mesh_none}
    return {name: timeit.timeit(fn, number=n) / n * 1e6
            for name, fn in cases.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--one", action="store_true",
                    help="serve ROOT (one) in this process")
    ap.add_argument("--checks", action="store_true",
                    help="time ROOT's mesh checks on the host CPU")
    args = ap.parse_args(argv)
    if args.checks:
        print(json.dumps(checks_us(args.roots[0])))
        return 0
    if args.one:
        print(json.dumps(one(args.roots[0], args.reps)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    runs = []
    for root in args.roots:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", "--reps",
             str(args.reps), root], capture_output=True, text=True)
        if p.returncode:
            print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
            return p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{root}: tok/s {[round(x, 1) for x in r['tok_s']]}; decode "
              f"step median {r['step_ms_median']:.2f} ms, mean "
              f"{r['step_ms_mean']:.2f} ms over {r['steps']} steps",
              flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

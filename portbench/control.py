"""The control of a cell's comparison, and the program's readings beside
it, for the limit in ``limits/<cell>.json``:

    python3 portbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

In one process, for each seed: a run of the cell (a window of
``--seconds`` at the cell's own load), then, on the same sample of
finished requests and positions, the float32 reference's widest gap of
the served tokens (the program's reading) and of the tokens that the
float8 reference puts first (the control's).  One JSON line per seed.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    import argparse

    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    w = {c["name"]: c for c in harness.manifest()["workloads"]}[a.workload]
    spec, mix, limit = harness.cell_files(w)
    for seed in a.seeds:
        res = harness.run_cell(a.workload, spec, mix, limit, seed,
                               a.seconds, False, control=True)
        print(json.dumps({
            "workload": a.workload, "seed": seed,
            "program": res["compared"], "control": res.get("control"),
            "steps": len(res["run"].steps),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

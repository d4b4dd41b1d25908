"""Find the knee of an open-loop mix on a configuration: the highest
arrival rate at which the queue does not grow over a window.

    python3 portbench/sweep.py --config mistral7b-qpfree --traffic chat \\
        --seconds 20 --seed 5 --rates 1 1.5 2 2.5 3

In one process, one run per rate (the mix with ``rate_per_s`` replaced,
the drain cut to 5 s), each printing one JSON line: the requests due in
the window, those still without a first token at its middle and at its
close, and the TTFT median and 95th percentile.  A cell's fixed rate,
about four fifths of the knee, then goes into its own mix file.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def waiting_at(run, t: float) -> int:
    """Requests due by ``t`` with no first token by ``t``."""
    return sum(1 for r in run.tracked if r.due is not None and r.due <= t
               and not (r.times and r.times[0] <= t))


def main() -> int:
    import argparse

    import numpy as np
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load("configs", a.config)
    mix0 = harness.load("traffic", a.traffic)
    for rate in a.rates:
        mix = dict(mix0, rate_per_s=rate, drain_s=5.0)
        res = harness.run_cell(f"{a.config}.{a.traffic}", spec, mix, {},
                               a.seed, a.seconds, False)
        run = res["run"]
        due = run.due_in_window()
        ttft = [r.times[0] - r.due for r in due if r.times]
        print(json.dumps({
            "rate_per_s": rate, "due": len(due),
            "waiting_mid": waiting_at(run, run.t0 + run.seconds / 2),
            "waiting_end": waiting_at(run, run.t_end),
            "unserved": res["failed"],
            "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3,
            "compared": res["compared"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

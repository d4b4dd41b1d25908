"""The port's own spans in a traced run: the observer's ring
(``Run.obs_events``, ``repro_torch.obs``), whose engine track holds a
``step`` span per decode step and whose phase track holds the spans
inside the engine's calls (``engine::init``, ``engine::submit``,
``engine::wait``), all on ``time.perf_counter``, the harness's clock.  A
program without the phase track, or a run without the observer, gives
nothing to read."""
from __future__ import annotations

from bisect import bisect_left
from typing import List, Tuple

ENGINE = ("engine", 0)
PHASE = ("phase", 0)


def spans(run, track, name: str) -> List[Tuple[float, float]]:
    """(start, end) of each complete event ``name`` on ``track``, in
    order of start."""
    return sorted((e["t0"], e["t0"] + e["dur"]) for e in run.obs_events or ()
                  if e["ph"] == "X" and tuple(e["track"]) == track
                  and e["name"] == name)


def window_steps(run) -> List[Tuple[float, float]]:
    """(seconds, seconds waited in ``engine::wait``) of each engine step
    that ends in the window and holds a wait; empty where none does."""
    waits = spans(run, PHASE, "engine::wait")
    starts = [a for a, _ in waits]
    out = []
    for a, b in spans(run, ENGINE, "step"):
        if not run.in_window(b):
            continue
        held = []
        for i in range(bisect_left(starts, a), len(waits)):
            if waits[i][0] > b:
                break
            if waits[i][1] <= b:
                held.append(waits[i][1] - waits[i][0])
        if held:
            out.append((b - a, sum(held)))
    return out

"""Seconds of set-up spent in the engine: its construction (the port's
``engine::init`` span: pool, prefill program) and every ``engine::submit``
span that ends before the window (the warm-up's and the first wave's
prefills)."""
from portbench.spans import PHASE, spans


def read(run):
    init = spans(run, PHASE, "engine::init")
    if not init:
        return None
    early = [s for s in spans(run, PHASE, "engine::submit") if s[1] <= run.t0]
    return sum(b - a for a, b in init + early)

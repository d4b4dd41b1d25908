"""Blocking host<->device transfers per decode step in the window: the
rise of the engine's ``n_step_syncs`` counter over the rise of its
``n_steps`` between the window's first and last reading."""


def read(run):
    s0, s1 = run.stats0, run.stats1
    if "n_step_syncs" not in s0 or "n_step_syncs" not in s1:
        return None
    steps = s1["n_steps"] - s0["n_steps"]
    return (s1["n_step_syncs"] - s0["n_step_syncs"]) / steps if steps \
        else None

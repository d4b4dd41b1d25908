"""Share of the traced slice's wall time in which no operation ran on the
device."""


def read(run):
    if run.trace is None or run.mix["loop"] != "closed":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

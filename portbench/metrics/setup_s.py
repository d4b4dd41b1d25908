"""Seconds from process start to the window: loading, the kernels' build
where it runs, the weights, the engine and its pool, the warm-up, and the
first wave or the arrivals' lead."""


def read(run):
    return run.setup_s

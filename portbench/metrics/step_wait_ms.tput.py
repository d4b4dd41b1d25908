"""Mean time a window step waits for the device: the port's
``engine::wait`` span (the blocking read of the sampled tokens) inside
each of the window's engine-track ``step`` spans."""
from portbench.spans import window_steps


def read(run):
    d = window_steps(run)
    return sum(w for _, w in d) / len(d) * 1e3 if d else None

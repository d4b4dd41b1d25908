"""Mean host time of a window step: each of the window's engine-track
``step`` spans less its ``engine::wait`` span (the blocking read of the
sampled tokens), so that wait and host time add up to the program's own
step time."""
from portbench.spans import window_steps


def read(run):
    d = window_steps(run)
    return sum(s - w for s, w in d) / len(d) * 1e3 if d else None

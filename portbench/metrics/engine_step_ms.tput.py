"""Mean host time of ``Engine.step`` (the batched decode step), from the
harness's spans around it, over the window's steps."""


def read(run):
    d = [s.t1 - s.t0 for s in run.steps if run.in_window(s.t1)]
    return sum(d) / len(d) * 1e3 if d else None

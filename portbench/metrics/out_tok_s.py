"""Output tokens that became visible in the window, over the window's
seconds (every token of every request, the prefill's first ones too)."""


def read(run):
    n = sum(1 for r in run.tracked for t in r.times if run.in_window(t))
    return n / run.window_s if run.mix["loop"] == "closed" else None

"""The model FLOPs of the window's prefills and decode steps (true
lengths, routed experts only), over the window's seconds and the chip's
bf16 peak, in percent."""
from portbench.roofline import counts, peaks


def read(run):
    if run.mix["loop"] != "closed":
        return None
    flops = sum(counts.decode_flops(run.s, s.ctx) for s in run.steps
                if run.in_window(s.t1))
    flops += sum(counts.prefill_flops(run.s, p.n) for p in run.submits
                 if run.in_window(p.t1))
    return 100.0 * flops / run.window_s / peaks.BF16_FLOPS

"""The merged flash prefill kernel's share of its roofline in the traced
slice: the larger of its calls' bytes over the HBM rate and their FLOPs
over the bf16 peak (``roofline.counts.flash``, one call a layer and
prefill, true lengths), against the device time of the kernels launched
inside the ``repro_torch::flash_attention_merged_bsd`` operator."""
from portbench.roofline import counts, peaks

OP = "repro_torch::flash_attention_merged_bsd"


def read(run):
    if run.trace is None or not run.trace["op_device_s"].get(OP):
        return None
    calls = [counts.flash(run.s, p.n) for p in run.submits if p.in_slice]
    least = sum(max(c["bytes"] / peaks.HBM_BYTES_PER_S,
                    c["flops"] / peaks.BF16_FLOPS) for c in calls)
    return 100.0 * least * run.s["L"] / run.trace["op_device_s"][OP]

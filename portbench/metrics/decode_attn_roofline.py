"""The paged merged decode kernel's share of its roofline in the traced
slice: the bytes its calls need (``roofline.counts.decode_attn``, one
call a layer and step, the active slots' true contexts) over the HBM
rate, against the device time of the kernels launched inside the
``repro_torch::decode_attention_paged_merged_bsd`` operator."""
from portbench.roofline import counts, peaks

OP = "repro_torch::decode_attention_paged_merged_bsd"


def read(run):
    if run.trace is None or not run.trace["op_device_s"].get(OP):
        return None
    need = sum(counts.decode_attn(run.s, s.ctx)["bytes"]
               for s in run.steps if s.in_slice) * run.s["L"]
    return 100.0 * need / peaks.HBM_BYTES_PER_S / run.trace["op_device_s"][OP]

"""Hand-written CUDA kernels for attention over the dense cache, the paged
pool and the int8 paged pool, and for the Mamba2 SSD scan, with their
plain PyTorch versions (``ref``), the model-layout wrappers (``ops``) and
the int8 pool's quantization (``quant``, plain torch on every route).

Importing this package builds nothing and needs no card: it defines each
kernel's operator (``torch.ops.repro_torch.<name>``, ``_build.define_op``);
a kernel is built from ``csrc/`` at its first launch (``_build``).
"""
from typing import Dict

from repro_torch.kernels import decode_attention, flash_attention, ssd_scan

_COUNTERS = (decode_attention.launches, flash_attention.launches,
             ssd_scan.launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    out: Dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0

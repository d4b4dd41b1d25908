"""Hand-written CUDA kernels for the dense attention path, with their plain
PyTorch versions (``ref``) and the model-layout wrappers (``ops``).

Importing this package builds nothing and needs no card: a kernel is built
from ``csrc/`` at its first launch (``_build``).
"""
from typing import Dict

from repro_torch.kernels import decode_attention, flash_attention

_COUNTERS = (decode_attention.launches, flash_attention.launches)


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

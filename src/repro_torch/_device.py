"""The one place that turns a device argument into a ``torch.device``."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising ``RuntimeError`` for a CUDA device
    when no card is present: entry points never carry on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (impl='torch') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        # "meta" included: shapes come from ``models.param_shapes`` and
        # ``launch.steps``, never from an entry point
        raise ValueError(f"unsupported device {device!r}")
    return dev

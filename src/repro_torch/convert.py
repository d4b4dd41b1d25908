"""The weight bridge between the JAX package's parameter trees and the
port's.

A JAX parameter tree, brought to the host as numpy arrays (``np.asarray``
of each leaf), becomes the port's nested dict of tensors with ``to_torch``;
``from_torch`` goes back.  Both ALWAYS copy: ``torch.from_numpy`` shares
memory with its array, and a tree that aliases host buffers another
framework still owns is the aliasing bug class the serving layer guards
against.  bfloat16 leaves (``ml_dtypes`` arrays on the numpy side, which
torch cannot wrap) travel through float32, which is lossless both ways;
``from_torch`` returns them as float32 arrays for the caller to narrow.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_map


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32))  # astype copies
        return t.to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return np.array(t.cpu().numpy(), copy=True)


def to_torch(tree: Any, device="cuda") -> Any:
    """numpy (or array-like) tree -> tree of tensors on ``device``; copies."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, dev), tree)


def from_torch(tree: Any) -> Any:
    """tree of tensors -> tree of numpy arrays on the host; copies.
    bfloat16 leaves come back as float32."""
    return tree_map(_leaf_to_numpy, tree)

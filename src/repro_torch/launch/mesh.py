"""Device meshes: the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group the caller has started (``torch.distributed.
init_process_group``: ``torchrun``'s environment, or a ``file://`` /
``tcp://localhost`` rendezvous); nothing here starts one.  The dry run's
production meshes (256 and 512 chips) exist only as shapes
(``MeshShape``): the spec layer (``distribution.sharding``) reads axis
names and sizes only, so no process stands behind them.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple


class MeshShape:
    """A shape-only mesh: axis names -> sizes, read by ``make_rules``,
    ``evenly`` and ``check_divisibility`` as they read a ``DeviceMesh``."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"MeshShape({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The dry run's production mesh, as a SHAPE only (no ranks, no
    devices): 16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(shape, axes)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` names over the current
    process group (whose world size must be the mesh's size)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(n_data: int = 1, n_model: int = 1,
                   device_type: str = "cuda"):
    """A (n_data, n_model) ("data", "model") mesh covering the current
    world."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n_data * n_model != n:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model}"
                         f" ranks; the world has {n}")
    return make_mesh((n_data, n_model), ("data", "model"), device_type)

"""The distribution layer: partition specs for every tree the port places
on a device mesh, and their placement as DTensors (``sharding``)."""
from repro_torch.distribution import sharding

__all__ = ["sharding"]

"""PyTorch/CUDA port of the skipless-transformer serving system.

Mirrors the JAX package ``repro`` module for module (configs, models,
kernels, core.merge, serving, launch) and never imports it.  Entry points
take ``device="cuda"`` by default and raise ``RuntimeError`` when no card
is present; pass ``device="cpu"`` (with ``impl="torch"``) to run the plain
PyTorch versions on the CPU.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]

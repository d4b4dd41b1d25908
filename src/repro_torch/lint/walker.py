"""Shared traversal of traced PyTorch programs: ONE walk over a
``torch.fx`` graph.

Counterpart of ``repro.lint.walker``.  Every structural assertion the
lint makes about a serving program ("the merged program has no Q
matmul", "paged prefill allocates no max_len-sized buffer", "the step
reads no device data on the host") needs the same traversal.  Where the
reference walks a jaxpr and recurses into ``scan`` bodies, ``cond``
branches and ``pallas_call`` kernel bodies, the port traces its program
with ``make_fx(fn, tracing_mode="real")`` (``trace``), which executes it
on real tensors and records every aten op.  Python control flow is
unrolled, so a program over L layers holds L layer bodies (JAX scans the
layers: its program holds one), and the graph is flat: no scan body or
branch to recurse into.

A kernel is one opaque node: each kernel entry point is an operator of
the ``repro_torch`` namespace (``kernels._build.define_op``), the
counterpart of the ``pallas_call`` primitive, so its body is not in the
graph on either device (``kernel_nodes``).

Every node's result carries its shape and dtype in ``node.meta["val"]``;
``iter_values`` yields them, placeholders included (the counterpart of
``iter_avals``).  ``donated_flat_indices`` and ``stablehlo_arg_attrs``
have no counterpart: there is no jit, hence no lowered module.
"""
from __future__ import annotations

from typing import Any, Iterator, List

import torch
from torch._guards import TracingContext, tracing
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

#: the namespace of the kernel operators (``torch.ops.repro_torch``)
KERNEL_NAMESPACE = "repro_torch"

#: matrix products: what ``dot_general`` is to a jaxpr.  ``torch.matmul``,
#: ``einsum`` and ``F.linear`` decompose under ``make_fx`` into these (and
#: views); a kernel operator's own products are inside it, not here
MATMUL_OPS = frozenset({
    "aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm", "aten.mv",
    "aten.addmv", "aten.dot", "aten.addbmm",
})

#: ops whose presence means the host waits for the device: a value read on
#: the host (``.item()``, ``int(t)``, ``bool(t)``), an output whose SHAPE
#: depends on device data (``nonzero``, ``masked_select``, ``unique``), or
#: a comparison answered on the host (``equal``).  The counterpart of the
#: reference's ``HOST_TRANSFER_PRIMITIVES``; ``host_sync_nodes`` adds
#: boolean-mask indexing (a hidden ``nonzero``), copies from a device to
#: the CPU, and blocking copies from the CPU to a device (from pageable
#: memory such a copy waits for the device's queue)
HOST_SYNC_OPS = frozenset({
    "aten.nonzero", "aten._local_scalar_dense", "aten.is_nonzero",
    "aten.equal", "aten.masked_select", "aten._unique2", "aten.unique_dim",
    "aten.unique_consecutive",
})

_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})
_COPY_OPS = frozenset({"aten._to_copy", "aten.copy", "aten.copy_"})


def trace(fn, *args) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="real")(*args)`` under ``no_grad``: the
    program runs once on the real tensors (in-place writes land in them)
    and every aten op it made is a node.  A value the program reads on the
    host (``.item()``, ``bool(t)``) is recorded as an
    ``aten._local_scalar_dense`` node rather than refused, so the rules
    can report it.  Kernel operators run their implementation for the
    tensors' device: on the card they launch."""
    # one fake mode for the whole trace: ``make_fx`` records each value's
    # shape and dtype as a fake tensor, and without a mode in the tracing
    # context it builds a new one per value (a third of the trace's time)
    fake = FakeTensorMode(allow_fallback_kernels=True)
    with torch.no_grad(), tracing(TracingContext(fake)):
        return make_fx(fn, tracing_mode="real",
                       _error_on_data_dependent_ops=False)(*args)


def as_graph(program) -> torch.fx.Graph:
    """Accept a ``torch.fx.Graph`` or anything carrying ``.graph`` (a
    ``GraphModule``) and return the graph."""
    if isinstance(program, torch.fx.Graph):
        return program
    graph = getattr(program, "graph", None)
    if isinstance(graph, torch.fx.Graph):
        return graph
    raise TypeError(f"not a traced program: {type(program)!r}")


def iter_nodes(program) -> Iterator[torch.fx.Node]:
    """Every node of the program."""
    yield from as_graph(program).nodes


def op_name(node: torch.fx.Node) -> str:
    """``namespace.op`` of a call (``aten.mm``, ``repro_torch.<kernel>``),
    overload dropped; the function's name for a plain Python callable;
    "" for placeholders and outputs."""
    if node.op != "call_function":
        return ""
    t = node.target
    packet = getattr(t, "overloadpacket", None)
    if packet is not None:
        return str(packet)
    return getattr(t, "__name__", str(t))


def tensors_of(val) -> Iterator[Any]:
    """The tensors in a node's ``meta["val"]`` (one, or a tuple)."""
    if isinstance(val, torch.Tensor):
        yield val
    elif isinstance(val, (tuple, list)):
        for v in val:
            yield from tensors_of(v)


def iter_values(program) -> Iterator[Any]:
    """Every tensor value the program touches (placeholders, op results,
    kernel results): the ``meta["val"]`` of each node, each carrying its
    shape and dtype."""
    for node in iter_nodes(program):
        yield from tensors_of(node.meta.get("val"))


def count_op(program, name: str) -> int:
    """Calls of op ``name`` (e.g. ``"aten.mm"``) anywhere in the program."""
    return sum(1 for n in iter_nodes(program) if op_name(n) == name)


def count_matmuls(program) -> int:
    """Matrix-product nodes (``MATMUL_OPS``) anywhere in the program."""
    return sum(1 for n in iter_nodes(program) if op_name(n) in MATMUL_OPS)


def op_names(program) -> List[str]:
    """Sorted distinct op names anywhere in the program."""
    return sorted({op_name(n) for n in iter_nodes(program)} - {""})


def kernel_nodes(program) -> List[torch.fx.Node]:
    """The kernel calls of the program: nodes of ``repro_torch``
    operators, each one opaque node (counterpart of ``kernel_jaxprs``)."""
    return [n for n in iter_nodes(program)
            if op_name(n).split(".")[0] == KERNEL_NAMESPACE]


def values_with_dim(program, size: int) -> List[Any]:
    """Values with ``size`` as one of their dimensions — e.g. every
    max_len-sized buffer a paged prefill was supposed to have deleted."""
    return [v for v in iter_values(program) if size in tuple(v.shape)]


def _device(node) -> str:
    val = node.meta.get("val") if isinstance(node, torch.fx.Node) else node
    return val.device.type if isinstance(val, torch.Tensor) else ""


def host_sync_nodes(program) -> List[str]:
    """The op name of every node that makes the host wait for the device
    (``HOST_SYNC_OPS``, indexing by a boolean mask, a copy between the
    CPU and a device but a non-blocking one to the device), in program
    order.  A program traced on the CPU has no copy to show: its
    counterpart on the card does."""
    out: List[str] = []
    for node in iter_nodes(program):
        name = op_name(node)
        if name in HOST_SYNC_OPS:
            out.append(name)
        elif name in _INDEX_OPS and any(
                isinstance(i, torch.fx.Node) and isinstance(
                    i.meta.get("val"), torch.Tensor)
                and i.meta["val"].dtype == torch.bool
                for a in node.args[1:2] for i in (a or ())):
            out.append(f"{name}(bool mask)")
        elif name in _COPY_OPS:
            srcs = [a for a in node.args if isinstance(a, torch.fx.Node)]
            src = _device(srcs[-1] if name == "aten.copy_" else srcs[0])
            dst = _device(node)
            blocking = not node.kwargs.get(
                "non_blocking", name == "aten.copy_" and len(node.args) > 2
                and node.args[2])
            if src and dst and src != dst and "cpu" in (src, dst) and (
                    dst == "cpu" or blocking):
                out.append(f"{name}({src} to {dst})")
    return out

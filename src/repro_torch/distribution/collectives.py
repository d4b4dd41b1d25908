"""What one rank's step moves and computes: a dispatch mode shared by the
dry run (``launch.dryrun``, over a process group that moves nothing) and
the card (``chip_smoke.py``, over a real group), so that the prediction
and the measurement are one count.

``StepCounter`` is a ``TorchDispatchMode``.  An op on DTensors it hands
back to DTensor (it returns ``NotImplemented``), so DTensor's dispatch
runs beneath it and the mode sees what this rank runs: the local op on
the local shards, and the collectives of every redistribution DTensor
plans.  It records

  * every collective this rank starts, with its operand bytes on this
    rank and the ranks of its group: the functional ones DTensor runs
    (``_c10d_functional``: ``all_reduce``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_to_all_single``, and
    ``_dtensor.shard_dim_alltoall`` on a CUDA mesh) and the c10d ones the
    port calls itself (``placed.combine_softmax``'s all-reduces,
    ``placed.copy_page_``'s broadcast).  A collective of another kind
    raises: nothing moves uncounted;
  * the FLOPs of each local op, by ``torch.utils.flop_counter``'s formulas
    (matmuls, convolutions) over the local shards' shapes: a mode above
    DTensor would see the global shapes, this one sees a rank's.  A
    kernel operator (``torch.ops.repro_torch``) has no formula and counts
    none;
  * the bytes each local op reads and writes: its tensor operands' and
    results' bytes, views excluded.  Nothing is fused, so this is an upper
    bound of what a fusing compiler (XLA's "bytes accessed") counts.

DTensor's sharding propagation runs some ops on fake tensors; those are
not this rank's work and are skipped, as are allocations (``empty``).

Operand bytes follow the reference's HLO convention: an all-reduce's
buffer, an all-gather's local shard, a reduce-scatter's whole input, an
all-to-all's input, a broadcast's buffer.  ``by_link`` splits the bytes
by the links a group spans on H100 HGX nodes of ``NODE`` GPUs (ranks
``8k .. 8k+7`` on one node): "nvlink" inside one node, "network" across
nodes.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: GPUs of one HGX node: a group inside ranks 8k .. 8k+7 rides NVLink
NODE = 8

#: the reference's collective names (``repro.launch.dryrun._COLLECTIVES``)
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (trailing "_" of in-place variants dropped) -> collective
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast"}
# c10d op -> (collective, index of its operand argument)
_C10D = {"allreduce_": ("all-reduce", 0),
         "allreduce_coalesced_": ("all-reduce", 0),
         "broadcast_": ("broadcast", 0),
         "allgather_": ("all-gather", 1),
         "_allgather_base_": ("all-gather", 1),
         "allgather_into_tensor_coalesced_": ("all-gather", 1),
         "reduce_scatter_": ("reduce-scatter", 1),
         "_reduce_scatter_base_": ("reduce-scatter", 1),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
         "alltoall_base_": ("all-to-all", 1)}
# DTensor's Shard -> Shard redistribution on a CUDA mesh (on a CPU mesh it
# all-gathers and keeps its chunk)
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}
_QUIET = {"wait_tensor", "_wrap_tensor_autograd"}
_COMM = ("c10d", "_c10d_functional", "_c10d_functional_autograd",
         "_dtensor")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def link_of(ranks) -> str:
    """"nvlink" for a group inside one node, "network" across nodes."""
    return "nvlink" if len({int(r) // NODE for r in ranks}) == 1 \
        else "network"


def _ranks_of_name(name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


def _ranks_of_group(obj) -> Tuple[int, ...]:
    import torch.distributed as dist

    if not isinstance(obj, dist.ProcessGroup):
        obj = dist.ProcessGroup.unbox(obj)
    return tuple(dist.get_process_group_ranks(obj))


class StepCounter(TorchDispatchMode):
    """Counts this rank's collectives, FLOPs and bytes accessed while it is
    entered (``with StepCounter() as c: step(...)``; ``c.record()``).
    ``comm_s`` is the host's seconds inside the collectives and their
    waits: on a group whose collectives block (gloo), the time they
    take.  A collective on CUDA tensors (NCCL runs it on a device stream,
    and the host returns at once) is timed between two synchronisations
    of the device: ``comm_s`` is then its time on the device, waits for
    the slowest rank included (each step runs slower for it)."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, int, Tuple[int, ...]]] = []
        self.flops = 0
        self.bytes_accessed = 0
        self.comm_s = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches beneath the mode
        ns, name = func.namespace, func._opname
        if ns in _COMM:
            if name not in _QUIET:
                self._collective(ns, name, args, kwargs)
            sync = any(t.is_cuda for t in tree_flatten((args, kwargs))[0]
                       if isinstance(t, torch.Tensor))
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return func(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.comm_s += time.perf_counter() - t0
        out = func(*args, **kwargs)
        if not func.is_view and not name.startswith("empty") and \
                not self._fake(args, out):
            from torch.utils.flop_counter import flop_registry

            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += int(count(*args, **kwargs, out_val=out))
            self.bytes_accessed += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    @staticmethod
    def _fake(args, out) -> bool:
        from torch._subclasses.fake_tensor import FakeTensor

        return any(isinstance(t, FakeTensor)
                   for t in tree_flatten((args, out))[0])

    def _collective(self, ns, name, args, kwargs) -> None:
        if ns == "c10d":
            if name not in _C10D:
                raise ValueError(f"StepCounter: uncounted collective "
                                 f"c10d.{name}")
            op, i = _C10D[name]
            pg = next(a for a in args if not isinstance(a, (list, tuple))
                      and not isinstance(a, torch.Tensor)
                      and type(a).__name__ in ("ScriptObject",
                                               "ProcessGroup"))
            self.calls.append((op, _nbytes(args[i]), _ranks_of_group(pg)))
            return
        op = (_DTENSOR if ns == "_dtensor" else _FUNCTIONAL).get(
            name.rstrip("_"))
        if op is None:
            raise ValueError(f"StepCounter: uncounted collective "
                             f"{ns}.{name}")
        group = [a for a in tuple(args) + tuple(kwargs.values())
                 if isinstance(a, str)][-1]
        self.calls.append((op, _nbytes(args[0]), _ranks_of_name(group)))

    def collectives(self) -> Dict[str, Any]:
        """``{"per_op_bytes", "counts", "total_bytes", "by_link"}`` under
        the reference's op names ("broadcast" only where one ran)."""
        names = list(COLLECTIVES) + (
            ["broadcast"] if any(c[0] == "broadcast" for c in self.calls)
            else [])
        per_op = {n: 0 for n in names}
        counts = {n: 0 for n in names}
        by_link = {"nvlink": 0, "network": 0}
        for op, nbytes, ranks in self.calls:
            per_op[op] += nbytes
            counts[op] += 1
            by_link[link_of(ranks)] += nbytes
        return {"per_op_bytes": per_op, "counts": counts,
                "total_bytes": sum(per_op.values()), "by_link": by_link}

    def record(self) -> Dict[str, Any]:
        """This rank's ``collectives``, ``flops`` and ``bytes_accessed``."""
        return {"collectives": self.collectives(), "flops": self.flops,
                "bytes_accessed": self.bytes_accessed}

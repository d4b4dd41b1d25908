"""The train step and the resumable Trainer: the counterpart of
``repro.training.train_loop``.

``make_train_step`` builds one step over the port's parameter trees:
  * float32 params and optimizer state, compute in ``cfg.dtype`` (the
    forward casts each weight where it uses it, and the gradients flow
    back through those casts into float32);
  * activation checkpointing (``remat``: False, True or "dots") around
    each block (``models.transformer._remat_block``);
  * gradient-accumulation micro-batches, summed in float32 and divided,
    as the reference's scan does;
  * the MoE aux-loss weighting.
The step runs the plain PyTorch forward (``impl="torch"``, the port of
the reference's XLA cores, through which the reference trains): the
hand-written CUDA kernels have no backward, so ``impl="cuda"`` is
refused.

``Trainer`` owns the mesh and its placements, checkpoint/resume,
preemption, straggler monitoring and metrics logging, as the reference's
does.  Without a checkpoint it starts from the port's own ``init_params``
(torch generators cannot reproduce JAX's PRNG); with one, from the
checkpoint, whichever package wrote it.

Under a device mesh (``mesh=``, one process per rank) the params and the
optimizer moments are DTensors placed per
``distribution.sharding.param_pspecs`` / ``opt_pspecs`` after ``evenly``,
and each batch is split on its first dim over the data axes.  The
gradients of a data-split batch come back ``Partial`` over the data axes:
they are reduced to their param's placement before the optimizer, whose
global-norm clip then sums the whole norm.  Checkpoints stay host-layout
and mesh-free: the trees are gathered whole, rank 0 writes, and every
rank restores (so a run can resume on another mesh).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.placed import full, is_placed, on_mesh, reanchor
from repro_torch.models import forward_seq, init_params, lm_loss
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.data import DataConfig, make_dataset
from repro_torch.training.fault_tolerance import (
    PREEMPTION_EXIT_CODE, PreemptionHandler, StragglerMonitor)
from repro_torch.training.optimizer import make_optimizer


def make_loss_fn(cfg: ModelConfig, *, aux_weight: float = 1e-2,
                 remat: Union[bool, str] = True, impl: str = "torch",
                 logits_sharding=None, stream_sharding=None,
                 qkv_sharding=None):
    """``loss_fn(params, batch) -> (loss + aux_weight * aux, {"loss",
    "aux_loss"})``; ``batch`` holds "inputs", "labels" and, for a VLM,
    "vision".  Under a mesh the ``*_sharding`` specs re-anchor the logits,
    the stream after each block and q/k/v (``placed.reanchor``)."""
    if impl != "torch":
        raise ValueError(f"impl={impl!r}: only the plain PyTorch forward "
                         "(impl='torch') is differentiable; the CUDA "
                         "kernels have no backward")

    def loss_fn(params, batch):
        logits, aux, _ = forward_seq(params, cfg, batch["inputs"],
                                     vision=batch.get("vision"), impl=impl,
                                     remat=remat,
                                     stream_sharding=stream_sharding,
                                     qkv_sharding=qkv_sharding)
        logits = reanchor(logits, logits_sharding)
        loss = lm_loss(logits, batch["labels"], vocab_size=cfg.vocab_size)
        return loss + aux_weight * aux, {"loss": loss, "aux_loss": aux}
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(metrics, grads): grads a tree like ``params``, ``None`` where the
    loss does not reach a leaf.  The leaves are differentiated through
    detached aliases, so the caller's tensors never require grad."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        total, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    by_leaf = dict(zip(map(id, leaves), grads))

    def grad_of(p):
        g = by_leaf[id(p)]
        if is_placed(g) and tuple(g.placements) != tuple(p.placements):
            # a data-split batch leaves it Partial over the data axes
            g = g.redistribute(p.device_mesh, p.placements)
        return g

    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(grad_of, live))


def make_train_step(cfg: ModelConfig, optimizer, *, grad_accum: int = 1,
                    aux_weight: float = 1e-2, remat: Union[bool, str] = True,
                    impl: str = "torch", logits_sharding=None,
                    stream_sharding=None, qkv_sharding=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the optimizer updates ``params`` and the moments in
    place (``training.optimizer``).  ``grad_accum`` splits the batch into
    that many micro-batches along axis 0.  The ``*_sharding`` specs are
    ``make_loss_fn``'s."""
    loss_fn = make_loss_fn(cfg, aux_weight=aux_weight, remat=remat,
                           impl=impl, logits_sharding=logits_sharding,
                           stream_sharding=stream_sharding,
                           qkv_sharding=qkv_sharding)

    def train_step(params, opt_state, batch):
        if grad_accum <= 1:
            metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            B = batch["inputs"].shape[0]
            if B % grad_accum:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"grad_accum {grad_accum}")
            mb = B // grad_accum
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            metrics = None
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = _value_and_grad(loss_fn, params, micro)
                for acc, x in zip(tree_leaves(grads), tree_leaves(g)):
                    if x is not None:
                        acc.add_(x)
                metrics = m if metrics is None else \
                    {k: metrics[k] + m[k] for k in m}
            grads = tree_map(lambda g: g.div_(grad_accum), grads)
            metrics = {k: v / grad_accum for k, v in metrics.items()}
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, metrics

    return train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_torch_ckpt"
    keep_ckpts: int = 3
    lr: float = 3e-4
    warmup: int = 10
    weight_decay: float = 0.1
    grad_accum: int = 1
    optimizer: str = "adamw"
    seed: int = 0
    remat: Union[bool, str] = True
    straggler_factor: float = 3.0
    stop_after: Optional[int] = None  # pause mid-schedule (e.g. simulated
    # preemption windows in tests); LR schedule still spans `steps`


class Trainer:
    """Resumable trainer: the reference's production loop.  ``params`` and
    ``opt_state`` are tensors (``requires_grad`` off) on ``device``, plain
    without a mesh (a merge or an ``Engine`` takes them as it takes
    ``init_params``'s) and DTensors under ``mesh`` (``host_params()``
    gathers them whole)."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig, dc: DataConfig,
                 corpus_path: Optional[str] = None, device="cuda",
                 mesh=None):
        self.cfg, self.tc, self.dc = cfg, tc, dc
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, None
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device_type!r}, the "
                             f"trainer runs on {self.device.type!r}")
        self.dataset = make_dataset(cfg, dc, corpus_path)
        self.optimizer = make_optimizer(tc.optimizer, tc.lr, tc.warmup,
                                        tc.steps, tc.weight_decay)
        self.preempt = PreemptionHandler()
        self.straggler = StragglerMonitor(tc.straggler_factor)
        # the rank that writes checkpoints and prints metrics: rank 0
        # under a mesh (the trees are gathered whole first)
        self.writer = mesh is None or torch.distributed.get_rank() == 0
        self.ckpt = ckpt_lib.AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep_ckpts)
        self.metrics_log: list = []

        params = init_params(cfg, seed=tc.seed, device=self.device)
        opt_state = self.optimizer.init(params)
        self.start_step = 0

        # resume from the latest checkpoint if present
        latest = ckpt_lib.latest_step(tc.ckpt_dir)
        if latest is not None:
            state = ckpt_lib.restore(tc.ckpt_dir, latest,
                                     {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            self.start_step = latest

        self._step = make_train_step(cfg, self.optimizer,
                                     grad_accum=tc.grad_accum,
                                     remat=tc.remat)
        if mesh is not None:
            self.rules = shd.make_rules(mesh, batch=dc.global_batch)
            pspec = shd.evenly(shd.param_pspecs(params, self.rules), params,
                               mesh)
            params = shd.distribute_tree(params, pspec, mesh)
            opt_state = shd.distribute_tree(
                opt_state, shd.opt_pspecs(opt_state, pspec, mesh), mesh)
        self.params, self.opt_state = params, opt_state

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.dataset.batch_at(step).items()}
        if self.mesh is None:
            return batch
        return {k: shd.place(v, shd.batch_pspec(self.rules, v.ndim - 1),
                             self.mesh) for k, v in batch.items()}

    def host_params(self):
        """The params, gathered whole under a mesh (plain tensors)."""
        return tree_map(full, self.params)

    def _host_state(self):
        """params and optimizer state as whole plain tensors: what a
        checkpoint holds."""
        opt = type(self.opt_state)(*[tree_map(full, x)
                                     for x in self.opt_state])
        return {"params": self.host_params(), "opt": opt}

    def run(self) -> Dict[str, Any]:
        with on_mesh(self.mesh):
            return self._run()

    def _run(self) -> Dict[str, Any]:
        tc = self.tc
        self.preempt.install()
        final_metrics: Dict[str, Any] = {}
        step = self.start_step
        stop = tc.steps if tc.stop_after is None else min(tc.steps,
                                                          tc.stop_after)
        while step < stop:
            self.straggler.step_start()
            batch = self._batch(step)
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            step += 1
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # time the work done
            dt = self.straggler.step_end(step)
            if step % tc.log_every == 0 or step == tc.steps:
                m = {k: float(full(v)) for k, v in metrics.items()}
                m.update(step=step, sec_per_step=round(dt, 4))
                self.metrics_log.append(m)
                if self.writer:  # rank 0 under a mesh
                    print(json.dumps(m), flush=True)
                final_metrics = m
            if step % tc.ckpt_every == 0 or step == stop:
                self._save(step)
            if self.preempt.preempted:
                self._save(step)
                self._wait()
                print(f"preempted at step {step}; checkpointed; exiting "
                      f"{PREEMPTION_EXIT_CODE}", flush=True)
                sys.exit(PREEMPTION_EXIT_CODE)
        self._wait()
        return final_metrics

    def _save(self, step: int):
        state = {"params": self.params, "opt": self.opt_state} \
            if self.mesh is None else self._host_state()
        if self.writer:
            self.ckpt.save(step, state,
                           metadata={"config": self.cfg.name, "step": step,
                                     "data_seed": self.dc.seed})

    def _wait(self):
        """The writes are done (on every rank: no rank reads a checkpoint
        before rank 0 has finished it)."""
        self.ckpt.wait()
        if self.mesh is not None:
            torch.distributed.barrier()


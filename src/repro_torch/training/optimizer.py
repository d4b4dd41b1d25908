"""Optimizers and LR schedules over the port's parameter trees: the
counterpart of ``repro.training.optimizer``.

AdamW with decoupled weight decay and global-norm clipping; Lion as the
low-memory alternative.  They are functions over nested dicts of tensors
(``init(params)``, ``update(grads, state, params)``), not ``torch.optim``
classes, because the reference's rules differ from ``torch.optim``'s: the
gradients are clipped by their norm across ALL leaves, weight decay falls
on every leaf with ``ndim >= 2`` (so the layer-stacked norms and biases,
(L, d), are decayed too) and the schedule is evaluated at ``step + 1``.
The state's ``step`` is a 0-d int32 tensor and the moments are float32,
as in the reference, whose checkpoints key on the field names of
``AdamWState`` and ``LionState``.

``update`` writes the new params and moments IN PLACE into the tensors it
is given and returns them (the reference's jitted step donates them: a
functional copy of a model and its two moments would add three model
sizes to a step's peak memory).  A caller that needs the old values keeps
a copy.  A ``None`` gradient (a leaf the loss does not reach: HuBERT's
token embedding, which frames bypass, or the unused ``norm2`` of a
parallel block) counts as zeros, as JAX's gradient of an unused leaf is:
its moments decay and, on a matrix, the weight decay still applies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # tree like params, float32
    nu: Any


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _clip_scale(grads, clip_norm: float):
    """min(1, clip_norm / max(global norm, 1e-9)) as a 0-d tensor (no host
    sync), or 1.0 without clipping."""
    if not clip_norm:
        return 1.0
    return torch.clamp(clip_norm / global_norm(grads).clamp_min(1e-9),
                       max=1.0)


def _leaves(grads, *trees):
    """The aligned leaves of ``grads`` and ``trees`` (one structure),
    ``None`` gradients as float32 zeros of their param's shape (the last
    tree is the params)."""
    params = tree_leaves(trees[-1])
    gs = [torch.zeros_like(p, dtype=torch.float32) if g is None else g
          for g, p in zip(tree_leaves(grads), params)]
    return zip(gs, *(tree_leaves(t) for t in trees))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]  # schedule: step -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(step=_step0(params), mu=_zeros_f32(params),
                          nu=_zeros_f32(params))

    def update(self, grads, state: AdamWState,
               params) -> Tuple[Any, AdamWState]:
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            step = state.step + 1
            scale = _clip_scale(grads, self.clip_norm)
            lr = self.lr(step)
            c1 = 1.0 - b1 ** step.float()
            c2 = 1.0 - b2 ** step.float()
            for g, m, v, p in _leaves(grads, state.mu, state.nu, params):
                g = g.float() * scale
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * g.square())
                delta = (m / c1) / ((v / c2).sqrt() + self.eps)
                if self.weight_decay and p.ndim >= 2:  # decay matrices only
                    delta = delta + self.weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


class LionState(NamedTuple):
    step: torch.Tensor
    mu: Any


@dataclasses.dataclass(frozen=True)
class Lion:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.99
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> LionState:
        return LionState(step=_step0(params), mu=_zeros_f32(params))

    def update(self, grads, state: LionState,
               params) -> Tuple[Any, LionState]:
        with torch.no_grad():
            step = state.step + 1
            scale = _clip_scale(grads, self.clip_norm)
            lr = self.lr(step)
            for g, m, p in _leaves(grads, state.mu, params):
                g = g.float() * scale
                d = torch.sign(self.b1 * m + (1 - self.b1) * g)
                if self.weight_decay and p.ndim >= 2:
                    d = d + self.weight_decay * p.float()
                m.copy_(self.b2 * m + (1 - self.b2) * g)
                p.copy_(p.float() - lr * d)
        return params, LionState(step=step, mu=state.mu)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32 (``None``
    leaves are zeros)."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)
          if x is not None]
    return sum(sq[1:], sq[0]).sqrt()


# ---------------------------------------------------------------------------
# schedules: step (a 0-d int tensor) -> lr (a 0-d float32 tensor)
# ---------------------------------------------------------------------------

def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def f(step):
        s = step.float()
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(s < warmup, warm, cos)
    return f


def linear_schedule(peak_lr: float, warmup: int, total: int) -> Callable:
    def f(step):
        s = step.float()
        warm = s / max(warmup, 1)
        decay = torch.clamp(1.0 - (s - warmup) / max(total - warmup, 1),
                            0.0, 1.0)
        return peak_lr * torch.where(s < warmup, warm, decay)
    return f


def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def make_optimizer(name: str, lr: float, warmup: int, total_steps: int,
                   weight_decay: float = 0.1, clip_norm: float = 1.0):
    sched = cosine_schedule(lr, warmup, total_steps)
    if name == "adamw":
        return AdamW(lr=sched, weight_decay=weight_decay, clip_norm=clip_norm)
    if name == "lion":
        return Lion(lr=sched, weight_decay=weight_decay, clip_norm=clip_norm)
    raise ValueError(name)

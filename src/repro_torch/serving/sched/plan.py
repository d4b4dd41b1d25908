"""Iteration planner for the continuous-batching scheduler.

A copy of ``repro.serving.sched.plan`` (the port imports nothing of the
JAX package).  Everything here is PURE host bookkeeping — no torch, no
device state — so the scheduling policy is unit-testable without
building an engine (``tests/test_torch_sched_plan.py``).

The model (Sarathi/vLLM-style): each engine iteration has a TOKEN BUDGET.
Every active decode slot reserves one token; the leftover admits prefill
CHUNKS — fixed-width slices of queued prompts — in strict FCFS order, at
most ONE chunk per request per iteration.  Strictness is the liveness
argument: the head job never yields to a younger one, so when budget
frees up (actives finish) the head runs first — no request starves.
A job that cannot be split (``monolithic``: dense binding-window configs,
whose ring cache can't hold a partial prompt) charges
``min(total, token_budget)`` — clamped so it can EVER fit; once every
decode drains, the head monolithic job always fits, preserving liveness
at the cost of one oversized iteration.

:func:`plan_iteration` maps (config, active decode count, prefill queue)
to a :class:`Schedule`; the engine executes it and advances each job's
``cursor``.  Invariants the property suite pins:

  * ``budget_used <= token_budget`` whenever ``n_decode <= token_budget``
  * cursors advance monotonically, by exactly one chunk per iteration
  * scheduled chunks are a PREFIX of the (FCFS) queue's unfinished jobs
  * with zero actives, the head job is always scheduled (no starvation)
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Budget knobs for the continuous-batching scheduler.

    token_budget   max tokens one engine iteration computes: each active
                   decode slot reserves 1, the rest admits prefill chunks
    chunk_tokens   static chunk width C — ONE compiled program serves
                   every chunk of every prompt (`ServeConfig.max_len`
                   must be a multiple; paged caches additionally need a
                   multiple of the block size, ring caches exactly one
                   block)
    """
    token_budget: int = 256
    chunk_tokens: int = 64

    def __post_init__(self):
        if self.chunk_tokens <= 0:
            raise ValueError(
                f"chunk_tokens must be positive, got {self.chunk_tokens}")
        if self.token_budget < self.chunk_tokens:
            raise ValueError(
                f"token_budget ({self.token_budget}) must cover at least "
                f"one chunk ({self.chunk_tokens}) or prefill never runs")


@dataclasses.dataclass(eq=False)  # identity eq: fields hold numpy arrays
class PrefillJob:
    """One queued prompt working its way into the cache chunk by chunk.

    ``toks`` is everything prefill must install (prompt, plus generated
    tokens minus the last on a resume); ``cursor`` is the chunk frontier
    (tokens already landed).  ``slot`` is -1 until admission grants one.
    """
    req: Any  # repro_torch.serving.engine.Request
    toks: np.ndarray
    slot: int = -1
    cursor: int = 0
    monolithic: bool = False
    resume: bool = False
    n_shared: int = 0
    t_slot: float = 0.0  # obs clock at slot grant (queued span ends)

    @property
    def total(self) -> int:
        return len(self.toks)

    @property
    def done(self) -> bool:
        return self.cursor >= self.total


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """One scheduled chunk: run ``job.toks[start:end]`` into ``job.slot``.
    ``cost`` is the budget charge (the full static chunk width — padded
    final chunks still compute C token positions; monolithic jobs charge
    their clamped whole length).  ``final`` marks the chunk that
    completes the prompt (its logits seed the first sampled token)."""
    job: PrefillJob
    start: int
    end: int
    cost: int
    final: bool


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One iteration's plan: ``n_decode`` reserved decode tokens plus an
    FCFS-prefix of prefill chunks, with the budget accounting that
    admitted them."""
    n_decode: int
    chunks: List[ChunkPlan]
    budget: int
    budget_used: int


def plan_iteration(scfg: SchedConfig, n_decode: int,
                   jobs: List[PrefillJob]) -> Schedule:
    """Plan one engine iteration.

    ``jobs`` is the admitted prefill queue in arrival (FCFS) order; each
    holds a slot.  Walks the queue strictly front-to-back, scheduling at
    most one chunk per job, and STOPS at the first job whose chunk does
    not fit the remaining budget (head-blocking — skipping ahead is what
    starves the head).
    """
    used = n_decode  # one token per active decode slot
    chunks: List[ChunkPlan] = []
    for job in jobs:
        if job.done:
            continue
        assert job.slot >= 0, "planner only sees admitted jobs"
        if job.monolithic:
            cost = min(job.total, scfg.token_budget)
            end = job.total
        else:
            cost = scfg.chunk_tokens
            end = min(job.cursor + scfg.chunk_tokens, job.total)
        if used + cost > scfg.token_budget:
            break
        used += cost
        chunks.append(ChunkPlan(job=job, start=job.cursor, end=end,
                                cost=cost, final=end >= job.total))
    return Schedule(n_decode=n_decode, chunks=chunks,
                    budget=scfg.token_budget, budget_used=used)

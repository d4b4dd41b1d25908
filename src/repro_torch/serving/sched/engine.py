"""ScheduledEngine: continuous batching with chunked prefill.

Counterpart of ``repro.serving.sched.engine``.  The base ``Engine.submit``
runs a whole-prompt prefill at admission: every arrival stalls the decode
streams in flight for a full prefill.  ``ScheduledEngine`` splits submit:

  * ``submit`` only ENQUEUES: validation, the rid (in arrival order) and
    a :class:`~repro_torch.serving.sched.plan.PrefillJob` on the waiting
    queue.  No device work;
  * ``step`` runs one planned ITERATION: admit waiting jobs into free
    slots (FCFS, resumes first), ask the planner for this iteration's
    decode/chunk mix under the token budget, run the chunks, run the base
    batched decode step, then activate the prefills that completed.

Chunks run against the SHARED batched cache while other slots keep
decoding; mid-prefill slots are protected per cache kind (dense: host
lengths park the decode write at the chunk frontier; paged: the slot's
table row ships as -1 so the decode write drops; ``serving.adapters``).
Activation comes AFTER the iteration's decode step: an unshielded slot
sharing its trailing partial page with a live request must take no decode
write before ``_make_appendable`` has copied that page on write (next
iteration, once active).

Adapters that cannot chunk (dense with a BINDING sliding window: the ring
cache holds no partial prompt) and stacks with SSM layers (their state has
no mid-prompt checkpoint) take monolithic whole-prompt jobs: admission is
still queued and budget-charged, the prefill is just unsplittable (and
runs the flash and SSD kernels of the base engine's prefill).

Token identity: a chunked prompt lands the same KV as a whole-prompt
prefill up to float rounding (exactly on the int8 pool's ints, where a
rounding boundary falls the same way), each request's sampling stream is
seeded from (seed, rid) with rids assigned in arrival order, and a
request's generator advances only with its own draws, so greedy and
sampled continuations match the synchronous engine's.

Under a device mesh (``mesh=``) the chunk programs run on the placed
cache as the base engine's steps do (``serving.engine``).

Observability as in the reference: each iteration emits
``obs.sched_iteration`` (its span closes after the decode step's host
read of the sampled tokens, a device sync) and each chunk
``obs.chunk_done``, whose span is DISPATCH time: a non-final chunk ends
in no host read, so its kernels may still run when the span closes (the
reference's span, under JAX's asynchronous dispatch, is the same).  A
request's queued span ends at its slot grant and its prefill span at the
end of its last chunk (``request_admitted``); its terminal event comes
exactly once.  ``n_iterations`` and ``n_chunks_run`` are always on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.distribution.placed import on_mesh
from repro_torch.models import layer_plan
from repro_torch.serving.adapters import KVCacheAdapter
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        ServeConfig, _result_of)
from repro_torch.serving.sched.plan import (ChunkPlan, PrefillJob,
                                            SchedConfig, Schedule,
                                            plan_iteration)


class ScheduledEngine(Engine):
    """Engine with queue admission and per-iteration chunk/decode plans."""

    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 scfg: Optional[SchedConfig] = None, impl: str = "cuda",
                 cache: Union[str, KVCacheAdapter] = "dense",
                 device="cuda", mesh=None):
        super().__init__(cfg, params, sc, impl=impl, cache=cache,
                         device=device, mesh=mesh)
        self.scfg = scfg if scfg is not None else SchedConfig()
        # chunk programs are attention-only (SSM state has no mid-prompt
        # checkpoint): other stacks and binding-window dense take
        # monolithic jobs
        self._chunked = (self.kv.supports_chunked
                         and layer_plan(cfg)["kind"] == "attn")
        if self._chunked:
            if sc.max_len % self.scfg.chunk_tokens:
                raise ValueError(
                    f"max_len ({sc.max_len}) must be a multiple of "
                    f"chunk_tokens ({self.scfg.chunk_tokens}): the final "
                    f"chunk's padded tail may not write past the cache")
            self.kv.enable_chunked()
            self.kv.build_chunk(self.scfg.chunk_tokens, impl,
                                qkv_sharding=self._qkv)
        self.waiting: List[PrefillJob] = []  # FCFS; resumes at the front
        self.prefilling: List[PrefillJob] = []  # admitted, chunks landing
        self.last_schedule: Optional[Schedule] = None
        self._progress = True
        self.n_iterations = 0  # always-on planner counters
        self.n_chunks_run = 0

    @property
    def stats(self) -> Dict[str, int]:
        s = Engine.stats.fget(self)  # type: ignore[attr-defined]
        s["sched_iterations"] = self.n_iterations
        s["sched_chunks"] = self.n_chunks_run
        return s

    # ------------------------------------------------------------------
    def submit(self, req: Request, vision=None) -> bool:
        """Enqueue ONLY: no prefill runs here.  Always returns True:
        admission control moved into ``step``, where a full pool defers
        the queue head instead of bouncing the caller.  Vision prefill is
        refused (ValueError), as in the reference: a VLM is served by the
        base ``Engine``, so a VLM request raises here either way."""
        if vision is not None:
            raise ValueError("ScheduledEngine is attention-only (no vision "
                             "prefill); use the base Engine for vlm serving")
        self._check_vision(None)
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        if (self.paged or not self.cfg.sliding_window) and \
                len(req.prompt) + req.max_new_tokens > self.sc.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len ({self.sc.max_len})")
        # rid at ENQUEUE, in arrival order: the same (seed, rid) stream the
        # synchronous engine would give the request
        if req.rid < 0:
            req.rid = self._rid
            self._rid += 1
        resume = bool(req.out_tokens)
        toks = np.asarray(req.prompt, np.int32)
        if resume and len(req.out_tokens) > 1:
            toks = np.concatenate(
                [toks, np.asarray(req.out_tokens[:-1], np.int32)])
        job = PrefillJob(req=req, toks=toks, resume=resume,
                         monolithic=not self._chunked)
        if resume:  # resumes have progress: highest priority
            self.waiting.insert(0, job)
        else:
            self.waiting.append(job)
        return True

    # ------------------------------------------------------------------
    def _admit(self) -> int:
        """Grant free slots to waiting jobs, strictly FCFS: a deferred head
        (pool exhausted) blocks everything behind it; skipping ahead is
        what starves the head."""
        n = 0
        while self.waiting and self.free_slots:
            job = self.waiting[0]
            slot = self.free_slots[0]
            if job.monolithic:
                n_shared = self.kv.admit(slot, job.toks)
            else:
                n_shared = self.kv.admit_chunked(slot, job.toks)
            if n_shared is None:
                self._c_deferred.inc()
                break
            self.free_slots.pop(0)
            self.waiting.pop(0)
            job.slot, job.n_shared = slot, n_shared
            job.cursor = 0
            job.t_slot = self.obs.clock()
            self.prefilling.append(job)
            n += 1
        return n

    def _self_preempt(self, job: PrefillJob) -> None:
        """A chunk's pages cannot map and no decoder is left to evict: give
        this prefill's resources back and retry from scratch once something
        else releases (``generate``'s stall check catches a single
        occupant that can never fit)."""
        self.kv.release(job.slot)
        self.free_slots.append(job.slot)
        job.slot = -1
        job.cursor = 0
        self.waiting.insert(0, job)
        self.prefilling = [j for j in self.prefilling if j is not job]
        self._c_deferred.inc()

    def _run_chunk(self, cp: ChunkPlan):
        """Run one planned chunk; returns the (1, V) logits of the chunk's
        last real position, or None if the job preempted itself."""
        job = cp.job
        if job.monolithic:
            padded, n = self._bucket_pad(job.toks)
            logits = self.kv.prefill(
                self._prefill_params, job.slot,
                self.host_to_device(padded, np.int32)[None], n, job.n_shared)
            self.kv.set_length(job.slot, n)
            job.cursor = job.total
            return logits
        while not self.kv.chunk_ready(job.slot, cp.start, cp.end):
            if self.active:
                self._preempt(max(self.active,
                                  key=lambda s: self.active[s].rid))
            else:
                self._self_preempt(job)
                return None
        row = np.zeros((self.scfg.chunk_tokens,), np.int32)
        row[:cp.end - cp.start] = job.toks[cp.start:cp.end]
        logits = self.kv.chunk_step(
            self.params, job.slot, self.host_to_device(row, np.int32)[None],
            cp.start, job.total)
        job.cursor = cp.end
        return logits

    def _finish_prefill(self, job: PrefillJob, logits):
        """All of ``job``'s tokens landed: sample (or, on a resume,
        restore) the first token and stage the request for activation, or
        finish it outright.  Returns (slot, request) to activate after the
        iteration's decode step, or None."""
        req, slot = job.req, job.slot
        if not job.monolithic:
            self.kv.finish_chunked(slot, job.toks)
        self._seed_stream(slot, req)
        req.slot = slot
        if job.resume:
            tok = req.out_tokens[-1]
        else:
            tok = int(self._sample(logits, [slot])[0])
            req.out_tokens = [tok]
            req.remaining = req.max_new_tokens - 1
            req.t_first = req.t_last = time.perf_counter()
        self._last_token[slot] = tok
        self.prefilling = [j for j in self.prefilling if j is not job]
        C = self.scfg.chunk_tokens
        bucket = job.total if job.monolithic else -(-job.total // C) * C
        self.obs.request_admitted(req, slot, n_shared=job.n_shared,
                                  resume=job.resume, bucket_len=bucket,
                                  t_prefill0=job.t_slot)
        if not job.resume and (req.remaining <= 0
                               or tok == self.sc.eos_token):
            # the first token already satisfied the budget (or is EOS)
            self.kv.release(slot)
            req.slot = -1
            self.free_slots.append(slot)
            self._finished(req)
            return None
        if job.monolithic:
            # no shield or host lengths in play (monolithic => the engine
            # is not in chunked mode): activate NOW, or this iteration's
            # decode step would advance the idle slot's device length past
            # the inserted prompt
            self.active[slot] = req
            return None
        return slot, req

    def step(self) -> Dict[int, int]:
        """One scheduler ITERATION: admit -> plan -> chunks -> decode ->
        activate.  Returns slot -> token for the decode part."""
        with on_mesh(self.mesh):
            return self._iteration()

    def _iteration(self) -> Dict[int, int]:
        while self.preempted:  # re-enter the queue at the front
            self.submit(self.preempted.pop(0))
        t0 = self.obs.clock()
        n_admitted = self._admit()
        schedule = plan_iteration(self.scfg, len(self.active),
                                  self.prefilling)
        self.last_schedule = schedule
        n_chunks = n_chunk_tokens = 0
        activated = []
        for cp in schedule.chunks:
            tc = self.obs.clock()
            logits = self._run_chunk(cp)
            if logits is None:
                continue
            n_chunks += 1
            n_chunk_tokens += cp.cost
            # dispatch time: a non-final chunk ends in no host read
            self.obs.chunk_done(cp.job.req, cp.job.slot, cp.start,
                                cp.end - cp.start, tc, self.obs.clock(),
                                final=cp.final)
            if cp.job.done:
                act = self._finish_prefill(cp.job, logits)
                if act is not None:
                    activated.append(act)
        emitted = super().step()
        # activate AFTER the decode step: it shipped the shielded view, so
        # a shared trailing partial page cannot take this slot's writes
        # before copy-on-write sees it
        for slot, req in activated:
            self.active[slot] = req
            self.kv.unshield(slot)
        self._g_peak.set_max(len(self.active))
        self.n_iterations += 1
        self.n_chunks_run += n_chunks
        self.obs.sched_iteration(t0, self.obs.clock(),
                                 n_decode=schedule.n_decode,
                                 n_chunks=n_chunks,
                                 n_chunk_tokens=n_chunk_tokens,
                                 budget_used=schedule.budget_used)
        self._progress = bool(emitted) or n_chunks > 0 or n_admitted > 0
        return emitted

    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32,
                 vision=None) -> List[RequestResult]:
        """Drain a batch of prompts through the scheduler; the contract
        (and, greedy, the tokens) of ``Engine.generate``.  ``vision`` is
        refused, as in the reference (ValueError)."""
        if vision is not None and any(v is not None for v in vision):
            raise ValueError("ScheduledEngine is attention-only (no vlm)")
        t_gen0 = self.obs.clock()
        t_arrival = time.perf_counter()
        pending = [Request(prompt=np.asarray(p, np.int32),
                           max_new_tokens=max_new_tokens,
                           t_arrival=t_arrival) for p in prompts]
        for r in pending:
            self.submit(r)
        while (self.waiting or self.prefilling or self.active
               or self.preempted):
            self.obs.queue_depth(len(self.waiting) + len(self.prefilling)
                                 + len(self.preempted))
            self.step()
            if not self._progress:
                raise RuntimeError(
                    "serving stalled: no admission, chunk or decode "
                    "progressed (raise n_blocks or token_budget, or shrink "
                    "the prompts)")
        results = [_result_of(r) for r in pending]
        self._generate_done(t_gen0, results)
        return results

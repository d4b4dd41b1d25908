"""The Observer: the ONE seam the serving engine emits telemetry through.

A copy of ``repro.obs.observer``.  ``Engine`` holds exactly one observer.
With ``ServeConfig.obs`` falsy (the default) it is the module singleton
``NULL`` — a ``NullObserver`` whose every hook is a shared empty function
and whose ``clock()`` returns 0.0 without a syscall, so the off-mode
serving path pays one attribute load + one no-op call per seam and
nothing else.  With obs on, the observer binds a :class:`MetricsRegistry`
and a :class:`TraceBuffer` and turns the engine's existing host
timestamps into histograms and spans.

Discipline (``tests/test_torch_obs.py`` scans this package for it):

  * HOST values only — hooks receive values the engine already had
    (``req.t_arrival``/``t_first``/…, host integers) or read
    ``time.perf_counter``.  They never call ``.item()``, ``.cpu()``,
    ``.tolist()``, ``.numpy()`` or ``torch.cuda.synchronize``, and never
    read a device tensor, so turning the observer on adds no host sync
    and no kernel launch to a serving step.
  * A span is host time.  Where the engine's step ends in a host read of
    device data (the sampled tokens' copy to the host), its span closes
    on a device sync; where it does not (a non-final prefill chunk), the
    span measures the dispatch, not the device's work.
  * Phases inside the engine's calls: ``span(name)`` records a complete
    event on the phase track (set-up, each submit, each step's wait for
    the sampled tokens: few a step, so the ring keeps the lifecycle), and
    ``range(name)`` records nothing (the step's phases and each block's
    mixer and FFN: tens a step).  Both enter a profiler range of the same
    name while a profiler records, and only then (a range costs several
    microseconds even with no profiler on): so every span and range lies
    on the device trace's own timeline.  The engine hands over the
    profiler's range factory and its "recording now" check
    (``attach_engine``): this package imports no torch.

Request lifecycle on the trace (one lane per request, one per slot):

  queued   t_arrival -> slot granted       (admission wait + deferrals)
  prefill  prompt forward + first sample   (span carries bucket/true len)
  decode   first token -> finish/preempt   (the steady-state span)
  preempted  preempt -> resume             (evicted, waiting to re-admit)
  finish   TERMINAL instant — exactly one per request, ever
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

from repro_torch.obs import trace as tr
from repro_torch.obs.metrics import MetricsRegistry


def _noop(*args, **kwargs) -> None:
    return None


#: the one do-nothing context that ``span`` and ``range`` return when
#: nothing is to be recorded
_NOOP_CTX = contextlib.nullcontext()


def _noop_ctx(*args, **kwargs):
    return _NOOP_CTX


def _not_recording() -> bool:
    return False


class NullObserver:
    """Every hook a no-op; ``clock()`` skips even the perf_counter call.
    This IS the off mode — not a stripped build, the shipped default."""

    enabled = False

    # one shared do-nothing function object for every hook keeps the
    # off-mode cost at attribute-load + empty-call, uniformly
    request_admitted = _noop
    request_preempted = _noop
    request_finished = _noop
    step_done = _noop
    queue_depth = _noop
    attach_engine = _noop
    generate_done = _noop
    sched_iteration = _noop
    chunk_done = _noop
    span = _noop_ctx
    range = _noop_ctx

    def clock(self) -> float:
        return 0.0


NULL = NullObserver()


class Observer:
    """Live metrics + tracing; see module docstring for the span model."""

    enabled = True

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 trace_capacity: int = 65536):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.trace = tr.TraceBuffer(trace_capacity)
        m = self.metrics
        self._c_submitted = m.counter(
            "serve_requests_admitted", "requests admitted into a slot")
        self._c_resumed = m.counter(
            "serve_requests_resumed", "preempted requests re-admitted")
        self._c_finished = m.counter(
            "serve_requests_finished", "requests that reached terminal")
        # serve_deferred / serve_preempted / serve_peak_active are the
        # ENGINE's always-on counters (Engine.stats reads through them);
        # they live in this same registry but the engine owns their
        # increments — the observer only adds spans/histograms on top
        m.counter("serve_deferred", "admissions deferred (pool exhausted)")
        m.counter("serve_preempted", "requests evicted mid-decode")
        self._c_steps = m.counter("serve_steps", "batched decode steps")
        self._c_tokens = m.counter("serve_tokens", "tokens emitted")
        self._g_active = m.gauge("serve_active", "slots decoding now")
        self._g_queue = m.gauge(
            "serve_queue_depth", "requests waiting (queued + preempted)")
        self._h_ttft = m.histogram(
            "serve_ttft_seconds", "arrival -> first token", lo=1e-5, hi=1e3)
        self._h_queued = m.histogram(
            "serve_queued_seconds", "arrival -> slot granted",
            lo=1e-6, hi=1e3)
        self._h_prefill = m.histogram(
            "serve_prefill_seconds", "prompt forward + first sample",
            lo=1e-5, hi=1e3)
        self._h_step = m.histogram(
            "serve_decode_step_seconds", "one batched decode step",
            lo=1e-5, hi=1e2)
        self._h_tok_s = m.histogram(
            "serve_decode_tok_s", "per-request steady decode rate "
            "(single-token requests excluded, not zero)", lo=1e-2, hi=1e6)
        # continuous-batching scheduler (repro_torch.serving.sched)
        self._c_sched_iters = m.counter(
            "sched_iterations", "scheduler iterations planned")
        self._c_sched_chunks = m.counter(
            "sched_chunks", "prefill chunks executed")
        self._c_sched_chunk_tokens = m.counter(
            "sched_chunk_tokens", "prompt tokens prefilled via chunks")
        self._g_sched_budget = m.gauge(
            "sched_budget_used", "tokens charged in the last iteration")
        self._h_chunk = m.histogram(
            "sched_chunk_seconds", "one chunk-prefill dispatch",
            lo=1e-5, hi=1e2)
        self._engine = None
        self._new_range: Callable[[str], Any] = _noop_ctx
        self._recording: Callable[[], bool] = _not_recording

    # -- plumbing -------------------------------------------------------
    def clock(self) -> float:
        return time.perf_counter()

    def attach_engine(self, engine, *, new_range: Callable[[str], Any],
                      recording: Callable[[], bool]) -> None:
        """Register the LAZY gauges lifted from the engine and its cache
        adapter (pool occupancy, recycle/CoW/prefix-hit counters…) —
        evaluated only at ``collect()``, never on the serving path — and
        take the profiler's range factory ``new_range(name)`` and its
        check ``recording()`` for ``span`` and ``range``."""
        self._engine = engine
        self._new_range, self._recording = new_range, recording
        m = self.metrics
        m.gauge_fn("serve_slots_free", lambda: len(engine.free_slots),
                   "slots idle")
        m.gauge_fn("serve_preempted_waiting",
                   lambda: len(engine.preempted),
                   "evicted requests awaiting resume")
        for name, (fn, help) in engine.kv.obs_gauges().items():
            m.gauge_fn(name, fn, help)

    # -- request lifecycle ----------------------------------------------
    def request_admitted(self, req, slot: int, *, n_shared: int,
                         resume: bool, bucket_len: int,
                         t_prefill0: float) -> None:
        """After a successful ``Engine.submit``: close the wait span
        (queued or preempted), record the prefill span, and for fresh
        requests the TTFT + the opening of the decode span."""
        now = self.clock()
        rtrack = tr.request_track(req.rid)
        if resume:
            self._c_resumed.inc()
            self.trace.end(rtrack, "preempted", t=t_prefill0, slot=slot)
        else:
            self._c_submitted.inc()
            self._h_queued.observe(t_prefill0 - req.t_arrival)
            self.trace.complete(rtrack, "queued", req.t_arrival, t_prefill0,
                                prompt_len=len(req.prompt))
        self.trace.complete(rtrack, "prefill", t_prefill0, now, slot=slot,
                            bucket_len=bucket_len, n_shared=n_shared)
        self.trace.complete(tr.slot_track(slot), "prefill", t_prefill0, now,
                            rid=req.rid, bucket_len=bucket_len)
        if not resume:
            ttft = req.t_first - req.t_arrival
            self._h_ttft.observe(ttft)
            self.trace.instant(rtrack, "first_token", t=req.t_first,
                               ttft_s=round(ttft, 6))
        self.trace.begin(rtrack, "decode", t=now, slot=slot)
        self._g_active.set(len(self._engine.active)
                           if self._engine is not None else 0)

    def request_preempted(self, req, slot: int) -> None:
        now = self.clock()
        rtrack = tr.request_track(req.rid)
        self.trace.end(rtrack, "decode", t=now, preempted=True)
        self.trace.instant(rtrack, "preempt", t=now, slot=slot)
        self.trace.begin(rtrack, "preempted", t=now)

    def request_finished(self, req, *, decode_tok_s: Optional[float],
                         ttft_s: float) -> None:
        """TERMINAL hook — exactly once per request.  ``decode_tok_s`` is
        None for single-token requests: excluded (``n_excluded``), never
        aggregated as a zero."""
        self._c_finished.inc()
        self._h_tok_s.observe(decode_tok_s)
        rtrack = tr.request_track(req.rid)
        t1 = req.t_last if req.t_last is not None else self.clock()
        self.trace.end(rtrack, "decode", t=t1)
        self.trace.instant(rtrack, "finish", t=t1,
                           new_tokens=len(req.out_tokens),
                           ttft_s=round(ttft_s, 6),
                           decode_tok_s=None if decode_tok_s is None
                           else round(decode_tok_s, 3))

    # -- engine loop ----------------------------------------------------
    def step_done(self, t0: float, t1: float, *, n_active: int,
                  n_tokens: int) -> None:
        self._c_steps.inc()
        self._c_tokens.inc(n_tokens)
        self._h_step.observe(t1 - t0)
        self._g_active.set(n_active)
        et = tr.engine_track()
        self.trace.complete(et, "step", t0, t1, n_active=n_active)
        eng = self._engine
        if eng is not None and eng.paged:
            self.trace.counter(et, "pool_blocks_used",
                               eng.pm.allocator.n_used, t=t1)

    def queue_depth(self, n: int) -> None:
        self._g_queue.set(n)

    # -- continuous-batching scheduler ----------------------------------
    def sched_iteration(self, t0: float, t1: float, *, n_decode: int,
                        n_chunks: int, n_chunk_tokens: int,
                        budget_used: int) -> None:
        """One ScheduledEngine iteration: the planned decode/prefill mix
        and its budget charge, as an engine-track span + counters."""
        self._c_sched_iters.inc()
        self._c_sched_chunks.inc(n_chunks)
        self._c_sched_chunk_tokens.inc(n_chunk_tokens)
        self._g_sched_budget.set(budget_used)
        et = tr.engine_track()
        self.trace.complete(et, "sched_iteration", t0, t1,
                            n_decode=n_decode, n_chunks=n_chunks,
                            budget_used=budget_used)
        self.trace.counter(et, "sched_budget_used", budget_used, t=t1)

    def chunk_done(self, req, slot: int, start: int, n_tokens: int,
                   t0: float, t1: float, *, final: bool) -> None:
        """One chunk-prefill dispatch for ``req``: a span on both the
        request's and the slot's track (the final chunk closes into the
        regular prefill/decode lifecycle via ``request_admitted``)."""
        self._h_chunk.observe(t1 - t0)
        self.trace.complete(tr.request_track(req.rid), "chunk", t0, t1,
                            slot=slot, start=start, n_tokens=n_tokens,
                            final=final)
        self.trace.complete(tr.slot_track(slot), "chunk", t0, t1,
                            rid=req.rid, start=start)

    def generate_done(self, t0: float, t1: float, *, n_requests: int,
                      n_tokens: int) -> None:
        self.trace.complete(tr.engine_track(), "generate", t0, t1,
                            n_requests=n_requests, n_tokens=n_tokens)

    # -- phases inside the engine's calls --------------------------------
    def range(self, name: str):
        """A profiler range ``name`` while a profiler records, else the
        shared no-op; nothing in the ring."""
        if self._recording():
            return self._new_range(name)
        return _NOOP_CTX

    @contextlib.contextmanager
    def span(self, name: str):
        """``range(name)``, and a complete event ``name`` on the phase
        track from entry to exit, on ``time.perf_counter``."""
        t0 = time.perf_counter()
        try:
            with self.range(name):
                yield
        finally:
            self.trace.complete(tr.phase_track(), name, t0,
                                time.perf_counter())


# ---------------------------------------------------------------------------
# active observer: a global that code deep in a serving step may consult
# (``get_active``) without holding the engine; like every hook it must
# read host values only.
# ---------------------------------------------------------------------------

_active: Any = NULL


def get_active():
    """The observer in effect right now (``NULL`` unless inside
    ``activated(...)``)."""
    return _active


@contextlib.contextmanager
def activated(observer):
    """Arm ``observer`` as the active observer for the duration."""
    global _active
    prev = _active
    _active = observer
    try:
        yield observer
    finally:
        _active = prev

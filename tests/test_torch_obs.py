"""The port's observability copy (``repro_torch.obs``) and its engine
seams, held against ``repro.obs`` and the JAX engines.

* The copied modules: the counterparts of ``tests/test_obs.py``'s tests
  (metrics, histogram edges, Prometheus text, the trace ring, the Perfetto
  export, the request-lifecycle invariants under random traces,
  ``NullObserver`` inert, the ``activated`` scope), and an AST scan: no
  module of ``repro_torch/obs/`` reads a device tensor on the host.
* The engines: on the same weights (the JAX package's init and qp merge,
  copied by the bridge), reduced skipless Mistral-7B served by the JAX
  ``Engine`` / ``ScheduledEngine`` and by the port's, obs on, on the dense
  cache and on paged pools tight enough to preempt (fp, and int8, whose
  resumes re-prefill): each request's sequence of span and instant names
  equals the JAX engine's, each request has exactly one terminal event,
  the histograms count the requests, the pool gauges equal the JAX
  engine's and the allocator's, and the streams equal the obs-off run's.

Tolerance: identity (names, counts, token lists)."""
import ast
import contextlib
import inspect
import math
import os
import types

import jax
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dev dep — property tests skip
    from _hypothesis_stub import given, settings, st

from repro import configs as jcfg
from repro import obs as JO
from repro.core import merge_skipless as jax_merge
from repro.models import init_params as jax_init_params
from repro.serving import Engine as JaxEngine
from repro.serving import PagedCacheAdapter as JaxPagedAdapter
from repro.serving import PagedQ8CacheAdapter as JaxQ8Adapter
from repro.serving import SchedConfig as JaxSchedConfig
from repro.serving import ScheduledEngine as JaxScheduledEngine
from repro.serving import ServeConfig as JaxServeConfig
from repro_torch import configs as tcfg
from repro_torch import obs as O
from repro_torch.convert import to_torch
from repro_torch.serving import (Engine, PagedCacheAdapter,
                                 PagedQ8CacheAdapter, SchedConfig,
                                 ScheduledEngine, ServeConfig)

MAX_EXAMPLES = int(os.environ.get("PROPERTY_EXAMPLES", "25"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_gauge_basics():
    m = O.MetricsRegistry()
    c = m.counter("c", "help text")
    c.inc()
    c.inc(3)
    assert c.value == 4
    assert m.counter("c") is c, "get-or-create returns the live object"
    g = m.gauge("g")
    g.set(5)
    g.set(2)
    assert g.value == 2 and g.high_water == 5
    g.set_max(1)
    assert g.value == 2, "set_max is a ratchet, never lowers"
    g.set_max(9)
    assert g.value == 9 and g.high_water == 9


def test_lazy_gauge_reads_at_collect_time():
    m = O.MetricsRegistry()
    box = {"v": 1}
    m.gauge_fn("lazy", lambda: box["v"])
    assert m["lazy"].collect()["value"] == 1
    box["v"] = 7
    assert m["lazy"].collect()["value"] == 7, "evaluated at collect, not set"


def test_histogram_percentiles_and_exclusion():
    m = O.MetricsRegistry()
    h = m.histogram("h", lo=1e-3, hi=1e3)
    values = [0.002, 0.01, 0.05, 0.05, 0.2, 1.0, 5.0, 40.0]
    for v in values:
        h.observe(v)
    h.observe(None)
    h.observe(float("nan"))
    col = h.collect()
    assert col["count"] == len(values) and col["n_excluded"] == 2
    assert col["min"] == 0.002 and col["max"] == 40.0
    assert abs(col["sum"] - sum(values)) < 1e-12
    p50, p90, p99 = h.percentile(0.5), h.percentile(0.9), h.percentile(0.99)
    assert 0.002 <= p50 <= p90 <= p99 <= 40.0
    # the copy estimates exactly as the reference does
    jh = JO.MetricsRegistry().histogram("h", lo=1e-3, hi=1e3)
    for v in values:
        jh.observe(v)
    assert [h.percentile(q) for q in (0.5, 0.9, 0.99)] == \
        [jh.percentile(q) for q in (0.5, 0.9, 0.99)]
    h2 = O.Histogram("empty")
    assert h2.percentile(0.5) is None and h2.mean is None
    assert h2.collect()["min"] is None


def test_histogram_bucket_edges_are_exclusive_lower_inclusive_upper():
    h = O.Histogram("h", lo=1.0, hi=100.0, per_decade=1)
    h.observe(10.0)
    h.observe(10.1)
    assert h.buckets[0] == 1 and h.buckets[1] == 1
    h.observe(0.5)  # under lo -> underflow, still counted
    assert h.underflow == 1 and h.count == 3


def test_prometheus_text_format():
    def fill(mod):
        m = mod.MetricsRegistry()
        m.counter("reqs", "requests").inc(3)
        m.gauge("depth").set(2)
        h = m.histogram("lat", lo=0.1, hi=10.0, per_decade=1)
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        return m.to_prometheus()

    text = fill(O)
    assert "# TYPE reqs counter" in text and "reqs_total 3" in text
    assert "depth 2" in text
    lines = [ln for ln in text.splitlines() if ln.startswith("lat_bucket")]
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in lines]
    assert counts == sorted(counts) and counts[-1] == 3
    assert 'le="+Inf"' in lines[-1]
    assert "lat_sum" in text and "lat_count 3" in text
    assert text == fill(JO), "the copy exports the reference's text"


# ---------------------------------------------------------------------------
# trace ring and export
# ---------------------------------------------------------------------------

def test_trace_ring_drops_oldest_without_corrupting_open_spans():
    tr = O.TraceBuffer(capacity=4)
    rt = O.request_track(0)
    tr.begin(rt, "decode", t=0.0)
    for i in range(10):
        tr.instant(O.engine_track(), f"i{i}", t=1.0 + i)
    assert len(tr) == 4 and tr.n_dropped == 6
    assert [e["name"] for e in tr.events()] == ["i6", "i7", "i8", "i9"]
    assert tr.open_spans() == [(rt, "decode")]
    doc = tr.to_perfetto()
    O.validate_perfetto(doc)
    assert doc["otherData"]["n_dropped"] == 6
    tr.end(rt, "decode", t=20.0)
    assert tr.open_spans() == []
    assert tr.events()[-1]["name"] == "decode"
    O.validate_perfetto(tr.to_perfetto())


def test_trace_end_without_begin_is_noop():
    tr = O.TraceBuffer()
    tr.end(O.request_track(1), "never-begun", t=1.0)
    assert len(tr) == 0 and tr.open_spans() == []


def test_trace_nested_spans_close_innermost_first():
    tr = O.TraceBuffer()
    et = O.engine_track()
    tr.begin(et, "outer", t=0.0)
    tr.begin(et, "inner", t=1.0)
    tr.end(et, "inner", t=2.0)
    tr.end(et, "outer", t=3.0)
    assert [(e["name"], e["t0"], e["dur"]) for e in tr.events()] == [
        ("inner", 1.0, 1.0), ("outer", 0.0, 3.0)]
    O.validate_perfetto(tr.to_perfetto())


def test_perfetto_export_structure_equals_the_reference():
    def fill(mod):
        tr = mod.TraceBuffer()
        tr.complete(mod.slot_track(2), "prefill", 0.0, 0.5, rid=7)
        tr.instant(mod.request_track(7), "finish", t=0.5)
        tr.counter(mod.engine_track(), "pool", 3, t=0.6)
        tr.begin(mod.request_track(8), "decode", t=0.7)  # stays open
        return tr.to_perfetto()

    doc = fill(O)
    counts = O.validate_perfetto(doc)
    assert counts["X"] == 1 and counts["i"] == 1 and counts["C"] == 1
    assert counts["B"] == 1
    pids = {ev["pid"] for ev in doc["traceEvents"] if ev["ph"] != "M"}
    assert len(pids) == 3
    ts = [ev["ts"] for ev in doc["traceEvents"] if ev["ph"] != "M"]
    assert min(ts) == 0.0 and max(ts) == pytest.approx(0.7e6)
    assert doc["traceEvents"] == fill(JO)["traceEvents"]


def test_null_observer_is_inert():
    assert O.NULL.clock() == 0.0 and not O.NULL.enabled
    O.NULL.request_admitted("x", 1, n_shared=0, resume=False,
                            bucket_len=8, t_prefill0=0.0)
    O.NULL.step_done(0, 0, n_active=0, n_tokens=0)
    O.NULL.sched_iteration(0, 0, n_decode=0, n_chunks=0, n_chunk_tokens=0,
                           budget_used=0)
    assert O.get_active() is O.NULL


def test_activated_scopes_the_active_observer():
    obs = O.Observer()
    assert O.get_active() is O.NULL
    with O.activated(obs) as got:
        assert got is obs and O.get_active() is obs
        with O.activated(O.NULL):
            assert O.get_active() is O.NULL
        assert O.get_active() is obs
    assert O.get_active() is O.NULL


#: the reference's compile telemetry, which the port (it compiles
#: nothing) does not carry
COMPILE_HOOKS = {"compile_event"}
COMPILE_METRICS = {"compile_seconds", "compile_events", "compile_hlo_bytes"}


def test_hooks_and_metrics_are_the_references():
    """The copy keeps the reference's hook set and metric names, less the
    compile telemetry, plus the phase hooks ``span`` and ``range``."""
    hooks = {n for n in vars(JO.NullObserver) if not n.startswith("_")}
    assert COMPILE_HOOKS <= hooks
    assert {n for n in vars(O.NullObserver) if not n.startswith("_")} == \
        (hooks - COMPILE_HOOKS) | {"span", "range"}
    ref = set(JO.Observer().metrics.collect())
    assert COMPILE_METRICS <= ref
    assert set(O.Observer().metrics.collect()) == ref - COMPILE_METRICS


def test_null_span_and_range_are_one_shared_noop():
    ctx = O.NULL.span("engine::wait")
    assert ctx is O.NULL.range("model::ffn") is O.NULL.span("x")
    with ctx as got, ctx:
        assert got is None
    assert O.NULL.enabled is False


class _Ranges:
    """A stand-in profiler: counts the ranges it is asked for."""

    def __init__(self, on: bool):
        self.on, self.names = on, []

    def new_range(self, name):
        self.names.append(name)
        return contextlib.nullcontext()

    def recording(self):
        return self.on


def _armed_observer(on: bool):
    obs, ranges = O.Observer(), _Ranges(on)
    engine = types.SimpleNamespace(
        free_slots=[], preempted=[], kv=types.SimpleNamespace(
            obs_gauges=dict))
    obs.attach_engine(engine, new_range=ranges.new_range,
                      recording=ranges.recording)
    return obs, ranges


@pytest.mark.parametrize("on", [False, True])
def test_span_writes_the_phase_track_and_range_writes_nothing(on):
    """``span`` leaves one complete event on the phase track whether or
    not a profiler records; ``range`` leaves none; a profiler range is
    asked for only while one records."""
    obs, ranges = _armed_observer(on)
    with obs.span("engine::wait"):
        with obs.range("model::attn"), obs.range("model::ffn"):
            pass
    evs = obs.trace.events()
    assert [(e["ph"], e["name"], e["track"]) for e in evs] == [
        ("X", "engine::wait", O.phase_track())]
    assert evs[0]["dur"] >= 0
    assert ranges.names == (["engine::wait", "model::attn", "model::ffn"]
                            if on else [])
    doc = obs.trace.to_perfetto()
    O.validate_perfetto(doc)
    assert {"ph": "M", "name": "process_name", "pid": 4, "tid": 0,
            "args": {"name": "phases"}} in doc["traceEvents"]


HOST_READS = ("item", "cpu", "tolist", "numpy", "synchronize")


def test_obs_package_never_reads_the_device():
    """An AST scan of ``repro_torch/obs/``: no call of ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()`` or ``synchronize``, and no
    import of torch: hooks see host values only."""
    pkg = os.path.dirname(O.__file__)
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert files == ["__init__.py", "export.py", "metrics.py",
                     "observer.py", "trace.py"]
    for f in files:
        tree = ast.parse(open(os.path.join(pkg, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    getattr(fn, "id", "")
                assert name not in HOST_READS, (f, node.lineno, name)
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module or ""]
                assert not any(m.split(".")[0] in ("torch", "numpy")
                               for m in mods), (f, mods)


@pytest.mark.parametrize("module", ["repro_torch.serving.engine",
                                    "repro_torch.serving.sched.engine"])
def test_engine_sources_use_the_monotonic_clock_only(module):
    import importlib
    src = inspect.getsource(importlib.import_module(module))
    assert "time.time(" not in src
    assert "time.perf_counter(" in src


# ---------------------------------------------------------------------------
# observer lifecycle invariants (hypothesis; test_obs.py's trace shape)
# ---------------------------------------------------------------------------

N_SLOTS = 4


def _trace_strategy():
    return st.lists(
        st.tuples(st.sampled_from(["admit", "step", "step", "step", "step",
                                   "release"]),
                  st.integers(min_value=0, max_value=7),
                  st.integers(min_value=1, max_value=40)),
        min_size=1, max_size=60)


class _FakeClockObserver(O.Observer):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._t = 0.0

    def clock(self):
        self._t += 0.25
        return self._t


class _Req:
    def __init__(self, rid, t_arrival):
        self.rid = rid
        self.prompt = np.zeros((4,), np.int32)
        self.out_tokens = []
        self.t_arrival = t_arrival
        self.t_first = None
        self.t_last = None


@settings(max_examples=MAX_EXAMPLES, deadline=None)
@given(trace=_trace_strategy())
def test_observer_request_lifecycle_invariants(trace):
    obs = _FakeClockObserver(trace_capacity=4096)
    free = list(range(N_SLOTS))
    active, preempted, finished, rids = {}, [], set(), []

    def finish(slot):
        req = active.pop(slot)
        free.append(slot)
        req.t_last = obs.clock()
        obs.request_finished(req, decode_tok_s=None, ttft_s=0.1)
        finished.add(req.rid)

    for op, sel, n in trace:
        if op == "admit" and free:
            resume = bool(preempted) and sel % 2 == 0
            if resume:
                req = preempted.pop(0)
            else:
                req = _Req(len(rids), obs.clock())
                rids.append(req.rid)
            slot = free.pop(0)
            t_p0 = obs.clock()
            if not resume:
                req.t_first = req.t_last = obs.clock()
                req.out_tokens = [1]
            active[slot] = req
            obs.request_admitted(req, slot, n_shared=0, resume=resume,
                                 bucket_len=8, t_prefill0=t_p0)
        elif op == "step" and active:
            t0 = obs.clock()
            for req in active.values():
                req.out_tokens.append(1)
                req.t_last = obs.clock()
            obs.step_done(t0, obs.clock(), n_active=len(active),
                          n_tokens=len(active))
        elif op == "release" and active:
            slot = sorted(active)[sel % len(active)]
            if n % 3 == 0:
                req = active.pop(slot)
                free.append(slot)
                obs.request_preempted(req, slot)
                preempted.append(req)
            else:
                finish(slot)
    for slot in sorted(active):
        finish(slot)
    while preempted:
        req = preempted.pop(0)
        slot = free.pop(0)
        obs.request_admitted(req, slot, n_shared=0, resume=True,
                             bucket_len=8, t_prefill0=obs.clock())
        active[slot] = req
        finish(slot)

    assert obs.trace.n_dropped == 0
    events = obs.trace.events()
    for rid in rids:
        on_track = [e for e in events if e["track"] == O.request_track(rid)]
        assert sum(e["name"] == "finish" for e in on_track) == 1, rid
        assert on_track[-1]["name"] == "finish", rid
    assert finished == set(rids)
    by_track = {}
    for e in events:
        if e["ph"] == "X":
            by_track.setdefault(e["track"], []).append(e)
    for track, spans in by_track.items():
        end = -math.inf
        for e in sorted(spans, key=lambda e: e["t0"]):
            assert e["t0"] >= end, (track, e)
            end = e["t0"] + e["dur"]
    assert obs.trace.open_spans() == []
    m = obs.metrics
    assert m["serve_requests_finished"].value == len(finished)
    assert m["serve_ttft_seconds"].count == len(rids)


# ---------------------------------------------------------------------------
# the engines, obs on, against the JAX engines
# ---------------------------------------------------------------------------

MAX_NEW = 20
PAGE, TIGHT_PAGES = 8, 7  # test_obs.py's pool-starved recipe
CHUNK = 8
# (engine, cache): the synchronous and the scheduled engine, on the dense
# cache, a tight fp pool and a tight int8 pool
CASES = [(e, c) for e in ("sync", "sched")
         for c in ("dense", "paged", "paged_q8")]
POOL_GAUGES = ("pool_blocks_used", "pool_blocks_free", "pool_peak_used",
               "pool_recycled", "pool_cow", "pool_prefix_hits",
               "prefix_tree_nodes", "prefix_retained_pages",
               "prefix_hit_tokens", "prefix_evicted", "q8_pool_bytes",
               "q8_bytes_saved_vs_fp16")


def _prompts(vocab):
    # three 8-token prompts and a repeat of the first (a shared prefix)
    p = [(np.arange(8) + 5 * i) % vocab for i in range(3)]
    return p + [p[0].copy()]


def _jax_engine(engine, cache, c, p, obs):
    sc = JaxServeConfig(n_slots=3, max_len=64, obs=obs)
    adapter = {"dense": lambda: "dense",
               "paged": lambda: JaxPagedAdapter(block_size=PAGE,
                                                n_blocks=TIGHT_PAGES),
               "paged_q8": lambda: JaxQ8Adapter(block_size=PAGE,
                                                n_blocks=TIGHT_PAGES)}[cache]()
    if engine == "sched":
        return JaxScheduledEngine(
            c, p, sc, scfg=JaxSchedConfig(token_budget=4 * CHUNK,
                                          chunk_tokens=CHUNK),
            impl="xla", cache=adapter)
    return JaxEngine(c, p, sc, impl="xla", cache=adapter)


def _port_engine(engine, cache, c, p, obs):
    sc = ServeConfig(n_slots=3, max_len=64, obs=obs)
    adapter = {"dense": lambda: "dense",
               "paged": lambda: PagedCacheAdapter(block_size=PAGE,
                                                  n_blocks=TIGHT_PAGES),
               "paged_q8": lambda: PagedQ8CacheAdapter(
                   block_size=PAGE, n_blocks=TIGHT_PAGES)}[cache]()
    if engine == "sched":
        return ScheduledEngine(c, p, sc, SchedConfig(token_budget=4 * CHUNK,
                                                     chunk_tokens=CHUNK),
                               impl="torch", cache=adapter, device="cpu")
    return Engine(c, p, sc, impl="torch", cache=adapter, device="cpu")


def _names(tracer, rid):
    return [(e["ph"], e["name"]) for e in O.request_events(tracer, rid)]


def _gauges(metrics):
    col = metrics.collect()
    return {k: col[k]["value"] for k in POOL_GAUGES if k in col}


@pytest.fixture(scope="module")
def runs():
    """The merged model on both sides, and per case the JAX engine's
    streams, per-request event names, engine-track event counts, pool
    gauges and stats, obs on."""
    jc = jcfg.reduce_config(jcfg.get_config("mistral-7b")).with_(
        block_style="skipless", dtype="float32", param_dtype="float32",
        sliding_window=0)
    params = jax_init_params(jax.random.PRNGKey(0), jc)
    params["embed"]["table"] = params["embed"]["table"] * 50.0
    mp, mc = jax_merge(params, jc, "qp")
    tc = tcfg.reduce_config(tcfg.get_config("mistral-7b")).with_(
        block_style=mc.block_style, merged_variant=mc.merged_variant,
        dtype="float32", param_dtype="float32", sliding_window=0)
    tp = to_torch(jax.tree.map(np.asarray, mp), device="cpu")
    prompts = _prompts(jc.vocab_size)
    out = {}
    for engine, cache in CASES:
        eng = _jax_engine(engine, cache, mc, mp, True)
        outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
        tr = eng.obs.trace
        assert tr.n_dropped == 0
        out[(engine, cache)] = dict(
            streams=[list(o) for o in outs],
            names=[_names(tr, rid) for rid in range(len(prompts))],
            engine_events=sorted((e["ph"], e["name"]) for e in tr.events()
                                 if e["track"] == O.engine_track()
                                 and e["ph"] == "X"),
            gauges=_gauges(eng.metrics),
            stats={k: eng.stats[k] for k in ("peak_active", "n_preempted",
                                             "n_deferred")})
    return tc, tp, prompts, out


@pytest.mark.parametrize("engine,cache", CASES)
def test_engine_events_equal_the_jax_engines(runs, engine, cache):
    tc, tp, prompts, want = runs
    want = want[(engine, cache)]
    eng = _port_engine(engine, cache, tc, tp, True)
    assert isinstance(eng.obs, O.Observer) and eng.metrics is eng.obs.metrics
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == want["streams"]
    tr = eng.obs.trace
    assert tr.n_dropped == 0 and tr.open_spans() == []
    if cache != "dense":
        assert eng.stats["n_preempted"] > 0, "the pool must preempt"
    # the same lifecycle, request by request, as the reference's
    names = [_names(tr, rid) for rid in range(len(prompts))]
    assert names == want["names"]
    for rid, seq in enumerate(names):
        assert [n for _, n in seq].count("finish") == 1, rid
        assert seq[-1] == ("i", "finish"), rid
        assert [n for _, n in seq].count("first_token") == 1, rid
    assert sorted((e["ph"], e["name"]) for e in tr.events()
                  if e["track"] == O.engine_track() and e["ph"] == "X") == \
        want["engine_events"]
    assert {k: eng.stats[k] for k in want["stats"]} == want["stats"]
    m = eng.metrics
    n = len(prompts)
    assert m["serve_requests_admitted"].value == n
    assert m["serve_requests_finished"].value == n
    assert m["serve_ttft_seconds"].count == n
    assert m["serve_queued_seconds"].count == n
    assert m["serve_decode_tok_s"].count + \
        m["serve_decode_tok_s"].n_excluded == n
    assert m["serve_requests_resumed"].value == eng.stats["n_preempted"]
    assert m["serve_decode_step_seconds"].count == eng.stats["n_steps"]
    assert sum(e["name"] == "preempt" for e in tr.events()) == \
        eng.stats["n_preempted"]
    if engine == "sched":
        assert m["sched_iterations"].value == eng.n_iterations
        assert m["sched_chunks"].value == eng.n_chunks_run
    O.validate_perfetto(tr.to_perfetto())
    # the pool gauges are the reference's and the allocator's
    g = _gauges(m)
    assert g == want["gauges"]
    if cache != "dense":
        a = eng.pm.allocator
        assert (g["pool_blocks_used"], g["pool_peak_used"],
                g["pool_prefix_hits"], g["pool_cow"]) == \
            (a.n_used, a.peak_used, a.n_shared_hits, a.n_cow)
        assert g["prefix_hit_tokens"] == eng.pm.tree.hit_tokens
        assert ("q8_pool_bytes" in g) == (cache == "paged_q8")
        if cache == "paged_q8":
            assert g["q8_pool_bytes"] == eng.pm.pool_bytes
            assert g["q8_bytes_saved_vs_fp16"] > 0
        doc = O.serving_obs_doc(eng)
        assert doc["headline"]["preempted"] == eng.stats["n_preempted"]
        assert doc["pool"]["peak_used"] == a.peak_used
    else:
        assert g == {}


@pytest.mark.parametrize("engine,cache", CASES)
def test_obs_on_changes_no_token(runs, engine, cache):
    """The same engine with the observer off (the shared NULL: stats still
    read through the registry) emits the obs-on streams, with the same
    counters; an adopted Observer becomes the engine's registry."""
    tc, tp, prompts, want = runs
    eng = _port_engine(engine, cache, tc, tp, False)
    assert eng.obs is O.NULL and not eng.obs.enabled
    outs = eng.generate(prompts, max_new_tokens=MAX_NEW)
    assert [list(o) for o in outs] == want[(engine, cache)]["streams"]
    assert {k: eng.stats[k] for k in want[(engine, cache)]["stats"]} == \
        want[(engine, cache)]["stats"]
    assert eng.metrics["serve_peak_active"].high_water == \
        eng.stats["peak_active"]
    assert O.snapshot(eng)["engine"]["obs_enabled"] is False
    mine = O.Observer()
    eng = _port_engine(engine, cache, tc, tp, mine)
    assert eng.obs is mine and eng.metrics is mine.metrics


def test_single_token_request_tok_s_is_excluded_not_zero(runs):
    tc, tp, prompts, _ = runs
    eng = _port_engine("sync", "dense", tc, tp, True)
    outs = eng.generate(prompts[:1], max_new_tokens=1)
    assert outs[0].decode_tok_s is None
    h = eng.metrics["serve_decode_tok_s"]
    assert h.count == 0 and h.n_excluded == 1 and h.mean is None
    assert eng.metrics["serve_requests_finished"].value == 1


# ---------------------------------------------------------------------------
# the engine's phases on a profiler's timeline, and its step-sync counter
# ---------------------------------------------------------------------------

STEP_PHASES = {"engine::appendable", "engine::upload", "engine::forward",
               "engine::sample", "engine::wait", "engine::emit"}
SUBMIT_PHASES = {"engine::submit", "engine::admit", "engine::prefill",
                 "engine::wait"}
MODEL_RANGES = {"model::attn", "model::ffn"}


@pytest.fixture(scope="module")
def small_model():
    from repro_torch.lint.submitpath import audit_model
    return audit_model("cpu")


def _small_engine(small_model, cache, obs):
    cfg, params = small_model
    return Engine(cfg, params, ServeConfig(n_slots=2, max_len=48,
                                           block_size=8, obs=obs),
                  impl="torch", cache=cache, device="cpu")


def _request(cfg, n=12, new=4):
    from repro_torch.serving import Request
    return Request(prompt=(np.arange(n, dtype=np.int32) * 7)
                   % cfg.vocab_size, max_new_tokens=new)


def test_engine_phases_nest_under_step_and_submit_in_a_profile(
        small_model):
    """Under ``torch.profiler`` (CPU), one submit and one step of a paged
    engine with obs on: every phase and model range appears, on the
    caller's thread, inside the caller's range around that call; the
    phase track holds the spans only (set-up, submit, waits)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = _small_engine(small_model, "paged", True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test::submit"):
            assert eng.submit(_request(eng.cfg))
        with record_function("test::step"):
            eng.step()
    events = list(prof.events())
    outer = {e.name: e for e in events if e.name.startswith("test::")}
    for call, want in (("test::submit", SUBMIT_PHASES | MODEL_RANGES),
                       ("test::step", STEP_PHASES | MODEL_RANGES)):
        o = outer[call]
        inside = {e.name for e in events
                  if e.thread == o.thread
                  and o.time_range.start <= e.time_range.start
                  and e.time_range.end <= o.time_range.end
                  and e.name.startswith(("engine::", "model::"))}
        assert inside == want, (call, inside ^ want)
    names = [(e["name"], e["track"]) for e in eng.obs.trace.events()
             if e["track"] == O.phase_track()]
    assert names == [("engine::init", O.phase_track()),
                     ("engine::wait", O.phase_track()),
                     ("engine::submit", O.phase_track()),
                     ("engine::wait", O.phase_track())]
    # off, the model code sees no armed observer
    assert O.get_active() is O.NULL


@pytest.mark.parametrize("cache,syncs", [("paged", 4), ("paged_q8", 4),
                                         ("dense", 2)])
def test_step_counts_its_blocking_transfers(small_model, cache, syncs):
    """A decode step uploads the tokens (and on a paged pool the tables and
    the lengths) and reads the sampled tokens back: that many counted,
    obs on or off; a submit counts none."""
    for obs in (False, True):
        eng = _small_engine(small_model, cache, obs)
        assert eng.submit(_request(eng.cfg))
        assert eng.stats["n_step_syncs"] == 0
        before = dict(eng.stats)
        eng.step()
        assert eng.stats["n_steps"] - before["n_steps"] == 1
        assert eng.stats["n_step_syncs"] - before["n_step_syncs"] == syncs

"""Export + validation helpers: metrics JSON, Perfetto traces, and the
flat serving document of one instrumented run (``serving_obs_doc``).

Everything here is read-side: it runs AFTER (or between) serving steps,
so it may evaluate lazy gauges, walk the trace ring, and touch the
allocator freely — none of it is on the per-token path.

``validate_perfetto`` is the structural gate the tests and
``chip_smoke.py`` share: it proves the export is a well-formed
``trace_event`` JSON object document (the format https://ui.perfetto.dev
loads) without needing Perfetto itself.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def snapshot(engine) -> Dict[str, Any]:
    """Point-in-time metrics snapshot of an engine (obs on or off — the
    always-on ``Engine.metrics`` registry is the source)."""
    doc: Dict[str, Any] = {
        "metrics": engine.metrics.collect(),
        "engine": {"cache_kind": engine.kv.kind,
                   "impl": engine.impl,
                   "n_slots": engine.sc.n_slots,
                   "max_len": engine.sc.max_len,
                   "merged_fast_path": engine.merged_fast_path,
                   "obs_enabled": engine.obs.enabled},
    }
    if engine.paged:
        a = engine.pm.allocator
        doc["pool"] = {"n_blocks": a.n_blocks, "block_size": engine.pm.bs,
                      "peak_used": a.peak_used, "n_used": a.n_used,
                      "n_cow": a.n_cow, "n_shared_hits": a.n_shared_hits,
                      "n_recycled": a.n_recycled,
                      "ring_bound": engine.pm.ring_bound,
                      # running max (O(1) host state), same exported shape
                      # as the old per-release list's max(...)
                      "request_page_hwm": engine.pm.request_page_hwm.max,
                      "prefix_tree_nodes": engine.pm.tree.n_nodes,
                      "prefix_retained_pages": len(engine.pm.tree.retained),
                      "prefix_hit_tokens": engine.pm.tree.hit_tokens,
                      "prefix_evicted": engine.pm.tree.n_evicted}
    return doc


def serving_obs_doc(engine, extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The headline latency quantiles + pool/scheduler counters of one
    instrumented serve, flat enough to diff across runs, plus the full
    metrics snapshot."""
    assert engine.obs.enabled, "serving_obs_doc needs an instrumented run"
    m = engine.metrics
    ttft = m["serve_ttft_seconds"]
    step = m["serve_decode_step_seconds"]
    tok = m["serve_decode_tok_s"]
    doc: Dict[str, Any] = {
        "schema": "repro_torch.obs/serving/v1",
        "headline": {
            "ttft_p50_ms": _ms(ttft.percentile(0.50)),
            "ttft_p99_ms": _ms(ttft.percentile(0.99)),
            "decode_step_p50_ms": _ms(step.percentile(0.50)),
            "decode_step_p99_ms": _ms(step.percentile(0.99)),
            "decode_tok_s_p50": tok.percentile(0.50),
            "requests_finished": m["serve_requests_finished"].value,
            "tokens": m["serve_tokens"].value,
            "deferred": m["serve_deferred"].value,
            "preempted": m["serve_preempted"].value,
            "peak_active": m["serve_peak_active"].collect()["high_water"],
        },
        "decode_step_histogram": step.collect(),
        "ttft_histogram": ttft.collect(),
    }
    snap = snapshot(engine)
    doc["metrics"] = snap["metrics"]
    doc["engine"] = snap["engine"]
    if "pool" in snap:
        doc["pool"] = snap["pool"]
        doc["headline"].update(
            pool_peak_used=snap["pool"]["peak_used"],
            pool_recycled=snap["pool"]["n_recycled"],
            pool_cow=snap["pool"]["n_cow"],
            pool_prefix_hits=snap["pool"]["n_shared_hits"])
    if extra:
        doc.update(extra)
    return doc


def write_json(path: str, doc: Dict[str, Any]) -> None:
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def write_perfetto(path: str, tracer) -> None:
    write_json(path, tracer.to_perfetto())


# ---------------------------------------------------------------------------
# structural validation (tests + chip_smoke.py)
# ---------------------------------------------------------------------------

_REQUIRED = {"X": ("name", "ph", "pid", "tid", "ts", "dur"),
             "B": ("name", "ph", "pid", "tid", "ts"),
             "E": ("name", "ph", "pid", "tid", "ts"),
             "i": ("name", "ph", "pid", "tid", "ts"),
             "C": ("name", "ph", "pid", "tid", "ts", "args"),
             "M": ("name", "ph", "pid", "args")}


def validate_perfetto(doc: Dict[str, Any]) -> Dict[str, int]:
    """Assert ``doc`` is a loadable trace_event JSON object document;
    returns event counts by phase.  Checks: JSON round-trip, the
    ``traceEvents`` list, per-phase required keys, non-negative ts/dur,
    thread metadata for every (pid, tid) that records events, and B/E
    balance per track (unfinished B's are allowed — open spans — but an
    E without a B is corruption)."""
    json.loads(json.dumps(doc))  # JSON-serializable end to end
    evs = doc.get("traceEvents")
    assert isinstance(evs, list) and evs, "traceEvents must be a list"
    counts: Dict[str, int] = {}
    named_threads = set()
    used_threads = set()
    open_depth: Dict[Any, int] = {}
    for ev in evs:
        ph = ev.get("ph")
        assert ph in _REQUIRED, f"unknown phase {ph!r}: {ev}"
        for key in _REQUIRED[ph]:
            assert key in ev, f"{ph!r} event missing {key!r}: {ev}"
        counts[ph] = counts.get(ph, 0) + 1
        if ph == "M":
            if ev["name"] == "thread_name":
                named_threads.add((ev["pid"], ev["tid"]))
            continue
        used_threads.add((ev["pid"], ev["tid"]))
        assert ev["ts"] >= 0, f"negative ts: {ev}"
        if ph == "X":
            assert ev["dur"] >= 0, f"negative dur: {ev}"
        if ph in ("B", "E"):
            k = (ev["pid"], ev["tid"])
            open_depth[k] = open_depth.get(k, 0) + (1 if ph == "B" else -1)
            assert open_depth[k] >= 0, f"E without B on track {k}"
    missing = used_threads - named_threads
    assert not missing, f"events on unnamed threads: {sorted(missing)}"
    return counts


def request_events(tracer, rid: int) -> List[Dict[str, Any]]:
    """A request-track's ring events, oldest first (internal schema) —
    the invariant tests' view of one request's life."""
    from repro_torch.obs import trace as tr
    track = tr.request_track(rid)
    return [ev for ev in tracer.events() if ev["track"] == track]


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 4)

"""Request-lifecycle tracing: a bounded ring of span events with
Chrome/Perfetto ``trace_event`` JSON export.

Recording model (host-timestamp-only — hooks never touch the device):

  * A ``Track`` is one Perfetto "thread": the engine loop, each serving
    SLOT, and each REQUEST get their own, so a request's
    queued→prefill→decode→preempted→decode→finish life reads as one
    horizontal lane even as it migrates between slots.  The PHASE track
    holds the observer's ``span``s inside the engine's calls (its set-up,
    each submit, each step's wait for the device), apart from the
    engine track's lifecycle events.
  * Completed spans are stored as single COMPLETE events (begin + dur in
    one record), appended to a bounded ring buffer (``collections.deque``
    maxlen) that drops OLDEST-first under pressure.  Spans still open
    (``begin`` without ``end``) live in a per-track side table OUTSIDE
    the ring, so buffer churn can never corrupt an open span — they are
    emitted as unfinished ``B`` events at export.
  * ``instant`` marks (preempt, deferred) and ``counter`` samples (pool
    occupancy per engine step) are ring events too.

Export is ``to_perfetto()``: the ``{"traceEvents": [...]}`` JSON object
format, loadable directly in https://ui.perfetto.dev (or
``chrome://tracing``), with ``M`` metadata records naming every
process/thread.  Timestamps are microseconds from the tracer's epoch,
taken from ``time.perf_counter`` (monotonic; wall-clock NTP steps can
never fold a span backwards).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

#: (process id, process name) per track family — Perfetto groups tids
#: under pids, so the engine / slots / requests render as three groups.
_FAMILIES = {"engine": (1, "engine"), "slot": (2, "slots"),
             "request": (3, "requests"), "phase": (4, "phases")}

Track = Tuple[str, int]  # ("engine"|"slot"|"request"|"phase", index)


def engine_track() -> Track:
    return ("engine", 0)


def slot_track(slot: int) -> Track:
    return ("slot", int(slot))


def request_track(rid: int) -> Track:
    return ("request", int(rid))


def phase_track() -> Track:
    return ("phase", 0)


class TraceBuffer:
    """Bounded ring of trace events + side table of open spans."""

    def __init__(self, capacity: int = 65536):
        assert capacity > 0
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._open: Dict[Track, List[Tuple[str, float, Dict[str, Any]]]] = {}
        self._tracks: Dict[Track, None] = {}  # insertion-ordered set
        self.n_dropped = 0
        self.epoch = time.perf_counter()

    # -- clock ----------------------------------------------------------
    def now(self) -> float:
        """Monotonic seconds (the tracer's native time base)."""
        return time.perf_counter()

    # -- recording ------------------------------------------------------
    def _push(self, ev: Dict[str, Any]) -> None:
        if len(self._events) == self.capacity:
            self.n_dropped += 1  # deque(maxlen) evicts oldest-first
        self._events.append(ev)

    def _touch(self, track: Track) -> None:
        self._tracks[track] = None

    def begin(self, track: Track, name: str, t: Optional[float] = None,
              **args) -> None:
        """Open span ``name`` on ``track`` (closed by ``end``).  Open
        spans are held OUTSIDE the ring: events dropped under pressure
        never unbalance them."""
        self._touch(track)
        self._open.setdefault(track, []).append(
            (name, self.now() if t is None else t, args))

    def end(self, track: Track, name: str, t: Optional[float] = None,
            **args) -> None:
        """Close the innermost open span ``name`` on ``track`` and emit
        the complete event.  Unknown (already-dropped or never-begun)
        names are a no-op — the hooks stay crash-free mid-serve."""
        t1 = self.now() if t is None else t
        stack = self._open.get(track, [])
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0, a0 = stack.pop(i)
                if args:
                    a0 = {**a0, **args}
                self.complete(track, name, t0, t1, **a0)
                return

    def complete(self, track: Track, name: str, t0: float, t1: float,
                 **args) -> None:
        """One whole span (begin time + end time known at record time)."""
        self._touch(track)
        self._push({"ph": "X", "name": name, "track": track, "t0": t0,
                    "dur": max(0.0, t1 - t0), "args": args})

    def instant(self, track: Track, name: str, t: Optional[float] = None,
                **args) -> None:
        self._touch(track)
        self._push({"ph": "i", "name": name, "track": track,
                    "t0": self.now() if t is None else t, "args": args})

    def counter(self, track: Track, name: str, value,
                t: Optional[float] = None) -> None:
        """One sample of a numeric counter track (pool occupancy…)."""
        self._touch(track)
        self._push({"ph": "C", "name": name, "track": track,
                    "t0": self.now() if t is None else t,
                    "args": {"value": value}})

    # -- introspection (tests / invariant checks) -----------------------
    def events(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (internal schema)."""
        return list(self._events)

    def open_spans(self, track: Optional[Track] = None
                   ) -> List[Tuple[Track, str]]:
        out = [(tr, name) for tr, stack in self._open.items()
               for name, _, _ in stack]
        return [x for x in out if x[0] == track] if track is not None else out

    def __len__(self) -> int:
        return len(self._events)

    # -- export ---------------------------------------------------------
    def _ids(self, track: Track) -> Tuple[int, int]:
        pid, _ = _FAMILIES[track[0]]
        return pid, int(track[1])

    def to_perfetto(self) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON object format."""
        # export base: the construction epoch, unless a caller recorded
        # explicit earlier timestamps (tests do) — ts must be >= 0
        t_all = [ev["t0"] for ev in self._events] + \
            [t0 for stack in self._open.values() for _, t0, _ in stack]
        base = min([self.epoch] + t_all)
        us = lambda t: round((t - base) * 1e6, 3)  # noqa: E731
        out: List[Dict[str, Any]] = []
        seen_pids = set()
        for track in self._tracks:
            pid, tid = self._ids(track)
            if pid not in seen_pids:
                seen_pids.add(pid)
                out.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0,
                            "args": {"name": _FAMILIES[track[0]][1]}})
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid,
                        "args": {"name": f"{track[0]} {track[1]}"}})
        for ev in self._events:
            pid, tid = self._ids(ev["track"])
            rec = {"name": ev["name"], "ph": ev["ph"], "cat": "serving",
                   "pid": pid, "tid": tid, "ts": us(ev["t0"])}
            if ev["ph"] == "X":
                rec["dur"] = round(ev["dur"] * 1e6, 3)
            if ev["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            if ev["args"]:
                rec["args"] = dict(ev["args"])
            out.append(rec)
        # open spans: emitted as unfinished B events (Perfetto renders
        # them to the end of the trace) — they were never in the ring
        for track, stack in self._open.items():
            pid, tid = self._ids(track)
            for name, t0, args in stack:
                rec = {"name": name, "ph": "B", "cat": "serving",
                       "pid": pid, "tid": tid, "ts": us(t0)}
                if args:
                    rec["args"] = dict(args)
                out.append(rec)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"n_dropped": self.n_dropped,
                              "capacity": self.capacity}}

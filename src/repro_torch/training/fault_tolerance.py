"""Fault-tolerance machinery: preemption, stragglers, restart policy
(stdlib only; a copy of ``repro.training.fault_tolerance``).

On a 1000+ node fleet the scheduler sends SIGTERM with a grace window
before reclaiming a slice; ``PreemptionHandler`` converts that into a
cooperative "checkpoint now and exit 143" at the next step boundary.
``StragglerMonitor`` tracks per-step wall time and raises an alarm hook
when a step exceeds ``factor`` × the trailing median — on a real fleet the
hook feeds the job controller (which can evict the slow host / reshard);
here it logs and counts (and is unit-tested).

Restart policy is pure: the Trainer is a function of (checkpoint, step),
and the data pipeline is a function of (seed, step), so a restart — on the
same or a DIFFERENT pod count — reproduces the exact token stream.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable, List, Optional


PREEMPTION_EXIT_CODE = 143


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._installed = False
        self._signals = signals

    def install(self):
        if self._installed:
            return
        for s in self._signals:
            try:
                signal.signal(s, self._on_signal)
            except ValueError:  # non-main thread (tests)
                pass
        self._installed = True

    def _on_signal(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self):  # for tests / manual drills
        self._requested = True


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, window: int = 50,
                 alarm: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.window = window
        self.alarm = alarm or (lambda step, dt, med: None)
        self.durations: List[float] = []
        self.alarms: List[int] = []
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        if len(self.durations) >= 5:
            med = statistics.median(self.durations[-self.window:])
            if dt > self.factor * med:
                self.alarms.append(step)
                self.alarm(step, dt, med)
        self.durations.append(dt)
        return dt

    def observe(self, step: int, dt: float) -> bool:
        """Test-friendly: feed a duration directly; returns alarmed?"""
        alarmed = False
        if len(self.durations) >= 5:
            med = statistics.median(self.durations[-self.window:])
            if dt > self.factor * med:
                self.alarms.append(step)
                self.alarm(step, dt, med)
                alarmed = True
        self.durations.append(dt)
        return alarmed

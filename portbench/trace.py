"""Reads the traced slice of a run from ``torch.profiler``'s events.

The slice is the CPU range ``portbench::slice`` that the harness opens
around a fixed number of steps and closes after a device sync, so every
kernel of the slice ends inside it.  From the device timeline (kernels,
copies and sets; the mirrors of CPU ranges left out) it reads the seconds
in which something ran on the device (the union of the intervals), the
device operations that took most time, and the idle gaps, each labelled
by what the host's main thread was doing at its middle (the harness
range it was in and the innermost event there).  ``op_device_s`` gives
the device time of every kernel launched inside a CPU operator or range,
by name.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SLICE = "portbench::slice"
TOP = 10


def _union(intervals: List[Tuple[float, float]], lo: float, hi: float):
    """Merged busy intervals clipped to [lo, hi] and the gaps between."""
    busy, gaps = [], []
    cur = lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            if a > cur:
                gaps.append((cur, a))
            busy.append([a, b])
        cur = max(cur, busy[-1][1])
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _labels(cpu: List[Tuple[float, float, str]], points: List[float]):
    """For each time in ``points`` (ascending), "<harness range>/<innermost
    event>" of the properly nested ``cpu`` events (start, end, name)
    covering it."""
    cpu = sorted(cpu, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(cpu) and cpu[i][0] <= t:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        live = [e for e in stack if e[1] >= t]
        if not live:
            out.append("(outside every event)")
            continue
        outer = next((e[2] for e in live if e[2].startswith("portbench::")
                      and e[2] != SLICE), "")
        inner = live[-1][2]
        out.append(f"{outer}/{inner}" if outer and outer != inner
                   else inner)
    return out


def analyse(prof) -> Optional[Dict]:
    """busy_s, window_s, device_ops, idle_gaps and op_device_s of the
    slice, or None where the trace holds no slice or no device event."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    win = [e for e in events if e.name == SLICE
           and e.device_type == DeviceType.CPU]
    if not win:
        return None
    w = win[0]
    lo, hi = w.time_range.start, w.time_range.end
    cpu_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    dev = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA and e.name not in cpu_names
           and e.time_range.end > lo and e.time_range.start < hi]
    if not dev:
        return None
    busy, gaps = _union([(a, b) for a, b, _ in dev], lo, hi)
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_op[name] += (min(b, hi) - max(a, lo)) / 1e6
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CPU and e.thread == w.thread
           and e.name != SLICE and e.time_range.end > lo
           and e.time_range.start < hi]
    mids = [(a + b) / 2 for a, b in gaps]
    by_host: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, _labels(cpu, mids)):
        by_host[label] += (b - a) / 1e6
    op_dev: Dict[str, float] = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            op_dev[e.key] += us / 1e6
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (hi - lo) / 1e6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                            key=lambda x: -x[1])[:TOP],
        "op_device_s": dict(op_dev),
    }


"""Process-local serving metrics: counters, gauges, log-bucket histograms.

No dependencies, no locks, no background threads — a metric is a plain
python object the serving loop mutates with one attribute update, and the
registry is a dict of them.  That cost profile is the point: the engine's
always-on counters (``Engine.stats`` reads through this registry) must be
no more expensive than the ad-hoc dict they replaced, and everything
heavier (timestamps, span recording) lives behind the ``Observer``
on/off switch, not here.

Three metric kinds:

  ``Counter``    monotonic float/int total (``inc``).
  ``Gauge``      last-set value plus an all-time ``high_water`` mark
                 (``set`` / ``set_max``); a gauge may instead be LAZY —
                 registered with a zero-arg callable evaluated at
                 ``collect()`` time, which is how allocator/pool telemetry
                 (``BlockAllocator.n_recycled``, pool occupancy, …) is
                 lifted into the registry with ZERO hot-path cost.
  ``Histogram``  fixed log-spaced buckets over (lo, hi): bucket ``i``
                 spans ``lo·g^i .. lo·g^(i+1)`` with ``g`` chosen for
                 ``per_decade`` buckets per factor of 10.  Records count /
                 sum / exact min / exact max, estimates quantiles by
                 log-linear interpolation inside the owning bucket, and
                 EXCLUDES None/NaN observations into ``n_excluded``
                 instead of polluting the distribution with zeros (the
                 ``decode_tok_s`` single-token case).

Exports: ``collect()`` (a plain JSON-able dict) and ``to_prometheus()``
(the text exposition format, cumulative ``le`` buckets and all).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union


class Counter:
    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def collect(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Settable point-in-time value + its all-time high-water mark.

    A gauge constructed with ``fn`` is LAZY: ``value``/``high_water`` are
    read from the callable at collect time and the serving loop never
    touches it — the lift path for host-side allocator telemetry."""

    __slots__ = ("name", "help", "_value", "high_water", "fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], Union[int, float]]] = None):
        self.name, self.help, self.fn = name, help, fn
        self._value: Union[int, float] = 0
        self.high_water: Union[int, float] = 0

    @property
    def value(self) -> Union[int, float]:
        return self.fn() if self.fn is not None else self._value

    def set(self, v: Union[int, float]) -> None:
        self._value = v
        if v > self.high_water:
            self.high_water = v

    def set_max(self, v: Union[int, float]) -> None:
        """Ratchet: keep the max of all ``set_max`` calls (peak_active)."""
        if v > self._value:
            self._value = v
        if v > self.high_water:
            self.high_water = v

    def collect(self) -> Dict[str, Any]:
        v = self.value
        hw = max(self.high_water, v) if self.fn is None else v
        return {"type": "gauge", "value": v, "high_water": hw}


class Histogram:
    """Fixed log-spaced buckets; see module docstring.

    ``observe(None)`` / ``observe(nan)`` increments ``n_excluded`` and
    leaves every aggregate untouched — the caller's "no sample" marker
    never skews a mean or a percentile."""

    __slots__ = ("name", "help", "lo", "edges", "buckets", "underflow",
                 "count", "total", "vmin", "vmax", "n_excluded")

    def __init__(self, name: str, help: str = "", lo: float = 1e-5,
                 hi: float = 1e3, per_decade: int = 5):
        assert 0 < lo < hi and per_decade > 0
        self.name, self.help, self.lo = name, help, lo
        n = int(math.ceil(per_decade * math.log10(hi / lo)))
        # edges[i] is the UPPER bound of bucket i (log-spaced, edges[-1]>=hi)
        self.edges: List[float] = [lo * 10.0 ** ((i + 1) / per_decade)
                                   for i in range(n)]
        self.buckets = [0] * n
        self.underflow = 0  # observations <= lo (bucketed at the floor)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.n_excluded = 0

    def observe(self, x: Optional[float]) -> None:
        if x is None or (isinstance(x, float) and math.isnan(x)):
            self.n_excluded += 1
            return
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.vmin:
            self.vmin = x
        if x > self.vmax:
            self.vmax = x
        if x <= self.lo:
            self.underflow += 1
            return
        i = int(math.log10(x / self.lo) * len(self.edges)
                / math.log10(self.edges[-1] / self.lo))
        i = min(max(i, 0), len(self.edges) - 1)
        # float rounding can land one bucket off the true edge pair
        while i > 0 and x <= self._lower(i):
            i -= 1
        while i < len(self.edges) - 1 and x > self.edges[i]:
            i += 1
        self.buckets[i] += 1

    def _lower(self, i: int) -> float:
        return self.lo if i == 0 else self.edges[i - 1]

    def percentile(self, q: float) -> Optional[float]:
        """Quantile estimate (q in [0,1]): log-linear interpolation inside
        the owning bucket, clamped to the exact observed min/max."""
        if self.count == 0:
            return None
        rank = q * self.count
        seen = self.underflow
        if rank <= seen:
            return self.vmin
        for i, n in enumerate(self.buckets):
            if n and rank <= seen + n:
                frac = (rank - seen) / n
                lo, hi = self._lower(i), self.edges[i]
                est = lo * (hi / lo) ** frac
                return min(max(est, self.vmin), self.vmax)
            seen += n
        return self.vmax

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def collect(self) -> Dict[str, Any]:
        return {"type": "histogram", "count": self.count, "sum": self.total,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "mean": self.mean,
                "p50": self.percentile(0.50),
                "p90": self.percentile(0.90),
                "p99": self.percentile(0.99),
                "n_excluded": self.n_excluded,
                "buckets": {f"{e:.6g}": n for e, n in
                            zip(self.edges, self.buckets) if n},
                "underflow_le": {f"{self.lo:.6g}": self.underflow}}


class MetricsRegistry:
    """Name -> metric, get-or-create.  ``counter``/``gauge``/``histogram``
    return the live object (the caller caches it and mutates attributes —
    no per-event dict lookups on the serving path); ``gauge_fn`` registers
    a lazy gauge read only at collect time."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}

    def _get(self, kind, name, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, **kw)
            self._metrics[name] = m
        assert isinstance(m, kind), (name, type(m), kind)
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help=help)

    def gauge_fn(self, name: str, fn: Callable[[], Union[int, float]],
                 help: str = "") -> Gauge:
        g = self._get(Gauge, name, help=help)
        g.fn = fn
        return g

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(Histogram, name, help=help, **kw)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def collect(self) -> Dict[str, Dict[str, Any]]:
        """Point-in-time snapshot of every metric as a JSON-able dict
        (lazy gauges are evaluated here and only here)."""
        return {name: self._metrics[name].collect()
                for name in sorted(self._metrics)}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format: counters as ``_total``,
        histograms with CUMULATIVE ``le`` buckets + ``_sum``/``_count``."""
        out: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                out.append(f"# TYPE {name} counter")
                out.append(f"{name}_total {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                out.append(f"# TYPE {name} gauge")
                c = m.collect()
                out.append(f"{name} {_fmt(c['value'])}")
                out.append(f"{name}_high_water {_fmt(c['high_water'])}")
            else:
                out.append(f"# TYPE {name} histogram")
                cum = m.underflow
                out.append(f'{name}_bucket{{le="{m.lo:.6g}"}} {cum}')
                for e, n in zip(m.edges, m.buckets):
                    cum += n
                    out.append(f'{name}_bucket{{le="{e:.6g}"}} {cum}')
                out.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                out.append(f"{name}_sum {_fmt(m.total)}")
                out.append(f"{name}_count {m.count}")
        return "\n".join(out) + "\n"


def _fmt(v: Union[int, float]) -> str:
    return repr(int(v)) if isinstance(v, int) or float(v).is_integer() \
        else repr(float(v))

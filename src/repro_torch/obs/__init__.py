"""``repro_torch.obs`` — serving observability: metrics, tracing, export.

A copy of ``repro.obs`` (standard library only; the port imports nothing
of the JAX package).  Three pillars:

  1. :mod:`repro_torch.obs.metrics` — process-local counters / gauges /
     log-bucket histograms, JSON + Prometheus text export, no deps.
  2. :mod:`repro_torch.obs.trace` — request-lifecycle spans in a bounded ring
     buffer with Chrome/Perfetto ``trace_event`` JSON export.
  3. :mod:`repro_torch.obs.observer` — the single seam the engine emits
     through.  Off by default (``ServeConfig.obs`` falsy → ``NULL``, a
     shared no-op stub) and host-timestamp-only: its hooks never read a
     device tensor, so they add no host sync to a serving step.  Its
     ``span`` and ``range`` also name the engine's and the model's
     phases on a profiler's timeline while one records.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                               MetricsRegistry)
from repro_torch.obs.trace import (TraceBuffer, Track,  # noqa: F401
                             engine_track, phase_track, request_track,
                             slot_track)
from repro_torch.obs.observer import (NULL, NullObserver, Observer,  # noqa: F401
                                activated, get_active)
from repro_torch.obs.export import (request_events, serving_obs_doc,  # noqa: F401
                              snapshot, validate_perfetto, write_json,
                              write_perfetto)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceBuffer", "Track", "engine_track", "phase_track", "request_track",
    "slot_track",
    "NULL", "NullObserver", "Observer", "activated", "get_active",
    "request_events", "serving_obs_doc", "snapshot", "validate_perfetto",
    "write_json", "write_perfetto",
]

"""Observability of the port: spans, metrics, graph captures and replays.

- :mod:`~repro_torch.obs.trace`: per-request span recording with a
  Chrome trace-event / Perfetto exporter, and the shared monotonic
  :func:`~repro_torch.obs.trace.timecall` timing helper (the port of
  ``repro.obs.trace``).
- :mod:`~repro_torch.obs.metrics`: counters, gauges, log-bucketed
  streaming histograms with exact-bound percentiles and mergeable
  snapshots (the port of ``repro.obs.metrics``, NumPy only).
- :mod:`~repro_torch.obs.graph_hooks`: capture, replay and host-read
  counters of the decode step's CUDA graph (the counterpart of
  ``repro.obs.jax_hooks``).

Producers hold their tracer and registry as ``None`` by default and guard
each recording site with one ``is not None`` check; the ``Null*`` classes
cover unconditional call sites. The JAX package's drift monitor
(``obs/monitor``) is not ported yet.
"""
from . import graph_hooks
from .metrics import (DEFAULT_PERCENTILES, NULL_REGISTRY, Counter, Gauge,
                      HistogramSnapshot, MetricsRegistry, NullHistogram,
                      NullRegistry, StreamingHistogram, histogram_per_lane,
                      merge_snapshots)
from .trace import (NULL_TRACER, VIRTUAL_PID, WALL_PID, NullTracer, Tracer,
                    monotonic, spans_by_request, timecall,
                    validate_request_trees)

__all__ = [
    "graph_hooks",
    "Tracer", "NullTracer", "NULL_TRACER", "VIRTUAL_PID", "WALL_PID",
    "monotonic", "timecall", "spans_by_request", "validate_request_trees",
    "StreamingHistogram", "HistogramSnapshot", "merge_snapshots",
    "histogram_per_lane", "Counter", "Gauge", "MetricsRegistry",
    "NullRegistry", "NullHistogram", "NULL_REGISTRY", "DEFAULT_PERCENTILES",
]

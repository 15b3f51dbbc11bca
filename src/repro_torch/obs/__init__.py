"""Observability of the port: graph captures, replays and host reads.

``graph_hooks`` is the counterpart of ``repro.obs.jax_hooks``; the JAX
package's request tracer and metrics registry (``obs/trace``,
``obs/metrics``) are not ported yet.
"""
from . import graph_hooks

__all__ = ["graph_hooks"]

"""Capture, replay and host-read counters for the decode step's CUDA graph.

The counterpart of ``repro.obs.jax_hooks``. The JAX package compiles its
fused decode chunk once per input signature and counts traces; the port
captures its decode step once per shape as a CUDA graph and replays it,
so the counted events are captures (``capture_counts``, the counterpart
of ``trace_counts``) and replays. "One compile serves all budgets"
becomes ``assert_max_captures(label, 1)`` over a serve of requests with
other budgets and prompt lengths.

:class:`GraphCache` holds one captured step per key (a shape). Its
:meth:`GraphCache.run` runs the step once: the first time for a key
eagerly (the warm-up, which also builds the kernels and allocates their
buffers before any capture), and captures it; every later time by
replaying the graph. On a CPU tensor nothing is captured and the same
step runs eagerly each time, counted the same way, so the CPU tests
exercise the static-buffer code path and the counters. On CUDA a capture
that fails raises; nothing falls back to the eager step.

Kernel launches: each wrapper adds one to ``kernels.LAUNCHES`` when it is
called, and a replay calls no wrapper. A capture records the ``LAUNCHES``
delta of its step, takes it back (the captured kernels did not run) and
adds it again on each replay, so ``LAUNCHES`` stays the count of kernels
the card ran.

:func:`to_host` is the counted device-to-host read. The registry is
process-global; tests isolate with :func:`reset`.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable, Optional, Sequence

import numpy as np
import torch

from ..kernels import LAUNCHES

__all__ = ["GraphCache", "capture_counts", "replay_counts",
           "transfer_counts", "to_host", "assert_max_captures", "reset",
           "snapshot"]

_lock = threading.Lock()
_captures: collections.Counter = collections.Counter()
_replays: collections.Counter = collections.Counter()
_transfers: collections.Counter = collections.Counter()


def _bump(counter: collections.Counter, label: str) -> None:
    with _lock:
        counter[label] += 1


class _Captured:
    """One step, captured as a CUDA graph or kept to run eagerly.

    A captured step drops ``fn``: the closure usually holds its engine,
    which holds this object, and that cycle would keep the engine's
    weights and the graph's memory pool alive until a garbage collection.
    """

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 generators: Sequence[torch.Generator]):
        self.fn, self.graph = fn, None
        self.launches: collections.Counter = collections.Counter()
        if device.type != "cuda":
            return
        before = collections.Counter(LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph):
            fn()
        self.launches = LAUNCHES - before
        LAUNCHES.subtract(self.launches)
        self.fn, self.graph = None, graph

    def replay(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        LAUNCHES.update(self.launches)


class GraphCache:
    """Captured steps by key, counted under ``label``.

    ``generators``: the ``torch.Generator``s the step draws from, registered
    with each graph so every replay draws fresh numbers.
    """

    def __init__(self, label: str, device,
                 generators: Sequence[torch.Generator] = ()):
        self.label = label
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self._steps: dict = {}

    def launches(self, key: Hashable) -> collections.Counter:
        """The kernel launches one replay of ``key``'s step adds."""
        return collections.Counter(self._steps[key].launches)

    def run(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Run ``key``'s step once. ``fn`` (a step over static buffers) is
        used only the first time a key is seen: run eagerly, then
        captured; later calls replay that capture and ignore ``fn``."""
        step = self._steps.get(key)
        if step is None:
            self._warm_up(fn)
            self._steps[key] = _Captured(fn, self.device, self.generators)
            _bump(_captures, self.label)
            return
        step.replay()
        _bump(_replays, self.label)

    def _warm_up(self, fn: Callable[[], None]) -> None:
        """The eager first run; on CUDA on a side stream, as PyTorch asks
        of work that is captured next."""
        if self.device.type != "cuda":
            fn()
            return
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(self.device).wait_stream(side)


def capture_counts() -> dict:
    """``{label: n_captures}``, the counterpart of ``trace_counts``."""
    with _lock:
        return dict(_captures)


def replay_counts() -> dict:
    """``{label: n_replays}`` (eager runs of a CPU step count too)."""
    with _lock:
        return dict(_replays)


def transfer_counts() -> dict:
    """``{label: n_reads}`` for every counted device-to-host read site."""
    with _lock:
        return dict(_transfers)


def to_host(x: torch.Tensor, label: str = "to_host") -> np.ndarray:
    """Counted device-to-host read: ``x`` as a numpy array (one blocking
    copy when ``x`` lies on the card)."""
    _bump(_transfers, label)
    return x.detach().cpu().numpy()


def assert_max_captures(label: str, max_captures: int) -> int:
    """Assert ``label`` captured at most ``max_captures`` times; returns
    the count. The guard of "one capture serves all budgets"."""
    n = capture_counts().get(label, 0)
    if n > max_captures:
        raise AssertionError(
            f"graph {label!r} captured {n} times (allowed {max_captures}); "
            f"a shape leaked into the captured step's key")
    return n


def reset(label: Optional[str] = None) -> None:
    """Clear the counters (all labels, or one). The captured graphs stay
    with their caches: a key seen before is not captured again."""
    with _lock:
        for counter in (_captures, _replays, _transfers):
            if label is None:
                counter.clear()
            else:
                counter.pop(label, None)


def snapshot() -> dict:
    """JSON-able ``{"captures": ..., "replays": ..., "transfers": ...}``."""
    return {"captures": capture_counts(), "replays": replay_counts(),
            "transfers": transfer_counts()}

"""Per-request span recording with a Chrome trace-event / Perfetto exporter.

The port of ``repro.obs.trace``. The server and both engines record
*spans* (named intervals with microsecond timestamps) onto a
:class:`Tracer`, which exports the standard Chrome trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev). Two clocks coexist in
one trace as separate processes:

* ``pid=VIRTUAL_PID``: the simulated queueing timeline (arrival / admit /
  prefill / decode / retire per request). Timestamps are the *model's*
  seconds, passed explicitly by the producer.
* ``pid=WALL_PID``: the monotonic wall clock (prefills, admissions,
  decode chunks), recorded by :meth:`Tracer.span` around real work. On a
  CUDA device a host timestamp taken after a launch marks the enqueue,
  not the work; the engines' spans therefore end at a host read or a
  synchronisation. A span yields its args dict, so that values known only
  at its close (device times read after its synchronisation, counts read
  back) become its args.

The continuous engine's wall spans (``serving/continuous.py``):
``continuous.admit`` (args ``rows``, ``S``) and
``continuous.decode_chunk`` (``chunk``, ``occupancy``,
``tokens_in_use``), as the JAX package's; ``continuous.admit.read``
(the first tokens' read) inside the first; ``continuous.chunk.prepare``
before the second and ``continuous.chunk.retire`` after it; and right
after each parent, ``continuous.admit.stats`` (MoE: ``pairs``, ``kept``,
``experts_hit``) and ``continuous.chunk.stats`` (CUDA: ``first_step_ms``,
``step_ms`` from CUDA events; MoE: ``pairs``, ``experts_hit``), whose
args are what the tracer's reads after the parent's close bring back.
The MoE counts come from the routing hook of ``models/moe.py``
(``count_routing``).

Every event that belongs to a request carries ``args={"rid": ...}`` so the
span tree can be validated programmatically (:func:`spans_by_request`,
:func:`validate_request_trees`): every completed request's trace covers
admit -> prefill -> decode -> retire.

Disabled-path cost: producers hold ``tracer=None`` by default and guard
every recording site with one ``is not None`` check; :class:`NullTracer`
makes every method a no-op for unconditional call sites.

This module also owns the one wall-clock timing helper
(:func:`timecall`) that ``serving.server.LLMServer`` measures wall-mode
service time with: ``time.perf_counter`` and ``warmup`` untimed calls
first, so one-time costs (kernel builds, graph captures) are never billed
to a request.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "VIRTUAL_PID", "WALL_PID",
           "monotonic", "timecall", "spans_by_request",
           "validate_request_trees"]

VIRTUAL_PID = 1     # simulated queueing timeline (model seconds)
WALL_PID = 2        # monotonic wall clock (engine work)

_PID_NAMES = {VIRTUAL_PID: "queueing timeline (virtual clock)",
              WALL_PID: "engine (wall clock)"}


def monotonic() -> float:
    """The package's single monotonic wall clock (seconds)."""
    return time.perf_counter()


def timecall(fn, *args, warmup: int = 0, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(result, seconds)``.

    ``warmup`` untimed calls run first, so one-time costs never
    contaminate the measured call.
    """
    for _ in range(max(int(warmup), 0)):
        fn(*args, **kwargs)
    t0 = monotonic()
    out = fn(*args, **kwargs)
    return out, monotonic() - t0


class Tracer:
    """Append-only event recorder exporting Chrome trace-event JSON.

    Virtual-timeline producers pass explicit ``ts_s`` (seconds on the
    simulated clock); wall producers use the :meth:`span` context manager
    (monotonic clock anchored at tracer construction). Timestamps are
    stored in microseconds, the trace-event unit.
    """

    enabled = True

    def __init__(self):
        self._events: list = []
        self._wall0 = monotonic()
        self._named_pids: set = set()

    # ------------------------------------------------------------- plumbing
    def __len__(self) -> int:
        return len(self._events)

    def _wall_us(self) -> float:
        return (monotonic() - self._wall0) * 1e6

    def _name_pid(self, pid: int) -> None:
        if pid not in self._named_pids and pid in _PID_NAMES:
            self._named_pids.add(pid)
            self._events.append({"ph": "M", "name": "process_name",
                                 "pid": pid, "tid": 0,
                                 "args": {"name": _PID_NAMES[pid]}})

    def _push(self, ev: dict) -> None:
        self._name_pid(ev.get("pid", VIRTUAL_PID))
        self._events.append(ev)

    # ------------------------------------------------------------ recording
    def complete(self, name: str, ts_s: float, dur_s: float, *, tid: int = 0,
                 pid: int = VIRTUAL_PID, cat: str = "", args=None) -> None:
        """A complete ("X") span: ``[ts_s, ts_s + dur_s]`` in seconds."""
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": ts_s * 1e6, "dur": max(dur_s, 0.0) * 1e6}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def instant(self, name: str, ts_s: float | None = None, *, tid: int = 0,
                pid: int = VIRTUAL_PID, cat: str = "", args=None) -> None:
        """An instant ("i") event; ``ts_s=None`` stamps the wall clock."""
        ts = self._wall_us() if ts_s is None else ts_s * 1e6
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid, "ts": ts,
              "s": "t"}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def counter(self, name: str, ts_s: float | None = None, *, tid: int = 0,
                pid: int = VIRTUAL_PID, **values) -> None:
        """A counter ("C") sample rendered as a stacked track."""
        ts = self._wall_us() if ts_s is None else ts_s * 1e6
        self._push({"ph": "C", "name": name, "pid": pid, "tid": tid,
                    "ts": ts, "args": {k: float(v)
                                       for k, v in values.items()}})

    @contextmanager
    def span(self, name: str, *, tid: int = 0, pid: int = WALL_PID,
             cat: str = "", args=None):
        """Wall-clock span around real work (prefill, admission, chunk).

        Yields the span's args dict (a copy of ``args``): what the body
        puts there is recorded at the close, so a span can carry values
        known only after its host read (device times, counts)."""
        t0 = self._wall_us()
        out = dict(args or {})
        try:
            yield out
        finally:
            ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
                  "ts": t0, "dur": self._wall_us() - t0}
            if cat:
                ev["cat"] = cat
            if out:
                ev["args"] = out
            self._push(ev)

    # ------------------------------------------------------------- exporting
    def to_chrome(self) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms"}

    def dump(self, path: str) -> str:
        """Write the trace JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NullTracer(Tracer):
    """No-op tracer: every recording method returns immediately."""

    enabled = False

    def complete(self, *a, **k):
        pass

    def instant(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass

    @contextmanager
    def span(self, *a, **k):
        yield {}

    def _push(self, ev):
        pass


NULL_TRACER = NullTracer()


# --------------------------------------------------------------------------
# Trace validation
# --------------------------------------------------------------------------

def spans_by_request(trace: dict) -> dict:
    """Index a Chrome trace by request id.

    Returns ``{rid: {name: (ts_us, dur_us)}}`` over all "X" events whose
    ``args`` carry a ``rid``, plus instants as ``(ts_us, 0.0)``.
    """
    out: dict = {}
    for ev in trace.get("traceEvents", []):
        rid = (ev.get("args") or {}).get("rid")
        if rid is None or ev.get("ph") not in ("X", "i"):
            continue
        out.setdefault(rid, {})[ev["name"]] = (
            float(ev["ts"]), float(ev.get("dur", 0.0)))
    return out


def validate_request_trees(trace: dict, rids, *,
                           phases=("request", "admit", "prefill", "decode",
                                   "retire"), tol_us: float = 1.0) -> dict:
    """Assert every request's span tree covers admit -> prefill -> decode
    -> retire inside its enclosing ``request`` span.

    Checks, per rid: all ``phases`` present; the child phases tile the
    ``request`` interval in order (each child starts where the previous
    ended, within ``tol_us``); ``retire`` sits at the request's end.
    Returns ``{"n_requests": ..., "n_events": ...}`` on success, raises
    ``AssertionError`` naming the first offending request otherwise.
    """
    idx = spans_by_request(trace)
    rids = list(rids)
    seq = [p for p in phases if p not in ("request", "retire")]
    for rid in rids:
        spans = idx.get(rid)
        if spans is None:
            raise AssertionError(f"request {rid}: no spans in trace")
        missing = [p for p in phases if p not in spans]
        if missing:
            raise AssertionError(f"request {rid}: missing phases {missing}")
        ts0, dur = spans["request"]
        cursor = ts0
        for name in seq:
            ts, d = spans[name]
            if abs(ts - cursor) > tol_us:
                raise AssertionError(
                    f"request {rid}: {name} starts at {ts}, expected "
                    f"{cursor}")
            cursor = ts + d
        if abs(cursor - (ts0 + dur)) > tol_us:
            raise AssertionError(
                f"request {rid}: phases end at {cursor}, request ends at "
                f"{ts0 + dur}")
        rt, _ = spans["retire"]
        if abs(rt - (ts0 + dur)) > tol_us:
            raise AssertionError(
                f"request {rid}: retire at {rt}, request ends at "
                f"{ts0 + dur}")
    return {"n_requests": len(rids),
            "n_events": len(trace.get("traceEvents", []))}

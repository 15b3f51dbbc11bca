"""One steady slice of a traced run, under ``torch.profiler``, reduced to
what the per-layer readers and the result's ``breakdown`` need.

The slice opens a fixed time after the window has closed, the loop
serving on under the same load, and lasts a fixed time (the cell's
``profile``), the same in every run: the profiler cannot hold a whole
window of 64-row decode, and its start and stop stall the host for
seconds, which inside the window would reach every request's times. Device activity is every kernel, copy
and fill on the card; the device is busy where their intervals overlap,
and idle in the gaps between them. Each gap is named by the loop's
``record_function`` label (and the innermost CPU op) that the host was
inside at the gap's midpoint.

Times are moved onto the loop's clock through a mark that the loop
records at the slice's start.
"""
from __future__ import annotations

import bisect
import dataclasses

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

MARK = "portbench.slice"


@dataclasses.dataclass
class Slice:
    start: float                 # loop clock, s
    end: float
    kernels: list                # (name, start, end), loop clock, sorted
    busy_s: float
    gaps: list                   # (label, seconds), longest first
    ops: list                    # (name, seconds), most time first

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def kernel_time(self, needle: str, t0: float, t1: float) -> float:
        return sum(e - s for n, s, e in self.kernels
                   if needle in n and t0 <= s and e <= t1)


class Profiler:
    """Start and stop at the loop's boundaries (``tick(now)``); the trace
    is read (``finish``) once the window has closed, so that its reading
    holds up no request."""

    def __init__(self, loop, start: float, length: float):
        self.loop, self.t_start, self.t_stop = loop, start, start + length
        self.prof = self.stopped = self.result = None
        self.mark_t = self.end_t = None

    def tick(self, now: float) -> None:
        if self.prof is None and self.stopped is None and now >= self.t_start:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.mark_t = self.loop.now()
            with record_function(MARK):
                pass
        elif self.prof is not None and now >= self.t_stop:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.end_t = self.loop.now()
            self.prof.stop()
            self.stopped, self.prof = self.prof, None

    def finish(self):
        if self.prof is not None:              # the window ended first
            self.tick(float("inf"))
        if self.stopped is not None:
            self.result = reduce(self.stopped.events(), self.mark_t,
                                 self.end_t)
            self.stopped = None
        return self.result


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, mark_t: float, end_t: float) -> Slice:
    mark = next(e for e in events if e.name == MARK)
    off = mark_t - mark.time_range.start * 1e-6

    def loop_t(us):
        return us * 1e-6 + off
    dev, host = [], []
    for e in events:
        s, t = loop_t(e.time_range.start), loop_t(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # the loop's labels come back as device annotations too
            if s >= mark_t and t <= end_t and not e.name.startswith(
                    "portbench."):
                dev.append((e.name, s, t))
        elif s >= mark_t and e.name != MARK:
            host.append((e.name, s, t))
    dev.sort(key=lambda x: x[1])
    busy = _union([(s, t) for _, s, t in dev])
    busy_s = sum(t - s for s, t in busy)
    edges = [mark_t] + [x for b in busy for x in b] + [end_t]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in host]

    def label(t):
        before = host[:bisect.bisect_right(starts, t)]
        inside = [(n, s, e) for n, s, e in before if e >= t]
        loop_labels = [x for x in inside if x[0].startswith("portbench.")]
        outer = max(loop_labels, key=lambda x: x[1])[0] if loop_labels \
            else "outside the loop"
        ops = [x for x in inside if not x[0].startswith("portbench.")]
        inner = max(ops, key=lambda x: x[1])[0] if ops else ""
        return f"{outer} > {inner}" if inner else outer
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = [(label((s + e) / 2), e - s) for s, e in longest]
    per_op: dict = {}
    for n, s, t in dev:
        per_op[n] = per_op.get(n, 0.0) + (t - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    return Slice(mark_t, end_t, dev, busy_s, named, ops)

"""End-to-end arithmetic over the loop's own request records.

Every request is timed from when it was due (an open loop), on the
loop's clock, and a request that the window closes on counts at what it
had then: not admitted, its time to first token is its age at the close;
unfinished, its system time is its age at the close (a lower bound, so a
stall still raises the mean); in flight, its time per output token is
taken over the tokens read so far.
"""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The exact ``q``-th percentile (0-100) of ``values``, interpolated
    linearly between order statistics (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values) -> float:
    xs = [float(v) for v in values]
    return sum(xs) / len(xs) if xs else math.nan


def due_in(requests, t_open: float, t_close: float) -> list:
    return [r for r in requests if t_open <= r.due < t_close]


def ttft_s(r, t_close: float) -> float:
    if r.first_read <= t_close:
        return r.first_read - r.due
    return t_close - r.due              # NaN first_read compares False


def system_time_s(r, t_close: float) -> float:
    if r.done and r.last_read <= t_close:
        return r.last_read - r.due
    return t_close - r.due


def tpot_s(r, t_close: float):
    """(last read - first read) / (tokens - 1) over the tokens read by the
    close; None below two tokens."""
    reads = [t for t in r.read_times if t <= t_close]
    if len(reads) < 2:
        return None
    return (reads[-1] - reads[0]) / (len(reads) - 1)


def tokens_per_s(requests, t_open: float, t_close: float) -> float:
    """Output tokens read back inside the window over its seconds."""
    n = sum(1 for r in requests for t in r.read_times
            if t_open <= t < t_close)
    return n / (t_close - t_open)


def poisson_metrics(requests, t_open: float, t_close: float) -> dict:
    due = due_in(requests, t_open, t_close)
    tpots = [x for x in (tpot_s(r, t_close) for r in due) if x is not None]
    return {
        "ttft_p90_ms": 1e3 * percentile([ttft_s(r, t_close) for r in due],
                                        90),
        "tpot_p90_ms": 1e3 * percentile(tpots, 90),
        "system_time_mean_s": mean(system_time_s(r, t_close) for r in due),
    }


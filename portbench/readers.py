"""Helpers that the metric readers (``metrics/<name>.py``) share."""
from __future__ import annotations

from . import roofline, stats


def spans(ctx, name: str) -> list:
    """The port's wall spans ``name`` that began inside the window."""
    return [s for s in ctx.spans
            if s[0] == name and ctx.t_open <= s[1] < ctx.t_close]


def chunks_in(ctx, t0: float, t1: float) -> list:
    return [c for c in ctx.loop.chunks if t0 <= c.start and c.end <= t1]


def admissions_in(ctx, t0: float, t1: float) -> list:
    return [a for a in ctx.loop.admissions if t0 <= a[1] and a[2] <= t1]


def step_ctxs(rows, step: int) -> list:
    """Positions each live row attends at decode step ``step`` of a chunk
    (its cache, the steps before, and its own token), for the rows that
    take that step."""
    return [ctx + step + 1 for ctx, n in rows if step < n]


def decode_flops(spec: dict, chunk) -> float:
    return sum(roofline.decode_token_flops(spec, ctx + i + 1)
               for ctx, n in chunk.rows for i in range(n))


def share(bound: float, took: float):
    """``bound / took`` in %, or None where nothing was timed."""
    return 100.0 * bound / took if took > 0 else None


def mean(xs):
    xs = list(xs)
    return stats.mean(xs) if xs else None

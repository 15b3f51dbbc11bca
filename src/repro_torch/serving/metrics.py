"""Serving metrics aggregation: the port of ``repro.serving.metrics``."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core.params import Problem
from .request import CompletedRequest

#: percentiles every report carries (keys "p50", "p90", "p99", "p99_9")
REPORT_PERCENTILES = (50.0, 90.0, 99.0, 99.9)


def percentile_summary(values) -> dict:
    """Exact-percentile dict (inverted-CDF order statistics); {} on empty
    input."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        return {}
    return {f"p{q:g}".replace(".", "_"):
            float(np.percentile(v, q, method="inverted_cdf"))
            for q in REPORT_PERCENTILES}


@dataclasses.dataclass
class ServingReport:
    n: int
    mean_wait: float
    mean_service: float
    mean_system_time: float
    p50_system_time: float
    p99_system_time: float
    utilization: float
    accuracy: float
    mean_accuracy_prob: float
    objective: float
    per_task_budget: dict
    per_task_system_time: dict
    tokens_generated: int
    n_resolves: int
    estimator_state: dict | None = None
    wait_percentiles: dict | None = None
    system_time_percentiles: dict | None = None
    # last predicted-vs-measured drift check; None on the server path
    # (no drift monitor runs there)
    drift: dict | None = None
    # KV occupancy sampled at the continuous engine's chunk boundaries
    # (occupancy_summary); None without a continuous engine
    occupancy: dict | None = None
    # correctly answered served requests per unit time
    goodput: float | None = None
    # admission control (serving.admission): requests shed, their share
    # of the stream, and the time-weighted fraction spent at each
    # degradation level ({"0": 0.93, "1": 0.07, ...}; None when no
    # admission controller ran)
    n_shed: int = 0
    shed_fraction: float = 0.0
    degradation_occupancy: dict | None = None


def empty_report(n_resolves: int = 0,
                 estimator_state: dict | None = None) -> ServingReport:
    """Zeroed report for an empty completed list."""
    return ServingReport(
        n=0, mean_wait=0.0, mean_service=0.0, mean_system_time=0.0,
        p50_system_time=0.0, p99_system_time=0.0, utilization=0.0,
        accuracy=0.0, mean_accuracy_prob=0.0, objective=0.0,
        per_task_budget={}, per_task_system_time={}, tokens_generated=0,
        n_resolves=n_resolves, estimator_state=estimator_state)


def occupancy_summary(samples, pool_tokens: int) -> dict | None:
    """Fold (tokens_in_use, pool_fill) samples into the report's occupancy
    gauge: {"mean_tokens_in_use", "peak_tokens_in_use", "mean_pool_fill",
    "peak_pool_fill", "pool_tokens", "n_samples"}; None on no samples."""
    if not samples:
        return None
    tok = np.asarray([s[0] for s in samples], dtype=np.float64)
    fill = np.asarray([s[1] for s in samples], dtype=np.float64)
    return {"mean_tokens_in_use": float(tok.mean()),
            "peak_tokens_in_use": float(tok.max()),
            "mean_pool_fill": float(fill.mean()),
            "peak_pool_fill": float(fill.max()),
            "pool_tokens": int(pool_tokens),
            "n_samples": int(tok.size)}


def summarize(problem: Problem, completed: Sequence[CompletedRequest],
              horizon: float, n_resolves: int = 0,
              estimator_state: dict | None = None,
              drift: dict | None = None,
              occupancy: dict | None = None) -> ServingReport:
    if not completed:
        return empty_report(n_resolves, estimator_state)
    waits = np.array([c.wait_time for c in completed])
    serv = np.array([c.service_time for c in completed])
    syst = np.array([c.system_time for c in completed])
    tasks = np.array([c.task_index for c in completed])
    budgets = np.array([c.budget for c in completed])
    correct = np.array([c.correct for c in completed])
    A = problem.tasks.A.numpy()[tasks]
    b = problem.tasks.b.numpy()[tasks]
    D = problem.tasks.D.numpy()[tasks]
    p_row = A * (1 - np.exp(-b * budgets)) + D
    per_budget = {}
    per_sys = {}
    for k in range(problem.tasks.n_tasks):
        sel = tasks == k
        if sel.any():
            per_budget[problem.tasks.names[k]] = float(budgets[sel].mean())
            per_sys[problem.tasks.names[k]] = float(syst[sel].mean())
    return ServingReport(
        n=len(completed),
        mean_wait=float(waits.mean()),
        mean_service=float(serv.mean()),
        mean_system_time=float(syst.mean()),
        p50_system_time=float(np.percentile(syst, 50)),
        p99_system_time=float(np.percentile(syst, 99)),
        utilization=float(serv.sum() / max(horizon, 1e-9)),
        accuracy=float(correct.mean()),
        mean_accuracy_prob=float(p_row.mean()),
        objective=float(problem.server.alpha * p_row.mean() - syst.mean()),
        per_task_budget=per_budget,
        per_task_system_time=per_sys,
        tokens_generated=int(sum(c.n_tokens for c in completed)),
        n_resolves=n_resolves,
        estimator_state=estimator_state,
        wait_percentiles=percentile_summary(waits),
        system_time_percentiles=percentile_summary(syst),
        drift=drift,
        occupancy=occupancy,
        goodput=float(correct.sum() / max(horizon, 1e-9)),
    )

"""Analytical M/G/1 prediction for the serving reports.

Only ``pk_prediction`` is ported; the heapq event-driven simulator of
``repro.queueing_sim.mg1`` waits for a later slice.
"""
from __future__ import annotations

from ..core.params import Problem, as_control
from ..core.queueing import mean_system_time, mean_wait, service_moments


def pk_prediction(problem: Problem, lengths) -> dict:
    """Pollaczek-Khinchine prediction at the budgets ``lengths``."""
    lam = problem.server.lam
    m = service_moments(problem.tasks, as_control(lengths), lam)
    return {
        "mean_wait": float(mean_wait(m, lam)),
        "mean_system_time": float(mean_system_time(m, lam)),
        "mean_service": float(m.es),
        "utilization": float(m.rho),
    }

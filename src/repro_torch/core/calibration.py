"""Fitting the accuracy and latency models from measurements (Sec IV-A).

The port of ``repro.core.calibration``, NumPy as there. The paper fits
p_k(l) = A (1 - e^{-b l}) + D to measured (budget, accuracy) points and
t_k(l) = t0 + c l to measured (budget, latency) points:

* latency: ordinary least squares (closed form);
* accuracy: separable nonlinear least squares: for a fixed curvature b
  the model is linear in (A, D), solved in closed form; b is found by
  golden section over log b. A in (0, 1], D in [0, 1), A + D <= 1 by
  clipped projection of the linear solve.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .params import TaskSet


@dataclasses.dataclass(frozen=True)
class AccuracyFit:
    A: float
    b: float
    D: float
    rmse: float


@dataclasses.dataclass(frozen=True)
class LatencyFit:
    t0: float
    c: float
    rmse: float


def fit_latency(budgets, latencies) -> LatencyFit:
    """OLS fit of t(l) = t0 + c l with c > 0, t0 >= 0 enforced by clipping."""
    x = np.asarray(budgets, dtype=np.float64)
    y = np.asarray(latencies, dtype=np.float64)
    xbar, ybar = x.mean(), y.mean()
    var = np.sum((x - xbar) ** 2)
    c = np.sum((x - xbar) * (y - ybar)) / max(var, 1e-30)
    c = max(c, 1e-9)
    t0 = max(ybar - c * xbar, 0.0)
    rmse = float(np.sqrt(np.mean((t0 + c * x - y) ** 2)))
    return LatencyFit(t0=float(t0), c=float(c), rmse=rmse)


def _linear_AD(x: np.ndarray, y: np.ndarray, b: float):
    """For fixed b, least-squares (A, D) of y = A(1-e^{-b x}) + D, projected
    onto {0 < A <= 1, 0 <= D < 1, A + D <= 1}."""
    g = 1.0 - np.exp(-b * x)
    G = np.stack([g, np.ones_like(g)], axis=1)
    sol, *_ = np.linalg.lstsq(G, y, rcond=None)
    A, D = float(sol[0]), float(sol[1])
    A = float(np.clip(A, 1e-6, 1.0))
    D = float(np.clip(D, 0.0, 1.0 - 1e-6))
    if A + D > 1.0:
        excess = A + D - 1.0
        A = max(A - excess / 2, 1e-6)
        D = max(min(D - excess / 2, 1.0 - A), 0.0)
    resid = A * g + D - y
    return A, D, float(np.sqrt(np.mean(resid ** 2)))


def fit_accuracy(budgets, accuracies, b_lo: float = 1e-6, b_hi: float = 1.0,
                 iters: int = 80) -> AccuracyFit:
    """Separable NLS: golden-section search on log b, closed form in (A, D)."""
    x = np.asarray(budgets, dtype=np.float64)
    y = np.asarray(accuracies, dtype=np.float64)

    def loss(logb):
        return _linear_AD(x, y, float(np.exp(logb)))[2]

    lo, hi = np.log(b_lo), np.log(b_hi)
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a_pt, b_pt = hi - invphi * (hi - lo), lo + invphi * (hi - lo)
    fa, fb = loss(a_pt), loss(b_pt)
    for _ in range(iters):
        if fa <= fb:
            hi, b_pt, fb = b_pt, a_pt, fa
            a_pt = hi - invphi * (hi - lo)
            fa = loss(a_pt)
        else:
            lo, a_pt, fa = a_pt, b_pt, fb
            b_pt = lo + invphi * (hi - lo)
            fb = loss(b_pt)
    b = float(np.exp((lo + hi) / 2.0))
    A, D, rmse = _linear_AD(x, y, b)
    return AccuracyFit(A=A, b=b, D=D, rmse=rmse)


def calibrate_taskset(names: Sequence[str], budget_grid, accuracy_samples,
                      latency_samples, pi=None) -> TaskSet:
    """A TaskSet from raw measurements: ``accuracy_samples`` and
    ``latency_samples`` are ``[n_tasks, n_budgets]`` measured means on the
    shared ``budget_grid``."""
    n = len(names)
    A, b, D, t0, c = (np.zeros(n) for _ in range(5))
    for k in range(n):
        af = fit_accuracy(budget_grid, accuracy_samples[k])
        lf = fit_latency(budget_grid, latency_samples[k])
        A[k], b[k], D[k], t0[k], c[k] = af.A, af.b, af.D, lf.t0, lf.c
    if pi is None:
        pi = np.full(n, 1.0 / n)
    return TaskSet(names=tuple(names), A=A, b=b, D=D, t0=t0, c=c,
                   pi=np.asarray(pi))

"""The mix's reasoning-token budgets, worked out again in plain NumPy.

The paper's problem (eq 7): maximise over budgets ``l`` in ``[0, l_max]``

    J(l) = alpha * sum_k pi_k p_k(l_k) - lam E[S^2] / (2 (1 - lam E[S])) - E[S]

with ``p_k(l) = A_k (1 - exp(-b_k l)) + D_k`` and ``S_k = t0_k + c_k l``.
J is strictly concave where ``lam E[S] < 1`` (Lemma 1), so a projected
Newton ascent from ``l = 0`` finds the continuous optimum; the integer
budgets are then the best of the 2^N floor/ceil combinations (eq 39),
the first best one in the order of the binary count.
"""
from __future__ import annotations

import numpy as np


def _arrays(mix: dict):
    t = mix["tasks"]
    A, b, D, t0, c, pi = (np.asarray(t[k], dtype=np.float64)
                          for k in ("A", "b", "D", "t0", "c", "pi"))
    p = mix["problem"]
    return A, b, D, t0, c, pi, float(p["lam"]), float(p["alpha"]), \
        float(p["l_max"])


def objective(mix: dict, l: np.ndarray) -> float:
    A, b, D, t0, c, pi, lam, alpha, _ = _arrays(mix)
    t = t0 + c * l
    es, es2 = np.sum(pi * t), np.sum(pi * t * t)
    slack = 1.0 - lam * es
    if slack <= 0:
        return -np.inf
    acc = np.sum(pi * (A * (1 - np.exp(-b * l)) + D))
    return alpha * acc - lam * es2 / (2 * slack) - es


def _grad_hess(mix: dict, l: np.ndarray):
    A, b, D, t0, c, pi, lam, alpha, _ = _arrays(mix)
    t = t0 + c * l
    es, es2 = np.sum(pi * t), np.sum(pi * t * t)
    s = 1.0 - lam * es
    pc = pi * c
    e = np.exp(-b * l)
    g = alpha * pi * A * b * e \
        - lam * pc * (t / s + lam * es2 / (2 * s * s)) - pc
    h = -(lam * np.diag(pi * c * c) / s
          + lam ** 2 * np.outer(pc, pc) * (t[:, None] + t[None, :]) / s ** 2
          + lam ** 3 * np.outer(pc, pc) * es2 / s ** 3) \
        + np.diag(-alpha * pi * A * b * b * e)
    return g, h


def continuous(mix: dict, tol: float = 1e-12, iters: int = 500):
    l_max = _arrays(mix)[-1]
    l = np.zeros(len(mix["tasks"]["A"]))
    for _ in range(iters):
        g, h = _grad_hess(mix, l)
        free = ~(((l <= 0) & (g < 0)) | ((l >= l_max) & (g > 0)))
        pg = np.where(free, g, 0.0)
        if np.max(np.abs(pg)) < tol:
            break
        d = np.zeros_like(l)
        if free.any():
            hf = h[np.ix_(free, free)]
            d[free] = -np.linalg.solve(hf, g[free])
        j0, step = objective(mix, l), 1.0
        while step > 1e-20:
            cand = np.clip(l + step * d, 0.0, l_max)
            if objective(mix, cand) >= j0:
                break
            step *= 0.5
        if np.array_equal(cand, l):
            break
        l = cand
    return l


def integer_budgets(mix: dict) -> list:
    l_star = continuous(mix)
    l_max = _arrays(mix)[-1]
    lo = np.clip(np.floor(l_star), 0, l_max)
    hi = np.clip(np.ceil(l_star), 0, l_max)
    n = len(l_star)
    best, best_j = None, -np.inf
    for code in range(2 ** n):
        cand = np.where((code >> np.arange(n)) & 1, hi, lo)
        j = objective(mix, cand)
        if j > best_j:
            best, best_j = cand, j
    return [int(x) for x in best]

"""Integer projection of the continuous optimum (Sec III-E).

* ``round_policy``      -- componentwise rounding (eq 40), O(N)
* ``exhaustive_policy`` -- floor/ceil 2^N search (eq 39), exact over the
                           floor/ceil lattice cell; the JAX package's
                           ``vmap`` over candidates is a batch dimension here
* ``coordinate_policy`` -- beyond-paper: coordinate descent over integers,
                           scalable to large N, >= rounding by construction

plus the paper's rounding-loss lower bound J_bar(l*) (eq 41), giving the
sandwich  J(l*) >= J(l_int_opt) >= J(l_int) >= J_bar(l*).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .objective import objective
from .params import Problem, as_control
from .queueing import service_moments

Tensor = torch.Tensor


class IntegerResult(NamedTuple):
    lengths: Tensor         # integer-valued allocation
    value: Tensor           # J at the allocation
    method: str


def round_policy(problem: Problem, l_star: Tensor) -> IntegerResult:
    """Componentwise rounding (eq 40), clipped to [0, l_max]."""
    l_int = torch.clamp(torch.round(l_star), 0.0, problem.server.l_max)
    return IntegerResult(l_int, objective(problem, l_int), "round")


def exhaustive_policy(problem: Problem, l_star: Tensor,
                      max_tasks: int = 20) -> IntegerResult:
    """Exact floor/ceil search (eq 39) over all 2^N combinations, evaluated
    as one ``[2^N, N]`` batch; unstable candidates score -inf."""
    n = problem.tasks.n_tasks
    if n > max_tasks:
        raise ValueError(
            f"2^{n} exhaustive search refused (> 2^{max_tasks}); "
            "use round_policy for large N")
    l_max = problem.server.l_max
    lo = torch.clamp(torch.floor(l_star), 0.0, l_max)
    hi = torch.clamp(torch.ceil(l_star), 0.0, l_max)
    bits = (torch.arange(2 ** n)[:, None] >> torch.arange(n)[None, :]) & 1
    cand = torch.where(bits == 1, hi[None, :], lo[None, :])     # [2^N, N]
    vals = objective(problem, cand)
    best = int(torch.argmax(vals))
    return IntegerResult(cand[best], vals[best], "exhaustive")


def coordinate_policy(problem: Problem, l_star: Tensor,
                      sweeps: int = 4, radius: int = 2) -> IntegerResult:
    """Beyond-paper integer refinement.

    Starting from the rounded point, sweep coordinates and test integer
    moves in {-radius..+radius}; J is concave in each coordinate so the
    1-D integer optimum lies next to the continuous one, but coupling
    through E[S], E[S^2] can shift neighbours; a few sweeps settle it.
    Runs on the host in float64 (N is small; control-plane code).
    """
    lmax = float(problem.server.l_max)
    l = np.clip(np.round(np.asarray(l_star, dtype=np.float64)), 0, lmax)
    n = l.shape[0]

    def jfun(v: np.ndarray) -> float:
        return float(objective(problem, as_control(v)))

    best_val = jfun(l)
    deltas = [d for d in range(-radius, radius + 1) if d != 0]
    for _ in range(sweeps):
        improved = False
        for k in range(n):
            for d in deltas:
                cand = l.copy()
                cand[k] = np.clip(cand[k] + d, 0, lmax)
                if cand[k] == l[k]:
                    continue
                v = jfun(cand)
                if v > best_val + 1e-12:
                    l, best_val, improved = cand, v, True
        if not improved:
            break
    return IntegerResult(as_control(l), as_control(best_val), "coordinate")


def rounding_lower_bound(problem: Problem, l_star: Tensor) -> Tensor:
    """J_bar(l*), eq (41): lower bound on the utility after rounding."""
    tasks, sp = problem.tasks, problem.server
    lam = sp.lam
    m = service_moments(tasks, l_star, lam)
    c_max = torch.max(tasks.c)
    acc = torch.sum(tasks.pi * (tasks.A * (1.0 - torch.exp(
        -tasks.b * (l_star - 1.0))) + tasks.D), dim=-1)
    denom = 1.0 - lam * (m.es + c_max)
    jbar = (sp.alpha * acc
            - (lam * m.es2 + 2.0 * c_max) / (2.0 * denom)
            - m.es)
    return torch.where(denom > 0.0, jbar, torch.full_like(jbar, -torch.inf))


def sandwich(problem: Problem, l_star: Tensor) -> dict:
    """The ordering J(l*) >= J(l_int_exh) >= J(l_round) >= ... vs J_bar."""
    l_star = as_control(np.array(l_star, dtype=np.float64))
    j_star = objective(problem, l_star)
    exh = exhaustive_policy(problem, l_star)
    rnd = round_policy(problem, l_star)
    coord = coordinate_policy(problem, l_star)
    return {
        "J_continuous": float(j_star),
        "J_int_exhaustive": float(exh.value),
        "J_int_coordinate": float(coord.value),
        "J_int_round": float(rnd.value),
        "J_bar_lower_bound": float(rounding_lower_bound(problem, l_star)),
        "l_exhaustive": exh.lengths.numpy(),
        "l_round": rnd.lengths.numpy(),
        "l_coordinate": coord.lengths.numpy(),
    }

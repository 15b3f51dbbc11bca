"""Integer projection of the continuous optimum (Sec III-E).

* ``round_policy``      -- componentwise rounding (eq 40), O(N)
* ``exhaustive_policy`` -- floor/ceil 2^N search (eq 39), exact over the
                           floor/ceil lattice cell; the JAX package's
                           ``vmap`` over candidates is a batch dimension here

plus the paper's rounding-loss lower bound J_bar(l*) (eq 41).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .objective import objective
from .params import Problem
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

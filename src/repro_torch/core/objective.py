"""The system objective J(l) (eq 7) and its analytic gradient.

J(l) = alpha * sum_k pi_k p_k(l_k)  -  lam E[S^2] / (2 (1 - lam E[S]))  -  E[S]

On the stability region {l : lam E[S(l)] < 1} the objective is strictly
concave (Lemma 1); outside it we return -inf so that line searches and
rounding searches automatically reject unstable points.
"""
from __future__ import annotations

import torch

from .params import Problem
from .queueing import service_moments, worst_case

Tensor = torch.Tensor


def objective(problem: Problem, lengths: Tensor) -> Tensor:
    """J(l), eq (7); -inf outside the stability region.

    ``lengths`` may carry leading batch axes ``[..., N]``; the result then has
    shape ``[...]`` (one objective per allocation in the batch).
    """
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    acc = torch.sum(tasks.pi * tasks.accuracy(lengths), dim=-1)
    wait = sp.lam * m.es2 / (2.0 * m.slack)
    j = sp.alpha * acc - wait - m.es
    return torch.where(m.slack > 0.0, j, torch.full_like(j, -torch.inf))


def mean_wait_grad(problem: Problem, lengths: Tensor) -> Tensor:
    """dE[W]/dl_k, eq (10); batched over leading axes of ``lengths``."""
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    t = tasks.service_time(lengths)
    slack = m.slack[..., None]
    return sp.lam * tasks.pi * tasks.c * (
        t / slack + sp.lam * m.es2[..., None] / (2.0 * slack ** 2)
    )


def grad(problem: Problem, lengths: Tensor) -> Tensor:
    """Analytic gradient of J (accuracy term eq 15 minus eq 10 minus pi_k c_k)."""
    tasks, sp = problem.tasks, problem.server
    acc_grad = sp.alpha * tasks.pi * tasks.A * tasks.b \
        * torch.exp(-tasks.b * lengths)
    return acc_grad - mean_wait_grad(problem, lengths) - tasks.pi * tasks.c


def hessian_bound_matrix(problem: Problem,
                         stability_margin: float | None = None) -> Tensor:
    """H_kj of Lemma 3 (eq 31): elementwise bound on |d2 J / dl_k dl_j|.

    Paper-faithful form (``stability_margin=None``) requires rho_max < 1
    over the whole box; otherwise returns +inf (assumption violated).
    """
    tasks, sp = problem.tasks, problem.server
    lam = sp.lam
    wc = worst_case(tasks, lam, sp.l_max, stability_margin)
    d = 1.0 - wc.rho_max
    pc = tasks.pi * tasks.c
    h = (
        lam * torch.diag(tasks.pi * tasks.c ** 2) / d
        + lam ** 2 * torch.outer(pc, pc)
        * (wc.t_max_k[:, None] + wc.t_max_k[None, :]) / d ** 2
        + lam ** 3 * torch.outer(pc, pc) * wc.es2_max / d ** 3
        + torch.diag(sp.alpha * tasks.pi * tasks.A * tasks.b ** 2)
    )
    if stability_margin is None:
        h = torch.where(wc.rho_max >= 1.0, torch.full_like(h, torch.inf), h)
    return h


def lipschitz_grad_bound(problem: Problem,
                         stability_margin: float | None = None) -> Tensor:
    """L_J = max_k sum_j H_kj (eq 32): global Lipschitz constant of grad J."""
    h = hessian_bound_matrix(problem, stability_margin)
    return torch.max(torch.sum(h, dim=1))

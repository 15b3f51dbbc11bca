"""Projected fixed-point iteration for the optimal token allocation (Sec III-B/C).

The KKT stationarity condition (eq 17) with inactive box/stability multipliers
rearranges to  l_k - L_k(l) exp(-b_k l_k) = K_k(l)  (eq 19) with

    L_k(l) = alpha A_k b_k (1 - lam E[S]) / (lam c_k^2)            (eq 20)
    K_k(l) = -t0_k/c_k - (1 - lam E[S])/(lam c_k)
             - lam E[S^2] / (2 c_k (1 - lam E[S]))                 (eq 21)

whose solution in l_k is the Lambert-W closed form (eq 22). Projecting onto
[0, l_max]^N gives the iteration (eq 24). The JAX package ran it as a
``lax.while_loop``; here it is a Python loop over float64 tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import CONTROL_DTYPE
from .lambertw import lambertw0
from .params import Problem
from .queueing import service_moments, stability_clip, worst_case

Tensor = torch.Tensor


def coefficients(problem: Problem, lengths: Tensor):
    """L_k(l) (eq 20) and K_k(l) (eq 21); batched over leading axes."""
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    slack, es2 = m.slack[..., None], m.es2[..., None]
    L = sp.alpha * tasks.A * tasks.b * slack / (sp.lam * tasks.c ** 2)
    K = (
        -tasks.t0 / tasks.c
        - slack / (sp.lam * tasks.c)
        - sp.lam * es2 / (2.0 * tasks.c * slack)
    )
    return L, K


def fixed_point_map(problem: Problem, lengths: Tensor) -> Tensor:
    """Unprojected map l_hat(l), eq (22), with the exponent of z clamped so
    exp stays finite; past log z = 690 the asymptotic W series is used."""
    tasks = problem.tasks
    L, K = coefficients(problem, lengths)
    # z = b L e^{-bK}; log z = log(bL) - bK
    logz = torch.log(tasks.b * L) - tasks.b * K
    z = torch.exp(torch.clamp(logz, max=700.0))
    w = torch.where(
        logz > 690.0,
        logz - torch.log(logz) + torch.log(logz) / logz,
        lambertw0(z),
    )
    return w / tasks.b + K


def project(lengths: Tensor, l_max: float) -> Tensor:
    return torch.clamp(lengths, 0.0, l_max)


class FPResult(NamedTuple):
    lengths: Tensor
    iterations: int
    residual: Tensor
    converged: Tensor


def solve_fixed_point(problem: Problem, l0: Tensor | None = None,
                      tol: float = 1e-8, max_iters: int = 500) -> FPResult:
    """Projected fixed-point iteration (eq 24).

    ``l0`` may carry leading batch axes (``[..., N]``): lanes that reach
    ``residual <= tol`` are frozen, and ``iterations`` is the shared loop
    counter (the max over the batch).
    """
    sp = problem.server
    tasks = problem.tasks
    if l0 is None:
        l0 = torch.zeros(tasks.n_tasks, dtype=CONTROL_DTYPE)
    # iterates must stay in the stability region: L_k(l) < 0 outside it and
    # the Lambert-W argument leaves its domain
    l = stability_clip(tasks, sp.lam,
                       project(torch.as_tensor(l0, dtype=CONTROL_DTYPE),
                               sp.l_max))
    res = torch.full(l.shape[:-1], torch.inf, dtype=CONTROL_DTYPE)
    it = 0
    while it < max_iters and bool(torch.any(res > tol)):
        active = res > tol
        l_cand = stability_clip(tasks, sp.lam,
                                project(fixed_point_map(problem, l), sp.l_max))
        l_new = torch.where(active[..., None], l_cand, l)
        res = torch.where(active, torch.amax(torch.abs(l_cand - l), dim=-1),
                          res)
        l = l_new
        it += 1
    return FPResult(lengths=l, iterations=it, residual=res,
                    converged=res <= tol)


def contraction_certificate(problem: Problem,
                            stability_margin: float | None = None) -> Tensor:
    """L_inf of Lemma 2 (eq 26). L_inf < 1 certifies contraction.

    +inf ("certificate inapplicable") when the paper-faithful form's
    assumption rho_max < 1 fails and no ``stability_margin`` is given.
    """
    tasks, sp = problem.tasks, problem.server
    lam = sp.lam
    wc = worst_case(tasks, lam, sp.l_max, stability_margin)
    d = 1.0 - wc.rho_max
    bracket = 1.0 + lam * (wc.t_max / d + lam * wc.es2_max / (2.0 * d ** 2))
    per_k = bracket / tasks.c + lam / (tasks.b * d)
    linf = torch.max(per_k) * torch.sum(tasks.pi * tasks.c)
    if stability_margin is None:
        linf = torch.where(wc.rho_max >= 1.0,
                           torch.full_like(linf, torch.inf), linf)
    return linf

"""Projected fixed-point iteration for the optimal token allocation (Sec III-B/C).

The KKT stationarity condition (eq 17) with inactive box/stability multipliers
rearranges to  l_k - L_k(l) exp(-b_k l_k) = K_k(l)  (eq 19) with

    L_k(l) = alpha A_k b_k (1 - lam E[S]) / (lam c_k^2)            (eq 20)
    K_k(l) = -t0_k/c_k - (1 - lam E[S])/(lam c_k)
             - lam E[S^2] / (2 c_k (1 - lam E[S]))                 (eq 21)

whose solution in l_k is the Lambert-W closed form (eq 22). Projecting onto
[0, l_max]^N gives the iteration (eq 24), a contraction whenever the Lemma 2
certificate L_inf < 1 (eq 26). The JAX package ran it as a
``lax.while_loop``; here it is a Python loop over float64 tensors on the
device of the problem's tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..compat import CONTROL_DTYPE
from .lambertw import lambertw0
from .params import Problem, control_like, per_task, take_cells
from .queueing import service_moments, stability_clip, worst_case

Tensor = torch.Tensor

# steps a solver loop (here and in ``pga``) takes between two host reads of
# its convergence: on the card a read drains the launch queue. A lane that
# is done is frozen, so results do not depend on it.
_SYNC_EVERY = 8


def coefficients(problem: Problem, lengths: Tensor):
    """L_k(l) (eq 20) and K_k(l) (eq 21); batched over leading axes."""
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    slack, es2 = m.slack[..., None], m.es2[..., None]
    lam = per_task(sp.lam)
    L = per_task(sp.alpha) * tasks.A * tasks.b * slack / (lam * tasks.c ** 2)
    K = (
        -tasks.t0 / tasks.c
        - slack / (lam * tasks.c)
        - lam * es2 / (2.0 * tasks.c * slack)
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


def project(lengths: Tensor, l_max) -> Tensor:
    """Clip onto [0, l_max]^N; ``l_max`` may be a tensor of cell axes."""
    if isinstance(l_max, Tensor) and l_max.ndim:
        return torch.minimum(torch.clamp(lengths, min=0.0), per_task(l_max))
    return torch.clamp(lengths, 0.0, l_max)


class FPResult(NamedTuple):
    lengths: Tensor
    iterations: Tensor      # [...] per lane
    residual: Tensor
    converged: Tensor


def solve_fixed_point(problem: Problem, l0: Tensor | None = None,
                      tol: float = 1e-8, max_iters: int = 500) -> FPResult:
    """Projected fixed-point iteration (eq 24).

    ``l0`` (and the problem's per-cell scalars) may carry leading batch
    axes ``[..., N]``: every lane iterates its own sequence and is frozen
    once its ``residual <= tol``, and ``iterations`` counts each lane's
    own steps (what the JAX package's ``vmap`` gives per lane; its shared
    loop counter is ``iterations.amax()``). Convergence is read on the
    host once every ``_SYNC_EVERY`` (8) steps. With one cell axis, the
    loop drops the frozen lanes whenever they are half of those it
    carries.
    """
    sp = problem.server
    tasks = problem.tasks
    if l0 is None:
        l0 = torch.zeros(tasks.n_tasks, dtype=CONTROL_DTYPE,
                         device=tasks.t0.device)
    # iterates must stay in the stability region: L_k(l) < 0 outside it and
    # the Lambert-W argument leaves its domain
    l = stability_clip(tasks, sp.lam,
                       project(control_like(l0, tasks.t0), sp.l_max))
    res = torch.full(l.shape[:-1], torch.inf, dtype=CONTROL_DTYPE,
                     device=l.device)
    it = torch.zeros(l.shape[:-1], dtype=torch.int64, device=l.device)
    # the loop's state: the whole batch, or once at most half of one cell
    # axis is still moving, those lanes alone (``lanes``; the others are
    # frozen, and a lane's steps read its own cell only)
    sub, lanes, l_w, res_w, it_w = problem, None, l, res, it
    steps = 0
    while steps < max_iters:
        active = res_w > tol
        n_active = int(torch.sum(active))
        if n_active == 0:
            break
        if l.ndim == 2 and n_active <= active.numel() // 2:
            if lanes is None:
                l, res, it = l_w, res_w, it_w
                lanes = torch.arange(l.shape[0], device=l.device)
            else:
                l[lanes], res[lanes], it[lanes] = l_w, res_w, it_w
            keep = torch.nonzero(active).squeeze(1)
            lanes, l_w, res_w, it_w = (x[keep] for x in (lanes, l_w, res_w,
                                                         it_w))
            sub = take_cells(problem, lanes, l.shape[0])
        for _ in range(min(_SYNC_EVERY, max_iters - steps)):
            active = res_w > tol
            l_cand = stability_clip(
                sub.tasks, sub.server.lam,
                project(fixed_point_map(sub, l_w),
                        sub.server.l_max))
            res_w = torch.where(
                active, torch.amax(torch.abs(l_cand - l_w), dim=-1), res_w)
            l_w = torch.where(active[..., None], l_cand, l_w)
            it_w = it_w + active
            steps += 1
    if lanes is None:
        l, res, it = l_w, res_w, it_w
    else:
        l[lanes], res[lanes], it[lanes] = l_w, res_w, it_w
    return FPResult(lengths=l, iterations=it, residual=res,
                    converged=res <= tol)


def contraction_certificate(problem: Problem,
                            stability_margin: float | None = None) -> Tensor:
    """L_inf of Lemma 2 (eq 26). L_inf < 1 certifies contraction.

    +inf ("certificate inapplicable") when the paper-faithful form's
    assumption rho_max < 1 fails and no ``stability_margin`` is given.
    Per-cell scalars with cell axes give one certificate per cell.
    """
    tasks, sp = problem.tasks, problem.server
    lam = sp.lam
    wc = worst_case(tasks, lam, sp.l_max, stability_margin)
    d = 1.0 - wc.rho_max
    bracket = 1.0 + lam * (wc.t_max / d + lam * wc.es2_max / (2.0 * d ** 2))
    per_k = per_task(bracket) / tasks.c \
        + per_task(lam) / (tasks.b * per_task(d))
    linf = torch.amax(per_k, dim=-1) * torch.sum(tasks.pi * tasks.c, dim=-1)
    if stability_margin is None:
        linf = torch.where(wc.rho_max >= 1.0,
                           torch.full_like(linf, torch.inf), linf)
    return linf


def empirical_contraction_estimate(problem: Problem, n_samples: int = 64,
                                   seed: int = 0,
                                   margin: float = 5e-2) -> Tensor:
    """Beyond paper: sampled sup of ||Jacobian of l_hat||_inf over the slab.

    The analytic certificate (eq 26) is vacuous: L_inf >= 1 + lam (...) > 1
    on every instance, yet the fixed point contracts on typical ones. This
    estimates the actual modulus from ``torch.func.jacfwd`` of
    :func:`fixed_point_map` at points drawn from ``np.random.default_rng
    (seed)`` as the JAX package draws them, clipped into the slab.
    """
    rng = np.random.default_rng(seed)
    tasks, sp = problem.tasks, problem.server
    jac_fn = torch.func.jacfwd(lambda v: fixed_point_map(problem, v))
    hi = min(sp.l_max, 4.0 / float(torch.min(tasks.b)))
    worst = 0.0
    for _ in range(n_samples):
        l = rng.uniform(0, hi, size=tasks.n_tasks)
        lc = stability_clip(tasks, sp.lam, control_like(l, tasks.t0), margin)
        jac = jac_fn(lc)
        worst = max(worst, float(torch.amax(torch.sum(torch.abs(jac),
                                                      dim=1))))
    return control_like(worst, tasks.t0)


def jacobian_bound_matrix(problem: Problem,
                          stability_margin: float | None = None) -> Tensor:
    """Elementwise bound |d l_hat_k / d l_j| of Lemma 2 (eq 25)."""
    tasks, sp = problem.tasks, problem.server
    lam = sp.lam
    wc = worst_case(tasks, lam, sp.l_max, stability_margin)
    d = 1.0 - wc.rho_max
    pjcj = tasks.pi * tasks.c                       # [N] over j
    bracket = 1.0 + lam * wc.t_max / d + lam ** 2 * wc.es2_max / (2.0 * d ** 2)
    term1 = (pjcj[None, :] / tasks.c[:, None]) * bracket
    term2 = lam * pjcj[None, :] / (tasks.b[:, None] * d)
    bound = term1 + term2
    if stability_margin is None:
        bound = torch.where(wc.rho_max >= 1.0,
                            torch.full_like(bound, torch.inf), bound)
    return bound

"""Projected gradient ascent with the global step-size bound (Sec III-D).

PGA:  l^{n+1} = P_{[0,l_max]^N} ( l^n + eta * grad J(l^n) )          (eq 29)

converges to the unique optimum for any 0 < eta < 2 / L_J (eq 30, 38) where
L_J = max_k sum_j H_kj (Lemma 3) bounds ||hess J||_inf on the feasible box.

We also provide a backtracking variant (beyond paper) that adapts the step
when the conservative global bound makes progress slow, while guarding the
stability constraint lam E[S] < 1 explicitly; the allocator's fallback and
``sweeps.solve_grid`` use it. The JAX package's nested ``lax.while_loop``s
are Python loops here, over every lane of a batch at once: a lane that is
done is frozen (its iterate, step and count stay put), which is what the
JAX package's ``vmap`` of the loops does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import CONTROL_DTYPE
from .fixed_point import _SYNC_EVERY, project
from .objective import grad, lipschitz_grad_bound, objective
from .params import Problem, control_like, per_task
from .queueing import stability_clip

Tensor = torch.Tensor

# Feasible-slab margin used when the paper's whole-box Lemma 3 constant is
# inapplicable (rho_max >= 1): iterates are clipped into
# {lam E[S] <= 1 - margin} and the restricted constant certifies the step.
_SLAB_MARGIN = 5e-2


class PGAResult(NamedTuple):
    lengths: Tensor
    iterations: Tensor      # [...] per lane
    grad_norm: Tensor
    converged: Tensor
    eta: Tensor


def safe_step_size(problem: Problem, safety: float = 0.5) -> Tensor:
    """eta = safety * 2 / L_J  (eq 38), with the slab-restricted L_J when
    the whole-box constant is infinite."""
    lj = lipschitz_grad_bound(problem)
    lj = torch.where(torch.isfinite(lj), lj,
                     lipschitz_grad_bound(problem, _SLAB_MARGIN))
    return safety * 2.0 / lj


def _stability_clip(problem: Problem, lengths: Tensor,
                    margin: float = _SLAB_MARGIN, c_servers=1) -> Tensor:
    return stability_clip(problem.tasks, problem.server.lam, lengths, margin,
                          c_servers)


def _start(problem: Problem, l0, margin: float, c_servers=1) -> Tensor:
    """``l0`` (zeros by default) on the problem's device, projected onto
    the box and clipped into the slab."""
    tasks = problem.tasks
    if l0 is None:
        l0 = torch.zeros(tasks.n_tasks, dtype=CONTROL_DTYPE,
                         device=tasks.t0.device)
    return _stability_clip(problem,
                           project(control_like(l0, tasks.t0),
                                   problem.server.l_max),
                           margin, c_servers)


def solve_pga(problem: Problem, l0: Tensor | None = None,
              eta: float | None = None, tol: float = 1e-9,
              max_iters: int = 200_000,
              margin: float = _SLAB_MARGIN) -> PGAResult:
    """Projected gradient ascent (eq 29) with eta < 2/L_J by default.

    Convergence is declared on the projected-gradient residual
    ||P(l + eta g) - l||_inf / eta <= tol. ``margin`` is the stability
    slab the iterates are kept in (the guaranteed step shrinks with it:
    L_J grows like 1/margin^3).

    ``l0`` may carry leading batch axes (``[..., N]``): each lane runs its
    own ascent and is frozen once converged; ``iterations``,
    ``grad_norm`` and ``converged`` have the leading shape ``[...]``
    (the JAX package's shared counter is ``iterations.amax()``).
    Convergence is read on the host once every ``_SYNC_EVERY``
    steps.
    """
    l = _start(problem, l0, margin)
    eta_v = control_like(eta if eta is not None
                         else safe_step_size(problem), l)
    res = torch.full(l.shape[:-1], torch.inf, dtype=CONTROL_DTYPE,
                     device=l.device)
    it = torch.zeros(l.shape[:-1], dtype=torch.int64, device=l.device)
    steps = 0
    while steps < max_iters and bool(torch.any(res > tol)):
        for _ in range(min(_SYNC_EVERY, max_iters - steps)):
            active = res > tol
            g = grad(problem, l)
            l_cand = _stability_clip(
                problem,
                project(l + per_task(eta_v) * g, problem.server.l_max),
                margin)
            l_new = torch.where(active[..., None], l_cand, l)
            res = torch.where(
                active, torch.amax(torch.abs(l_cand - l), dim=-1) / eta_v,
                res)
            it += active
            l = l_new
            steps += 1
    return PGAResult(lengths=l, iterations=it, grad_norm=res,
                     converged=res <= tol, eta=eta_v)


def solve_pga_backtracking(problem: Problem, l0: Tensor | None = None,
                           tol: float = 1e-9, max_iters=20_000,
                           eta0: float | None = None,
                           shrink: float = 0.5,
                           grow: float = 1.3,
                           objective_fn=None, grad_fn=None,
                           c_servers=1) -> PGAResult:
    """Beyond-paper: Armijo-backtracking PGA.

    The global bound 2/L_J is extremely conservative where the worst-case
    moments (l = l_max everywhere) are far from the optimum; the adaptive
    step converges orders of magnitude faster and keeps the monotone
    ascent.

    ``l0`` and the problem's per-cell scalars may carry leading axes
    ``[..., N]``: every lane has its own step, iteration count and
    backtracking, and a lane that is done is frozen whole (its step does
    not grow). ``max_iters`` is an int or a ``[...]`` tensor of per-lane
    budgets; a lane with budget 0 returns its clipped ``l0`` after no
    iteration. ``objective_fn`` / ``grad_fn`` (signature ``(problem,
    lengths)``, leading axes allowed) default to the paper's P-K
    objective; the M/G/c grid passes ``core.mgc.objective_mgc`` closures
    and the matching ``c_servers``, so iterates are clipped into the
    c-server slab lam E[S] < c. The outer loop reads convergence on the
    host once every ``_SYNC_EVERY`` iterations; each backtracking
    try reads whether any lane still needs one.
    """
    if objective_fn is None:
        objective_fn = objective
    if grad_fn is None:
        grad_fn = grad
    l_max = problem.server.l_max
    # backtracking needs only a domain guard, not the slab certificate
    guard = 1e-6
    l = _start(problem, l0, guard, c_servers)
    lanes = l.shape[:-1]
    eta_v = control_like(eta0 if eta0 is not None
                         else 100.0 * safe_step_size(problem), l)
    eta_v = eta_v.expand(lanes).clone()
    budget = torch.as_tensor(max_iters, device=l.device).expand(lanes)
    res = torch.full(lanes, torch.inf, dtype=CONTROL_DTYPE, device=l.device)
    it = torch.zeros(lanes, dtype=torch.int64, device=l.device)

    def try_step(l, g, j0, eta_try):
        cand = _stability_clip(problem,
                               project(l + eta_try[..., None] * g, l_max),
                               guard, c_servers)
        # Armijo w.r.t. the projected step direction
        dec = torch.sum(g * (cand - l), dim=-1)
        return cand, objective_fn(problem, cand) >= j0 + 1e-4 * dec

    while bool(torch.any((it < budget) & (res > tol))):
        for _ in range(_SYNC_EVERY):
            active = (it < budget) & (res > tol)
            g = grad_fn(problem, l)
            j0 = objective_fn(problem, l)
            eta_f = eta_v
            cand, ok = try_step(l, g, j0, eta_f)
            tries = torch.zeros_like(it)
            while True:
                shrinking = active & ~ok & (tries < 60)
                if not bool(torch.any(shrinking)):
                    break
                eta_f = torch.where(shrinking, eta_f * shrink, eta_f)
                cand_s, ok_s = try_step(l, g, j0, eta_f)
                cand = torch.where(shrinking[..., None], cand_s, cand)
                ok = torch.where(shrinking, ok_s, ok)
                tries += shrinking
            res_new = torch.amax(torch.abs(cand - l), dim=-1) \
                / torch.clamp(eta_f, min=1e-30)
            l = torch.where(active[..., None], cand, l)
            eta_v = torch.where(active, eta_f * grow, eta_v)
            res = torch.where(active, res_new, res)
            it += active
    return PGAResult(lengths=l, iterations=it, grad_norm=res,
                     converged=res <= tol, eta=eta_v)

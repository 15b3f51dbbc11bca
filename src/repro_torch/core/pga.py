"""Projected gradient ascent with the global step-size bound (Sec III-D).

PGA:  l^{n+1} = P_{[0,l_max]^N} ( l^n + eta * grad J(l^n) )          (eq 29)

converges for any 0 < eta < 2 / L_J (eq 30, 38). The allocator's fallback
is the Armijo-backtracking variant (beyond paper), which adapts the step
when the conservative global bound makes progress slow while guarding the
stability constraint lam E[S] < 1. The JAX package's nested
``lax.while_loop``s are Python loops here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..compat import CONTROL_DTYPE
from .fixed_point import project
from .objective import grad, lipschitz_grad_bound, objective
from .params import Problem
from .queueing import stability_clip

Tensor = torch.Tensor

# Feasible-slab margin used when the paper's whole-box Lemma 3 constant is
# inapplicable (rho_max >= 1).
_SLAB_MARGIN = 5e-2


class PGAResult(NamedTuple):
    lengths: Tensor
    iterations: int
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


def solve_pga_backtracking(problem: Problem, l0: Tensor | None = None,
                           tol: float = 1e-9, max_iters: int = 20_000,
                           eta0: float | None = None,
                           shrink: float = 0.5,
                           grow: float = 1.3) -> PGAResult:
    """Armijo-backtracking PGA (beyond paper), scalar per problem."""
    sp = problem.server
    if l0 is None:
        l0 = torch.zeros(problem.tasks.n_tasks, dtype=CONTROL_DTYPE)
    # backtracking needs only a domain guard, not the slab certificate
    guard = 1e-6
    l = _stability_clip(problem,
                        project(torch.as_tensor(l0, dtype=CONTROL_DTYPE),
                                sp.l_max), guard)
    eta_v = torch.as_tensor(eta0 if eta0 is not None
                            else 100.0 * safe_step_size(problem),
                            dtype=CONTROL_DTYPE)
    res = torch.tensor(torch.inf, dtype=CONTROL_DTYPE)
    it = 0
    while it < max_iters and bool(res > tol):
        g = grad(problem, l)
        j0 = objective(problem, l)

        def try_step(eta_try):
            cand = _stability_clip(problem, project(l + eta_try * g, sp.l_max),
                                   guard)
            # Armijo w.r.t. the projected step direction
            dec = torch.sum(g * (cand - l))
            ok = bool(objective(problem, cand) >= j0 + 1e-4 * dec)
            return cand, ok

        eta_f = eta_v
        cand, ok = try_step(eta_f)
        tries = 0
        while not ok and tries < 60:
            eta_f = eta_f * shrink
            cand, ok = try_step(eta_f)
            tries += 1
        res = torch.amax(torch.abs(cand - l)) / torch.clamp(eta_f, min=1e-30)
        l = cand
        eta_v = eta_f * grow
        it += 1
    return PGAResult(lengths=l, iterations=it, grad_norm=res,
                     converged=res <= tol, eta=eta_v)

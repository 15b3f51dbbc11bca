"""TokenBudgetAllocator — the paper's technique as a first-class feature.

Facade consumed by the serving scheduler (``repro_torch.serving``): given a
calibrated :class:`Problem`, it solves for the optimal per-task integer
reasoning-token budgets via the projected fixed-point iteration (eq 24),
falling back to PGA (eq 29) when the fixed point stalls, then projects to
integers (Sec III-E).

Beyond the paper it supports *online* operation: the arrival rate lambda and
the type mixture pi are re-estimated from the live request stream (EWMA) and
the allocation is re-solved when the operating point drifts.

Everything here runs on the host in float64 tensors: N ~ 10 control
variables, where the JAX package needed ``enable_x64`` to get there.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Mapping

import numpy as np
import torch

from . import fixed_point, integer, pga
from .objective import grad, objective
from .params import Problem, ServerParams, TaskSet, as_control
from .queueing import mean_wait, service_moments


@dataclasses.dataclass
class Solution:
    lengths_cont: np.ndarray     # continuous optimum l*
    lengths_int: np.ndarray      # implemented integer budgets
    value_cont: float            # J(l*)
    value_int: float             # J(l_int)
    value_lower_bound: float     # J_bar(l*), eq (41)
    method: str                  # "fixed_point" | "fixed_point+pga" (+"+slo")
    iterations: int
    contraction_Linf: float      # Lemma 2 certificate (paper form; +inf when
                                 # its rho_max < 1 assumption fails)
    contraction_Linf_slab: float  # slab-restricted variant (beyond paper)
    stable: bool
    slo_satisfied: bool = True   # per-task delay SLOs met (True when none)


def solve(problem: Problem, tol: float = 1e-8,
          integer_method: str = "exhaustive",
          delay_slo=None) -> Solution:
    """Full solve: FP -> (PGA fallback) -> integer projection.

    ``integer_method``: ``"exhaustive"`` (the floor/ceil search of eq 39,
    up to N = 16 task types, rounding beyond), ``"coordinate"`` (integer
    coordinate descent from the rounded point) or anything else for
    componentwise rounding (eq 40), as in the JAX package.

    ``delay_slo`` (optional ``[N]`` seconds) adds per-task mean-delay SLOs
    E[W] + t_k(l_k) <= slo_k by projection (:func:`_project_slo`).
    """
    sol = _solve(problem, tol, integer_method)
    if delay_slo is None:
        return sol
    return _project_slo(problem, sol, delay_slo)


def _solve(problem: Problem, tol: float, integer_method: str) -> Solution:
    problem.validate()
    fp = fixed_point.solve_fixed_point(problem, tol=tol)
    method = "fixed_point"
    iters = int(fp.iterations)
    lengths = fp.lengths
    # Accept the FP answer only if it is a KKT point: converged AND the
    # projected gradient residual is small (the FP map can cycle when the
    # Lemma 2 certificate fails).
    ok = bool(fp.converged)
    if ok:
        g = grad(problem, lengths)
        # KKT: g ~ 0 on interior coords, g <= 0 at 0, g >= 0 at l_max
        interior = (lengths > 0) & (lengths < problem.server.l_max)
        resid = torch.max(torch.where(
            interior, torch.abs(g),
            torch.where(lengths <= 0, torch.clamp(g, min=0),
                        torch.clamp(-g, min=0))))
        ok = bool(resid < 1e-4 * (1.0 + float(torch.max(torch.abs(g)))))
    if not ok:
        pg = pga.solve_pga_backtracking(problem, l0=lengths, tol=tol)
        lengths = pg.lengths
        iters += int(pg.iterations)
        method = "fixed_point+pga"

    if integer_method == "exhaustive" and problem.tasks.n_tasks <= 16:
        ir = integer.exhaustive_policy(problem, lengths)
    elif integer_method == "coordinate":
        ir = integer.coordinate_policy(problem, lengths)
    else:
        ir = integer.round_policy(problem, lengths)

    return Solution(
        lengths_cont=lengths.numpy().astype(np.float64),
        lengths_int=ir.lengths.numpy().astype(np.float64),
        value_cont=float(objective(problem, lengths)),
        value_int=float(ir.value),
        value_lower_bound=float(integer.rounding_lower_bound(problem, lengths)),
        method=method,
        iterations=iters,
        contraction_Linf=float(fixed_point.contraction_certificate(problem)),
        contraction_Linf_slab=float(
            fixed_point.contraction_certificate(problem, 5e-2)),
        stable=bool(torch.isfinite(ir.value)),
    )


def _wait(problem: Problem, lengths) -> float:
    sp = problem.server
    return float(mean_wait(service_moments(problem.tasks, as_control(lengths),
                                           sp.lam), sp.lam))


def _project_slo(problem: Problem, sol: Solution, delay_slo,
                 max_rounds: int = 32) -> Solution:
    """Project a solved allocation onto the per-task delay-SLO feasible set.

    The constraint E[W(l)] + t0_k + c_k l_k <= slo_k caps each l_k; capping
    only lowers E[W], so alternating "evaluate W -> cap" converges
    monotonically from the unconstrained optimum. The integer point is then
    tightened against caps recomputed at the integer point itself.
    """
    tasks, sp = problem.tasks, problem.server
    slo = np.asarray(delay_slo, dtype=np.float64)
    t0 = tasks.t0.numpy()
    cc = tasks.c.numpy()
    l = np.asarray(sol.lengths_cont, dtype=np.float64).copy()
    caps = np.full_like(l, sp.l_max)
    for _ in range(max_rounds):
        w = _wait(problem, l)
        caps = np.clip((slo - w - t0) / cc, 0.0, sp.l_max)
        l_new = np.minimum(l, caps)
        moved = float(np.max(np.abs(l_new - l)))
        l = l_new
        if moved < 1e-9:
            break
    l_int = np.clip(np.minimum(np.asarray(sol.lengths_int),
                               np.floor(caps + 1e-12)), 0.0, sp.l_max)
    for _ in range(max_rounds):
        w_int = _wait(problem, l_int)
        if np.all(w_int + t0 + cc * l_int <= slo + 1e-6) or not l_int.any():
            break
        caps_int = np.floor(np.clip((slo - w_int - t0) / cc,
                                    0.0, sp.l_max) + 1e-12)
        tightened = np.minimum(l_int, caps_int)
        if np.array_equal(tightened, l_int):
            break
        l_int = tightened
    m_int = service_moments(tasks, as_control(l_int), sp.lam)
    sys_int = float(mean_wait(m_int, sp.lam)) + t0 + cc * l_int
    satisfied = bool(np.all(sys_int <= slo + 1e-6) and float(m_int.rho) < 1.0)
    return dataclasses.replace(
        sol,
        lengths_cont=l,
        lengths_int=l_int,
        value_cont=float(objective(problem, as_control(l))),
        value_int=float(objective(problem, as_control(l_int))),
        method=sol.method + "+slo",
        slo_satisfied=satisfied,
    )


class TokenBudgetAllocator:
    """Online queueing-aware budget allocator.

    Thread-safe: the serving scheduler calls :meth:`budget_for` on the hot
    path and :meth:`observe_arrival` per admission; re-solves happen inline
    when drift exceeds ``resolve_rel_tol``.
    """

    def __init__(self, problem: Problem, *, ewma_halflife: float = 200.0,
                 resolve_rel_tol: float = 0.05,
                 min_resolve_interval: int = 200,
                 delay_slo=None):
        problem.validate()
        self._base = problem
        self._delay_slo = (None if delay_slo is None
                           else np.asarray(delay_slo, dtype=np.float64))
        self._lock = threading.Lock()
        self._ewma_decay = math.log(2.0) / ewma_halflife
        self._lam_est = problem.server.lam
        # EWMA of inter-arrival GAPS; lambda is estimated as 1 / gap_est
        # (the reciprocal-gap average is divergent under exponential gaps)
        self._gap_est = 1.0 / problem.server.lam
        self._pi_est = problem.tasks.pi.numpy().astype(np.float64).copy()
        self._last_arrival_t: float | None = None
        self._n_observed = 0
        self._resolve_rel_tol = resolve_rel_tol
        self._min_resolve_interval = min_resolve_interval
        self._arrivals_since_resolve = 0
        self._solution = solve(problem, delay_slo=self._delay_slo)
        self._solved_at = (self._lam_est, self._pi_est.copy())
        self.n_resolves = 1

    # ------------------------------------------------------------- queries
    @property
    def solution(self) -> Solution:
        return self._solution

    def budget_for(self, task_index: int) -> int:
        return int(self._solution.lengths_int[task_index])

    def budgets(self) -> Mapping[str, int]:
        names = self._base.tasks.names
        return {n: int(v) for n, v in zip(names, self._solution.lengths_int)}

    # ------------------------------------------------------------ learning
    def observe_arrival(self, task_index: int, t_now: float) -> None:
        """EWMA update of (lambda, pi) from the live stream; maybe re-solve."""
        with self._lock:
            if self._last_arrival_t is not None:
                gap = max(t_now - self._last_arrival_t, 0.0)
                w = 1.0 - math.exp(-self._ewma_decay)
                self._gap_est = (1 - w) * self._gap_est + w * gap
                self._lam_est = 1.0 / max(self._gap_est, 1e-12)
                onehot = np.zeros_like(self._pi_est)
                onehot[task_index] = 1.0
                self._pi_est = (1 - w) * self._pi_est + w * onehot
                self._pi_est /= self._pi_est.sum()
            self._last_arrival_t = t_now
            self._n_observed += 1
            self._arrivals_since_resolve += 1
            self._maybe_resolve()

    def estimator_state(self) -> dict:
        """Snapshot of the online estimates (exposed via ``ServingReport``)."""
        with self._lock:
            return {
                "lam": float(self._lam_est),
                "gap": float(self._gap_est),
                "pi": [float(p) for p in self._pi_est],
                "n_arrivals": int(self._n_observed),
                "n_resolves": int(self.n_resolves),
            }

    def _maybe_resolve(self) -> None:
        if self._arrivals_since_resolve < self._min_resolve_interval:
            return
        lam0, pi0 = self._solved_at
        drift = abs(self._lam_est - lam0) / max(lam0, 1e-9)
        drift = max(drift, float(np.max(np.abs(self._pi_est - pi0))))
        if drift < self._resolve_rel_tol:
            return
        self._arrivals_since_resolve = 0
        tasks = self._base.tasks
        new_tasks = TaskSet(names=tasks.names, A=tasks.A, b=tasks.b,
                            D=tasks.D, t0=tasks.t0, c=tasks.c,
                            pi=self._pi_est)
        sp = self._base.server
        # keep the re-solve feasible: cap lambda below the zero-token
        # stability limit (an overloaded M/G/1 has no finite optimum)
        es0 = float(np.sum(self._pi_est * tasks.t0.numpy()))
        lam = min(self._lam_est, 0.95 / max(es0, 1e-9))
        new_problem = Problem(tasks=new_tasks,
                              server=ServerParams(lam, sp.alpha, sp.l_max))
        self._solution = solve(new_problem, delay_slo=self._delay_slo)
        self._solved_at = (lam, self._pi_est.copy())
        self.n_resolves += 1

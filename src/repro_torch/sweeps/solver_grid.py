"""Solver grids: the paper's optimum over whole operating grids in one pass.

The scalar facade (``core.allocator.solve``) solves one ``(lambda, alpha,
l_max)`` cell per call. This module runs the *same* per-cell pipeline
(projected fixed point, eq 24 -> KKT check, eq 17 -> PGA-backtracking
fallback, eq 29 -> floor/ceil integer search, eq 39) over a flat ``[C]``
cell axis at once: every per-cell scalar is a ``[C]`` tensor that
broadcasts through ``core`` against ``[C, N]`` budgets, where the JAX
package ran ``jax.jit(jax.vmap(cell))``. The loops freeze each finished
lane whole and count iterations per lane, which is what ``vmap`` of the
JAX package's ``lax.while_loop``s does, so per-cell results agree with
the scalar path and with the JAX grid.

The grid runs in float64 on the card by default (``device``), the host
reading convergence once every 8 iterations; ``device="cpu"`` runs it
here. Grid axes: ``lam`` / ``alpha`` / ``l_max``
/ ``c`` (broadcast against each other) plus optional multiplicative
*calibration perturbations* of the ``TaskSet`` fields (A, b, D, t0, c).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..compat import CONTROL_DTYPE, DEFAULT_DEVICE, resolve_device
from ..core import allocator, fixed_point, integer, pga
from ..core.mgc import mean_wait_mgc, objective_mgc
from ..core.objective import grad, objective
from ..core.params import Problem, ServerParams, TaskSet, per_task
from ..core.queueing import mean_system_time, service_moments

__all__ = ["GridSolution", "TaskArrays", "solve_grid", "solve_grid_flat",
           "reference_check"]

Tensor = torch.Tensor

# Calibration-perturbation fields accepted by ``solve_grid(calib=...)``.
_CALIB_FIELDS = ("A", "b", "D", "t0", "c")


class TaskArrays(NamedTuple):
    """Device-resident mirror of :class:`~repro_torch.core.params.TaskSet`.

    ``TaskSet`` holds host tensors of shape ``[N]``; this keeps the
    attribute API the solvers consume (``A``/``b``/``D``/``t0``/``c``/
    ``pi``, ``n_tasks``, ``accuracy``, ``service_time``) over tensors on
    any device, ``[N]`` or ``[C, N]`` once perturbed per cell.
    """

    A: Tensor
    b: Tensor
    D: Tensor
    t0: Tensor
    c: Tensor
    pi: Tensor

    @property
    def n_tasks(self) -> int:
        return int(self.A.shape[-1])

    def accuracy(self, lengths):
        """p_k(l_k), eq (2)."""
        return self.A * (1.0 - torch.exp(-self.b * lengths)) + self.D

    def service_time(self, lengths):
        """t_k(l_k), eq (1)."""
        return self.t0 + self.c * lengths

    @classmethod
    def from_taskset(cls, tasks: TaskSet, device="cpu") -> "TaskArrays":
        return cls(*(torch.as_tensor(getattr(tasks, f), dtype=CONTROL_DTYPE,
                                     device=device)
                     for f in ("A", "b", "D", "t0", "c", "pi")))


class _CalibScales(NamedTuple):
    """Per-cell multiplicative perturbations of the TaskSet fields."""

    A: Tensor
    b: Tensor
    D: Tensor
    t0: Tensor
    c: Tensor


@dataclasses.dataclass(frozen=True)
class GridSolution:
    """Solved operating grid; every array is shaped ``grid_shape`` (+ ``[N]``
    for per-task fields), host NumPy."""

    # operating grid (broadcast)
    lam: np.ndarray
    alpha: np.ndarray
    l_max: np.ndarray
    c: np.ndarray                   # servers per cell (1 = paper's M/G/1)
    # continuous optimum (eq 24 / eq 29)
    lengths_cont: np.ndarray        # [..., N]
    value_cont: np.ndarray
    # integer projection (eq 39 / eq 40) + eq 41 sandwich bound
    lengths_int: np.ndarray         # [..., N]
    value_int: np.ndarray
    value_lower_bound: np.ndarray
    # solver diagnostics, per cell
    fp_iterations: np.ndarray
    fp_converged: np.ndarray
    fp_residual: np.ndarray
    kkt_residual: np.ndarray
    used_pga: np.ndarray
    pga_iterations: np.ndarray
    # Lemma 2 certificate (eq 26), paper box form + feasible-slab variant
    contraction_Linf: np.ndarray
    contraction_Linf_slab: np.ndarray
    # stability / feasibility
    rho_cont: np.ndarray            # lam E[S(l*)]
    rho_int: np.ndarray             # lam E[S(l_int)]
    feasible: np.ndarray            # lam E[S(0)] < c (problem well-posed)
    stable: np.ndarray              # feasible & rho_int < c & finite J
    # analytic operating curves at the optimum (for frontiers)
    accuracy_cont: np.ndarray       # sum_k pi_k p_k(l*_k)
    accuracy_int: np.ndarray
    system_time_cont: np.ndarray    # P-K E[T_sys] (eq 6) at l*
    system_time_int: np.ndarray

    @property
    def shape(self) -> tuple:
        return self.lam.shape

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.lam.shape, dtype=np.int64)) if self.lam.shape \
            else 1

    def ravel(self) -> "GridSolution":
        """Flatten all grid axes to one cell axis (per-task axis kept)."""
        def _flat(x: np.ndarray) -> np.ndarray:
            extra = x.shape[len(self.shape):]
            return x.reshape((-1,) + extra)
        return GridSolution(**{f.name: _flat(getattr(self, f.name))
                               for f in dataclasses.fields(self)})

    def cell(self, idx) -> dict:
        """One grid cell as a plain dict (host scalars / [N] arrays)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)[idx]
            out[f.name] = v if isinstance(v, np.ndarray) and v.ndim else \
                v.item() if isinstance(v, np.ndarray) else v
        return out


def _cells_problem(base: TaskArrays, lam, alpha, l_max,
                   scales: _CalibScales) -> Problem:
    """The ``[C]`` cells as one problem: ``[C, N]`` perturbed task arrays
    and ``[C]`` server scalars."""
    ta = base._replace(**{f: getattr(base, f) * getattr(scales, f)[:, None]
                          for f in _CALIB_FIELDS})
    return Problem(tasks=ta, server=ServerParams(lam, alpha, l_max))


def _kkt(lengths: Tensor, g: Tensor, l_max: Tensor) -> Tensor:
    """KKT residual of the scalar facade: g ~ 0 on interior coords,
    g <= 0 at 0, g >= 0 at l_max."""
    interior = (lengths > 0) & (lengths < per_task(l_max))
    return torch.amax(torch.where(
        interior, torch.abs(g),
        torch.where(lengths <= 0, torch.clamp(g, min=0),
                    torch.clamp(-g, min=0))), dim=-1)


def _integer(prob: Problem, lengths: Tensor, integer_method: str,
             objective_fn=None):
    if integer_method == "exhaustive":
        return integer.exhaustive_policy(prob, lengths,
                                         objective_fn=objective_fn)
    return integer.round_policy(prob, lengths, objective_fn=objective_fn)


def _solve_cells(base: TaskArrays, lam, alpha, l_max, scales: _CalibScales,
                 tol: float, max_fp_iters: int, max_pga_iters: int,
                 integer_method: str) -> dict:
    """``[C]`` M/G/1 cells: the pipeline of ``core.allocator._solve`` with
    every lane's budget for the PGA fallback its own (0 where the fixed
    point was accepted)."""
    prob = _cells_problem(base, lam, alpha, l_max, scales)
    ta = prob.tasks
    feasible = lam * torch.sum(ta.pi * ta.t0, dim=-1) < 1.0

    fp = fixed_point.solve_fixed_point(prob, tol=tol, max_iters=max_fp_iters)
    g = grad(prob, fp.lengths)
    kkt = _kkt(fp.lengths, g, l_max)
    ok = fp.converged & (kkt < 1e-4 * (1.0 + torch.amax(torch.abs(g),
                                                         dim=-1)))
    need_pga = (~ok) & feasible
    pg = pga.solve_pga_backtracking(
        prob, l0=fp.lengths, tol=tol,
        max_iters=torch.where(need_pga, max_pga_iters, 0))
    lengths = torch.where(ok[:, None], fp.lengths, pg.lengths)
    ir = _integer(prob, lengths, integer_method)

    m_cont = service_moments(ta, lengths, lam)
    m_int = service_moments(ta, ir.lengths, lam)
    return {
        "lengths_cont": lengths,
        "value_cont": objective(prob, lengths),
        "lengths_int": ir.lengths,
        "value_int": ir.value,
        "value_lower_bound": integer.rounding_lower_bound(prob, lengths),
        "fp_iterations": fp.iterations,
        "fp_converged": fp.converged,
        "fp_residual": fp.residual,
        "kkt_residual": kkt,
        "used_pga": need_pga,
        "pga_iterations": pg.iterations,
        "contraction_Linf": fixed_point.contraction_certificate(prob),
        "contraction_Linf_slab":
            fixed_point.contraction_certificate(prob, 5e-2),
        "rho_cont": m_cont.rho,
        "rho_int": m_int.rho,
        "feasible": feasible,
        "stable": feasible & (m_int.rho < 1.0) & torch.isfinite(ir.value),
        "accuracy_cont": torch.sum(ta.pi * ta.accuracy(lengths), dim=-1),
        "accuracy_int": torch.sum(ta.pi * ta.accuracy(ir.lengths), dim=-1),
        "system_time_cont": mean_system_time(m_cont, lam),
        "system_time_int": mean_system_time(m_int, lam),
    }


def _solve_cells_mgc(base: TaskArrays, lam, alpha, l_max, c,
                     scales: _CalibScales, tol: float, max_pga_iters: int,
                     integer_method: str, c_max: int) -> dict:
    """``[C]`` M/G/c cells: PGA on the Lee-Longton objective.

    The Lambert-W fixed point (eq 24) is P-K-specific, so c-grids solve
    every cell, c = 1 lanes included, through the Armijo-backtracking PGA
    with the autograd gradient of ``core.mgc.objective_mgc`` (one
    backward pass of the sum over cells: the cells are independent),
    iterates clipped into the c-server slab. Same fields as
    :func:`_solve_cells`; the fp_* diagnostics are inert, and the eq 41
    bound and Lemma 2 certificates are reported on c = 1 lanes only.
    """
    prob = _cells_problem(base, lam, alpha, l_max, scales)
    ta = prob.tasks
    feasible = lam * torch.sum(ta.pi * ta.t0, dim=-1) < c

    def obj_fn(p, lengths):
        return objective_mgc(p, lengths, c, c_max)

    def grad_fn(p, lengths):
        v = lengths.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(torch.sum(obj_fn(p, v)), v)[0]

    pg = pga.solve_pga_backtracking(
        prob, tol=tol, max_iters=torch.where(feasible, max_pga_iters, 0),
        eta0=1e3, objective_fn=obj_fn, grad_fn=grad_fn, c_servers=c)
    lengths = pg.lengths
    kkt = _kkt(lengths, grad_fn(prob, lengths), l_max)
    ir = _integer(prob, lengths, integer_method, objective_fn=obj_fn)

    one = c == 1
    inf = torch.full_like(lam, torch.inf)
    m_cont = service_moments(ta, lengths, lam)
    m_int = service_moments(ta, ir.lengths, lam)
    w_cont = mean_wait_mgc(prob, lengths, c, c_max)
    w_int = mean_wait_mgc(prob, ir.lengths, c, c_max)
    return {
        "lengths_cont": lengths,
        "value_cont": obj_fn(prob, lengths),
        "lengths_int": ir.lengths,
        "value_int": ir.value,
        "value_lower_bound": torch.where(
            one, integer.rounding_lower_bound(prob, lengths), -inf),
        "fp_iterations": torch.zeros_like(pg.iterations),
        "fp_converged": torch.zeros_like(feasible),
        "fp_residual": inf,
        "kkt_residual": kkt,
        "used_pga": feasible,
        "pga_iterations": pg.iterations,
        "contraction_Linf": torch.where(
            one, fixed_point.contraction_certificate(prob), inf),
        "contraction_Linf_slab": torch.where(
            one, fixed_point.contraction_certificate(prob, 5e-2), inf),
        "rho_cont": m_cont.rho,
        "rho_int": m_int.rho,
        "feasible": feasible,
        "stable": feasible & (m_int.rho < c) & torch.isfinite(ir.value),
        "accuracy_cont": torch.sum(ta.pi * ta.accuracy(lengths), dim=-1),
        "accuracy_int": torch.sum(ta.pi * ta.accuracy(ir.lengths), dim=-1),
        "system_time_cont": w_cont + m_cont.es,
        "system_time_int": w_int + m_int.es,
    }


def solve_grid_flat(tasks: TaskSet, lam, alpha, l_max, c=None,
                    calib: Mapping[str, np.ndarray] | None = None,
                    tol: float = 1e-8, max_fp_iters: int = 500,
                    max_pga_iters: int = 20_000,
                    integer_method: str | None = None,
                    device=None) -> dict:
    """Batched solve over pre-flattened ``[C]`` cell axes on ``device``
    (default the card; ``"cpu"`` runs here).

    Returns the raw dict of ``[C]``-shaped tensors on ``device``. Prefer
    :func:`solve_grid`, which handles broadcasting and packs a
    :class:`GridSolution`. ``c`` (``[C]`` server counts, default all-ones)
    selects the path: an all-ones grid runs the fixed-point pipeline; any
    cell with c > 1 routes the *whole* grid through the M/G/c PGA
    pipeline, as in the JAX package.
    """
    if integer_method is None:
        integer_method = "exhaustive" if tasks.n_tasks <= 16 else "round"
    dev = resolve_device(device or DEFAULT_DEVICE)

    def put(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=dev)

    base = TaskArrays.from_taskset(tasks, dev)
    lam = put(lam)
    calib = dict(calib or {})
    unknown = set(calib) - set(_CALIB_FIELDS)
    if unknown:
        raise ValueError(f"unknown calib fields {sorted(unknown)}; "
                         f"expected subset of {_CALIB_FIELDS}")
    ones = np.ones(lam.shape[0])
    scales = _CalibScales(*(put(calib.get(f, ones)) for f in _CALIB_FIELDS))
    c_host = np.ones(lam.shape[0]) if c is None else np.asarray(c)
    if np.any(c_host < 1) or np.any(c_host != np.round(c_host)):
        raise ValueError("c must be integer server counts >= 1")
    with torch.no_grad():
        if np.all(c_host == 1):
            return _solve_cells(base, lam, put(alpha), put(l_max), scales,
                                tol, max_fp_iters, max_pga_iters,
                                integer_method)
        return _solve_cells_mgc(base, lam, put(alpha), put(l_max),
                                put(c_host), scales, tol, max_pga_iters,
                                integer_method, c_max=int(c_host.max()))


def solve_grid(tasks: TaskSet, lam, alpha, l_max, c=1,
               calib: Mapping[str, np.ndarray] | None = None,
               tol: float = 1e-8, max_fp_iters: int = 500,
               max_pga_iters: int = 20_000,
               integer_method: str | None = None,
               device=None) -> GridSolution:
    """Solve a whole ``(lambda, alpha, l_max[, c][, calib])`` operating grid.

    ``lam`` / ``alpha`` / ``l_max`` / ``c`` and every ``calib`` scale are
    broadcast against each other (so ``lam[:, None, None]``-style meshes
    work directly); the broadcast shape becomes ``GridSolution.shape``.
    The pipeline runs in float64 on ``device`` (default the card, raising
    without one; ``device="cpu"`` runs it on the host).

    ``c`` is the per-cell replica count of the M/G/c pod (default 1, the
    paper's M/G/1, which runs the fixed-point pipeline). Grids containing
    c > 1 cells solve through PGA on the Lee-Longton wait term
    (``core.mgc``), with stability and feasibility at rho / c < 1;
    ``rho_cont`` / ``rho_int`` record the *offered* load lam E[S].

    Infeasible cells (``lam * E[S(0)] >= c``) are flagged via
    ``feasible=False`` and their outputs are not meaningful; clip the
    arrival axis first (see ``sweeps.frontier.heavy_traffic_lams``).
    """
    tasks.validate()
    calib = dict(calib or {})
    arrays = [np.asarray(lam, dtype=np.float64),
              np.asarray(alpha, dtype=np.float64),
              np.asarray(l_max, dtype=np.float64),
              np.asarray(c, dtype=np.float64)]
    arrays += [np.asarray(v, dtype=np.float64) for v in calib.values()]
    bcast = np.broadcast_arrays(*arrays)
    shape = bcast[0].shape
    lam_f, alpha_f, lmax_f, c_f = (np.ravel(a) for a in bcast[:4])
    calib_f = {k: np.ravel(v) for k, v in zip(calib, bcast[4:])}

    out = solve_grid_flat(tasks, lam_f, alpha_f, lmax_f, c=c_f,
                          calib=calib_f, tol=tol, max_fp_iters=max_fp_iters,
                          max_pga_iters=max_pga_iters,
                          integer_method=integer_method, device=device)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    def _reshape(x: np.ndarray) -> np.ndarray:
        return x.reshape(shape + x.shape[1:])

    return GridSolution(
        lam=bcast[0].copy(), alpha=bcast[1].copy(), l_max=bcast[2].copy(),
        c=bcast[3].copy(),
        **{k: _reshape(v) for k, v in out.items()})


def reference_check(tasks: TaskSet, sol: GridSolution, cells=None,
                    tol: float = 1e-6,
                    require_integer_match: bool = True) -> float:
    """Re-solve grid cells through the scalar facade and assert agreement.

    The contract every grid consumer relies on: continuous optima within
    ``tol`` of ``core.allocator.solve`` and (by default) identical integer
    budgets. ``cells`` selects flat cell indices (default: all). Only valid
    for grids solved without calibration perturbations and without a
    multi-server axis (the facade is M/G/1; c-grids cross-check against
    the DES instead). Returns the worst |l* - l*_ref|_inf.
    """
    if not np.all(sol.c == 1):
        raise ValueError("reference_check requires a c=1 grid (the scalar "
                         "facade is M/G/1); validate c>1 grids against the "
                         "multiserver DES")
    flat = sol.ravel()
    if cells is None:
        cells = range(flat.lam.shape[0])
    worst = 0.0
    for i in cells:
        ref = allocator.solve(Problem(
            tasks=tasks, server=ServerParams(float(flat.lam[i]),
                                             float(flat.alpha[i]),
                                             float(flat.l_max[i]))))
        dev = float(np.max(np.abs(ref.lengths_cont - flat.lengths_cont[i])))
        worst = max(worst, dev)
        if dev >= tol:
            raise AssertionError(
                f"grid/scalar continuous optima disagree at cell {i}: "
                f"{dev:.2e} >= {tol:g}")
        if require_integer_match and not np.array_equal(
                ref.lengths_int, flat.lengths_int[i]):
            raise AssertionError(
                f"grid/scalar integer budgets disagree at cell {i}: "
                f"{flat.lengths_int[i]} vs {ref.lengths_int}")
    return worst

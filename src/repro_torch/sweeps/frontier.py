"""Pareto frontiers and heavy-traffic capacity planning on solved grids.

The solved grid (``solver_grid.solve_grid``) gives every operating cell an
(accuracy, mean-system-time) pair; this module answers the design questions
those grids exist for:

* :func:`pareto_mask` / :func:`pareto_front` — which cells are undominated
  in (max accuracy, min E[T_sys])?
* :func:`heavy_traffic_lams` / :func:`heavy_traffic_slice` — slices
  ``rho_0 -> 1`` along the arrival axis, where ``rho_0 = lam E[S(0)]`` is
  the *irreducible* utilization (zero reasoning tokens; eq 4's stability
  boundary). Arrival rates are automatically clipped strictly below
  saturation so every solved cell is well posed.
* :func:`max_sustainable_lambda` — "the largest arrival rate at which the
  optimally-allocated server still reaches accuracy >= target", by grid
  refinement over solved slices.

The solving functions pass ``**solve_kwargs`` (``device`` among them) on
to :func:`~repro_torch.sweeps.solver_grid.solve_grid`.
"""
from __future__ import annotations

import numpy as np

from ..core.params import TaskSet
from .solver_grid import GridSolution, solve_grid

__all__ = ["pareto_mask", "pareto_front", "saturation_rate",
           "heavy_traffic_lams", "heavy_traffic_slice",
           "max_sustainable_lambda", "frontier_comparison"]


def pareto_mask(accuracy, system_time) -> np.ndarray:
    """Boolean mask of cells undominated in (max accuracy, min time).

    A cell is dominated if some other cell has accuracy >= and system time
    <= with at least one inequality strict. O(C log C): sweep cells in
    increasing system time and keep the running accuracy record.
    """
    acc = np.asarray(accuracy, dtype=np.float64).ravel()
    t = np.asarray(system_time, dtype=np.float64).ravel()
    C = acc.shape[0]
    mask = np.zeros(C, dtype=bool)
    finite = np.isfinite(acc) & np.isfinite(t)
    order = np.lexsort((-acc, t))          # time asc, accuracy desc within
    best = -np.inf
    for i in order:
        if not finite[i]:
            continue
        if acc[i] > best:
            mask[i] = True
            best = acc[i]
    return mask


def pareto_front(sol: GridSolution, use: str = "int") -> dict:
    """Undominated cells of a solved grid, sorted by mean system time.

    Returns arrays ``indices`` (flat cell ids), ``accuracy``,
    ``system_time``, ``lam``, ``alpha``, ``lengths`` restricted to the
    frontier. Unstable cells never enter the frontier.
    """
    flat = sol.ravel()
    acc = flat.accuracy_int if use == "int" else flat.accuracy_cont
    t = flat.system_time_int if use == "int" else flat.system_time_cont
    lengths = flat.lengths_int if use == "int" else flat.lengths_cont
    acc = np.where(flat.stable, acc, -np.inf)
    mask = pareto_mask(acc, t)
    idx = np.nonzero(mask)[0]
    idx = idx[np.argsort(t[idx])]
    return {
        "indices": idx,
        "accuracy": acc[idx],
        "system_time": t[idx],
        "lam": flat.lam[idx],
        "alpha": flat.alpha[idx],
        "lengths": lengths[idx],
    }


def saturation_rate(tasks: TaskSet) -> float:
    """lam_sat = 1 / E[S(0)]: beyond it the queue is unstable even with
    zero reasoning tokens (eq 4 at l = 0)."""
    es0 = float(np.sum(np.asarray(tasks.pi) * np.asarray(tasks.t0)))
    return 1.0 / es0


def heavy_traffic_lams(tasks: TaskSet, rho_targets,
                       margin: float = 1e-3) -> np.ndarray:
    """Arrival rates hitting irreducible utilizations ``rho_0`` =
    ``rho_targets``, clipped to ``rho_0 <= 1 - margin`` so no solved cell
    can sit at or beyond saturation."""
    rho = np.clip(np.asarray(rho_targets, dtype=np.float64),
                  0.0, 1.0 - margin)
    return rho * saturation_rate(tasks)


def heavy_traffic_slice(tasks: TaskSet, alpha, l_max, rho_targets,
                        margin: float = 1e-3, **solve_kwargs) -> GridSolution:
    """Solve the optimum along a ``rho_0 -> 1`` slice of the arrival axis.

    ``rho_targets`` are irreducible utilizations (see
    :func:`heavy_traffic_lams`); the returned grid is 1-D over them. Every
    cell is feasible by construction (arrival rates clipped below
    saturation), so ``sol.feasible`` is all-True and ``rho_int < 1``.
    """
    lams = heavy_traffic_lams(tasks, rho_targets, margin=margin)
    return solve_grid(tasks, lams, alpha, l_max, **solve_kwargs)


def max_sustainable_lambda(tasks: TaskSet, alpha, l_max,
                           min_accuracy: float, *, use: str = "int",
                           n_grid: int = 33, refine: int = 2,
                           margin: float = 1e-3, **solve_kwargs) -> dict:
    """Capacity planning: max lambda whose *optimal* allocation still
    achieves ``accuracy >= min_accuracy`` (and a stable queue).

    Optimal accuracy is non-increasing in lambda (heavier traffic forces
    shorter reasoning budgets), so the answer is the upper edge of the
    feasible set; located by solving a lambda grid and refining
    ``refine`` times around the feasibility boundary. Returns a dict with
    ``lam`` (nan if even light traffic misses the target), ``accuracy``,
    ``system_time``, ``lengths`` and the final refined ``solution``.
    """
    lo, hi = margin * saturation_rate(tasks), \
        (1.0 - margin) * saturation_rate(tasks)
    sol = None
    best = None
    for _ in range(max(1, refine + 1)):
        lams = np.linspace(lo, hi, n_grid)
        sol = solve_grid(tasks, lams, alpha, l_max, **solve_kwargs)
        acc = sol.accuracy_int if use == "int" else sol.accuracy_cont
        ok = sol.stable & (acc >= min_accuracy)
        if not ok.any():
            break
        i = int(np.nonzero(ok)[0][-1])
        best = i
        lo = lams[i]
        hi = lams[i + 1] if i + 1 < n_grid else lams[i]
        if hi <= lo:
            break
    if sol is None or best is None:
        return {"lam": float("nan"), "accuracy": float("nan"),
                "system_time": float("nan"), "lengths": None,
                "solution": sol}
    acc = sol.accuracy_int if use == "int" else sol.accuracy_cont
    t = sol.system_time_int if use == "int" else sol.system_time_cont
    lengths = sol.lengths_int if use == "int" else sol.lengths_cont
    return {
        "lam": float(sol.lam[best]),
        "accuracy": float(acc[best]),
        "system_time": float(t[best]),
        "lengths": np.asarray(lengths[best]),
        "solution": sol,
    }


def frontier_comparison(measured_accuracy, measured_system_time,
                        predicted_accuracy, predicted_system_time,
                        ci_system_time=None,
                        measured_percentiles=None,
                        predicted_percentiles=None,
                        drift=None) -> dict:
    """Score measured operating points against their analytic predictions.

    The closed-loop replay harness (``serving.replay``) produces MEASURED
    (accuracy, E[T_sys]) points from the real engine or the virtual plant;
    the solver stack produces the P-K/DES PREDICTED points for the same
    deployed budgets. This packs the element-wise comparison the
    ``benchmarks/replay_bench.py`` frontier report needs:

    * per-point absolute and relative system-time gaps,
    * CI coverage (``|gap| <= ci_system_time``) when measurement CIs are
      supplied,
    * Pareto masks of both point sets in the joint (max accuracy,
      min time) order — a measured point that stays on the joint frontier
      alongside its prediction is operating where the model says it should,
    * tail comparison: ``measured_percentiles`` / ``predicted_percentiles``
      ({"p50": ..., "p99": ...} dicts, e.g. from
      ``ServingReport.system_time_percentiles`` and the M/G/1
      exponential-tail prediction) yield per-percentile relative gaps —
      Yang et al. (2407.05347): the tail, not the mean, is what batched
      decode moves,
    * ``drift`` passes a final ``obs.monitor`` DriftReport dict through to
      the scored record, so frontier artifacts carry the loop's
      model-mismatch verdict alongside the gaps.
    """
    ma = np.asarray(measured_accuracy, dtype=np.float64).ravel()
    mt = np.asarray(measured_system_time, dtype=np.float64).ravel()
    pa = np.asarray(predicted_accuracy, dtype=np.float64).ravel()
    pt = np.asarray(predicted_system_time, dtype=np.float64).ravel()
    if not (ma.shape == mt.shape == pa.shape == pt.shape):
        raise ValueError("measured/predicted arrays must share one shape")
    gap_t = mt - pt
    rel_t = gap_t / np.maximum(np.abs(pt), 1e-12)
    gap_a = ma - pa
    out = {
        "n": int(ma.shape[0]),
        "measured_accuracy": ma, "measured_system_time": mt,
        "predicted_accuracy": pa, "predicted_system_time": pt,
        "gap_system_time": gap_t, "rel_gap_system_time": rel_t,
        "gap_accuracy": gap_a,
        "max_rel_gap_system_time": float(np.max(np.abs(rel_t)))
            if ma.size else 0.0,
        "max_gap_accuracy": float(np.max(np.abs(gap_a))) if ma.size else 0.0,
    }
    if ci_system_time is not None:
        ci = np.asarray(ci_system_time, dtype=np.float64).ravel()
        covered = np.abs(gap_t) <= ci
        out["ci_system_time"] = ci
        out["covered"] = covered
        out["coverage"] = float(covered.mean()) if covered.size else 1.0
    if measured_percentiles is not None:
        out["measured_percentiles"] = dict(measured_percentiles)
    if predicted_percentiles is not None:
        out["predicted_percentiles"] = dict(predicted_percentiles)
    if measured_percentiles and predicted_percentiles:
        gaps = {}
        for key in measured_percentiles.keys() & predicted_percentiles.keys():
            mq, pq = float(measured_percentiles[key]), \
                float(predicted_percentiles[key])
            gaps[key] = (mq - pq) / max(abs(pq), 1e-12)
        out["rel_gap_percentiles"] = gaps
        out["max_rel_gap_percentile"] = (max(abs(v) for v in gaps.values())
                                         if gaps else 0.0)
    if drift is not None:
        out["drift"] = dict(drift)
    # joint frontier: stack both sets, mask each half
    acc = np.concatenate([ma, pa])
    t = np.concatenate([mt, pt])
    joint = pareto_mask(acc, t)
    out["measured_on_joint_front"] = joint[:ma.shape[0]]
    out["predicted_on_joint_front"] = joint[ma.shape[0]:]
    return out

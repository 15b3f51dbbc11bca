"""Occupancy-aware grid solving: solve_grid x batch-service fixed point.

``solve_grid`` prices waiting with per-token costs calibrated at batch
size one; a continuous-batching engine at occupancy b_bar really pays
``c_k * r(b_bar)`` per token (``core.batch_service``). But the optimal
budgets themselves move the occupancy (longer answers -> more in-service
work -> higher b_bar -> slower tokens), so neither quantity can be
computed first. This module iterates the two to a joint fixed point:

    1. solve the grid with per-cell calibration scale c <- c * r(b_bar)
       (the ``calib={"c": ...}`` hook of ``solve_grid`` — the solver
       itself is unchanged),
    2. re-solve each cell's occupancy fixed point at the new integer
       budgets,
    3. repeat until the occupancy ratio stops moving (sup-norm).

The outer loop damps the ratio update (integer budgets can flip between
adjacent values as the scale moves, which would otherwise limit-cycle)
and typically converges in a handful of rounds: r(b) is bounded in
[1, r(max_batch)] and the damped iterates contract onto the joint
fixed point.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.batch_service import StepLatencyModel, occupancy_fixed_point
from ..core.params import TaskSet
from .solver_grid import GridSolution, solve_grid

__all__ = ["BatchServiceGrid", "solve_grid_batch_service"]


class BatchServiceGrid(NamedTuple):
    """Jointly solved (budgets, occupancy) operating grid."""

    solution: GridSolution     # solved at the converged occupancy ratios
    b_bar: np.ndarray          # per-cell steady-state occupancy
    ratio: np.ndarray          # per-cell r(b_bar) applied to c
    rounds: int
    converged: bool


def solve_grid_batch_service(tasks: TaskSet, lam, alpha, l_max,
                             model: StepLatencyModel, max_batch: int,
                             tol: float = 5e-3, max_rounds: int = 25,
                             damping: float = 0.5,
                             **solve_kwargs) -> BatchServiceGrid:
    """Solve an operating grid under the occupancy-corrected service model.

    Accepts the same broadcastable ``lam`` / ``alpha`` / ``l_max`` axes as
    :func:`~repro_torch.sweeps.solver_grid.solve_grid`; every cell is solved as
    an M/G/c queue with ``c = max_batch`` servers and a per-cell
    multiplicative per-token-cost scale r(b_bar). With a flat latency
    model (d1 = 0) the ratio is identically 1 and the result equals a
    plain ``solve_grid(..., c=max_batch)`` call.

    ``tol`` bounds the sup-norm movement of the occupancy ratio between
    rounds; its default (0.5%) sits below the documented accuracy of the
    batch-service analytics but above the +-1-integer-token budget flips
    that would otherwise limit-cycle forever.
    """
    model.validate()
    bcast = np.broadcast_arrays(np.asarray(lam, dtype=np.float64),
                                np.asarray(alpha, dtype=np.float64),
                                np.asarray(l_max, dtype=np.float64))
    shape = bcast[0].shape
    lam_b = bcast[0]
    ratio = np.ones(shape)
    b_bar = np.ones(shape)
    sol = None
    for round_ in range(1, max_rounds + 1):
        sol = solve_grid(tasks, bcast[0], bcast[1], bcast[2], c=max_batch,
                         calib={"c": ratio}, **solve_kwargs)
        flat_lam = lam_b.reshape(-1)
        flat_len = sol.lengths_int.reshape(-1, tasks.n_tasks)
        new_ratio = np.ones(flat_lam.shape[0])
        new_b = np.ones(flat_lam.shape[0])
        for i in range(flat_lam.shape[0]):
            bb, _, _ = occupancy_fixed_point(
                tasks, flat_len[i], float(flat_lam[i]), model, max_batch)
            new_b[i] = bb
            new_ratio[i] = model.ratio(bb)
        new_ratio = new_ratio.reshape(shape)
        new_b = new_b.reshape(shape)
        moved = float(np.max(np.abs(new_ratio - ratio))) if ratio.size \
            else 0.0
        ratio = (1.0 - damping) * ratio + damping * new_ratio
        b_bar = new_b
        if moved < tol:
            return BatchServiceGrid(solution=sol, b_bar=b_bar, ratio=ratio,
                                    rounds=round_, converged=True)
    return BatchServiceGrid(solution=sol, b_bar=b_bar, ratio=ratio,
                            rounds=max_rounds, converged=False)

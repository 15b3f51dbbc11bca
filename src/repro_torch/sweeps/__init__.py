"""Device-resident design-space exploration for the token-allocation paper.

Where ``repro_torch.core`` solves ONE operating point and
``repro_torch.queueing_sim`` simulates batches of streams, this package
solves and evaluates *entire operating grids* — ``(lambda, alpha, l_max,
calibration)`` meshes — in single batched float64 passes on the card
(``device``; ``"cpu"`` runs them here), then asks capacity-planning
questions of the result. The port of ``repro.sweeps``: the JAX package's
``jax.jit(jax.vmap(cell))`` is one pass over a ``[C]`` cell axis through
``core``, each finished lane frozen.

API -> paper map
================

``solver_grid.solve_grid`` / ``solve_grid_flat``
    Batched projected fixed-point iteration (eqs 19-24: Lambert-W closed
    form of the KKT stationarity, eq 17) with per-cell convergence flags
    and KKT residuals; per-cell PGA-backtracking fallback (eq 29 with the
    eq 38 step-size bound) gated by a traced iteration budget; the Lemma 2
    contraction certificate L_inf (eq 26) computed in batch (paper box
    form and feasible-slab variant); floor/ceil integer search (eq 39) or
    rounding (eq 40) with the eq 41 lower bound.

``solver_grid.GridSolution``
    Container for continuous optima l* , integer budgets, objective values
    J(l*) / J(l_int) (eq 7), the eq 41 sandwich bound, stability masks
    (lam E[S] < 1, eq 4), and per-cell P-K accuracy / mean system time
    (eqs 5-6) for frontier extraction.

``evaluate.evaluate_cells`` / ``evaluate_solution``
    Couples every solved cell to the Pollaczek-Khinchine prediction
    (eqs 5-6) AND the batched Lindley DES (``queueing_sim.batched``; with
    ``backend="torch"`` the CUDA lanes) over one common-random-number
    ``StreamBatch``; returns per-cell analytic-vs-DES gaps and 95% CIs
    (paper Sec IV validation, grid-wide).

``frontier.pareto_front`` / ``heavy_traffic_slice`` /
``max_sustainable_lambda``
    Accuracy-vs-E[T_sys] Pareto extraction over solved grids; rho_0 -> 1
    slices along the arrival axis with automatic stability clipping
    (eq 4's boundary at l = 0); and "max sustainable lambda at target
    accuracy" capacity queries by grid refinement.

``prediction.sweep_prediction_error`` / ``fifo_crossover_sigma``
    Prediction-error robustness frontier for the predicted disciplines
    (SPJF/SPRPT keyed on ``data.predictor`` estimates): mean/p99 wait vs
    error level sigma on common random numbers, against exact-size
    SJF/SRPT and size-blind FIFO references; ``fifo_crossover_sigma``
    reports "how wrong can the predictor be before FIFO wins" (beyond
    the paper, which assumes sizes known on arrival — Sec II).

The scalar path (``core.allocator.solve``) remains the reference
implementation; ``tests/test_solver_grid.py`` pins per-cell agreement
(continuous optima to 1e-6, identical integer budgets), and
``tests/test_torch_sweeps.py`` holds this package to ``repro.sweeps``.
"""
from .batch_service import BatchServiceGrid, solve_grid_batch_service
from .evaluate import GridEvaluation, evaluate_cells, evaluate_solution
from .frontier import (frontier_comparison, heavy_traffic_lams,
                       heavy_traffic_slice, max_sustainable_lambda,
                       pareto_front, pareto_mask, saturation_rate)
from .prediction import (PredictionFrontier, fifo_crossover_sigma,
                         service_cv2, sweep_prediction_error)
from .solver_grid import (GridSolution, TaskArrays, reference_check,
                          solve_grid, solve_grid_flat)

__all__ = [
    "GridSolution", "TaskArrays", "solve_grid", "solve_grid_flat",
    "reference_check",
    "GridEvaluation", "evaluate_cells", "evaluate_solution",
    "pareto_mask", "pareto_front", "saturation_rate", "heavy_traffic_lams",
    "heavy_traffic_slice", "max_sustainable_lambda", "frontier_comparison",
    "BatchServiceGrid", "solve_grid_batch_service",
    "PredictionFrontier", "sweep_prediction_error", "fifo_crossover_sigma",
    "service_cv2",
]

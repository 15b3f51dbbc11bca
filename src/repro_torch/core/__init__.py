"""Core: the paper's contribution — queueing-aware reasoning-token allocation.

PyTorch counterpart of ``repro.core``, float64 on the host. Public API:

    Problem, TaskSet, ServerParams, paper_problem   -- problem data (Sec II)
    objective, grad                                 -- J(l) and its gradient (eq 7)
    solve_fixed_point, contraction_certificate      -- Sec III-B/C (eqs 19-26)
    solve_pga_backtracking, safe_step_size          -- Sec III-D (eqs 29-38)
    round_policy, exhaustive_policy, coordinate_policy, sandwich
                                                    -- Sec III-E (eqs 39-41)
    TokenBudgetAllocator, solve                     -- end-to-end facade
    fit_latency, fit_accuracy, calibrate_taskset    -- Sec IV-A fits
    fit_step_latency, batch_service_wait, ...       -- occupancy model
    erlang_c, mgc_wait_np, solve_mgc, ...           -- M/G/c analytics
"""
from .allocator import Solution, TokenBudgetAllocator, solve
from .batch_service import (BatchServiceResult, StepLatencyModel,
                            batch_service_wait, corrected_taskset,
                            fit_step_latency, occupancy_fixed_point)
from .calibration import calibrate_taskset, fit_accuracy, fit_latency
from .fixed_point import (contraction_certificate, fixed_point_map,
                          solve_fixed_point)
from .integer import (coordinate_policy, exhaustive_policy, round_policy,
                      rounding_lower_bound, sandwich)
from .lambertw import lambertw0
from .mgc import (erlang_c, erlang_c_np, mean_system_time_mgc, mean_wait_mgc,
                  mgc_wait_np, objective_mgc, pod_replica_tradeoff,
                  solve_mgc)
from .objective import grad, lipschitz_grad_bound, objective
from .params import (PAPER_TABLE1_LSTAR, Problem, ServerParams, TaskSet,
                     paper_problem, paper_tasks)
from .pga import safe_step_size, solve_pga_backtracking
from .queueing import (is_stable, mean_system_time, mean_wait,
                       service_moments, stability_clip, worst_case)

__all__ = [
    "Problem", "TaskSet", "ServerParams", "paper_problem", "paper_tasks",
    "PAPER_TABLE1_LSTAR", "objective", "grad", "lipschitz_grad_bound",
    "solve_fixed_point", "fixed_point_map", "contraction_certificate",
    "solve_pga_backtracking", "safe_step_size", "round_policy",
    "exhaustive_policy", "coordinate_policy", "sandwich",
    "rounding_lower_bound", "lambertw0",
    "TokenBudgetAllocator", "Solution", "solve", "service_moments",
    "mean_wait", "mean_system_time", "is_stable", "worst_case",
    "stability_clip", "calibrate_taskset", "fit_accuracy", "fit_latency",
    "erlang_c", "erlang_c_np", "mean_wait_mgc", "mean_system_time_mgc",
    "mgc_wait_np", "objective_mgc", "solve_mgc", "pod_replica_tradeoff",
    "StepLatencyModel", "fit_step_latency", "occupancy_fixed_point",
    "corrected_taskset", "batch_service_wait", "BatchServiceResult",
]

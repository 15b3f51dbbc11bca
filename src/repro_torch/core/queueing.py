"""M/G/1 queueing quantities for the token-allocation problem (Sec II-A).

The service time S takes value t_k(l_k) with probability pi_k; the server is
an M/G/1 FIFO queue. Mean waiting time is Pollaczek-Khinchine (eq 5).

Per-cell scalars (``lam``, ``l_max``, ``c_servers``) may be tensors with
the leading cell axes of ``lengths`` (``sweeps.solve_grid``); the task axis
is always the trailing one.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .params import Problem, TaskSet, control_like, per_task

Tensor = torch.Tensor


class Moments(NamedTuple):
    es: Tensor      # E[S]      (eq 3)
    es2: Tensor     # E[S^2]    (eq 3)
    rho: Tensor     # lam * E[S]
    slack: Tensor   # D = 1 - lam * E[S]


def service_moments(tasks: TaskSet, lengths: Tensor, lam: float) -> Moments:
    """Mixture moments of S (eq 3). ``lengths`` may carry leading batch axes
    (``[..., N]``); the task axis is always the trailing one and the returned
    moments have the leading shape ``[...]``."""
    t = tasks.service_time(lengths)
    es = torch.sum(tasks.pi * t, dim=-1)
    es2 = torch.sum(tasks.pi * t * t, dim=-1)
    rho = lam * es
    return Moments(es=es, es2=es2, rho=rho, slack=1.0 - rho)


def mean_wait(m: Moments, lam: float) -> Tensor:
    """Pollaczek-Khinchine mean queueing delay E[W] (eq 5)."""
    return lam * m.es2 / (2.0 * m.slack)


def mean_system_time(m: Moments, lam: float) -> Tensor:
    """E[T_sys] = E[W] + E[S] (eq 6)."""
    return mean_wait(m, lam) + m.es


def is_stable(tasks: TaskSet, lengths: Tensor, lam: float,
              margin: float = 0.0) -> Tensor:
    return service_moments(tasks, lengths, lam).rho < 1.0 - margin


class WorstCase(NamedTuple):
    """Worst-case (l = l_max everywhere) quantities used by Lemmas 2-3."""

    t_max_k: Tensor     # t_k^max = t0_k + c_k l_max, per task
    t_max: Tensor       # max_k t_k^max
    es_max: Tensor      # E[S]_max
    es2_max: Tensor     # E[S^2]_max
    rho_max: Tensor     # lam * E[S]_max


def worst_case(tasks: TaskSet, lam: float, l_max: float,
               stability_margin: float | None = None) -> WorstCase:
    """Worst-case moments over the box [0, l_max]^N (Lemmas 2-3).

    With ``stability_margin`` the box is restricted to the feasible slab
    {l : lam E[S(l)] <= 1 - margin} (see ``repro.core.queueing.worst_case``
    for the derivation); the projected solvers keep their iterates there.
    ``lam`` and ``l_max`` may carry cell axes; the results then have them.
    """
    t_box_k = tasks.t0 + tasks.c * per_task(l_max)
    if stability_margin is None:
        t_max_k = t_box_k
        es_max = torch.sum(tasks.pi * t_max_k, dim=-1)
        es2_max = torch.sum(tasks.pi * t_max_k * t_max_k, dim=-1)
        rho_max = lam * es_max
    else:
        es0 = torch.sum(tasks.pi * tasks.t0, dim=-1)
        slack = (1.0 - stability_margin) / lam - es0  # budget for pi c l
        # spending all slack on task k: pi_k c_k lbar_k = slack
        lbar_k = per_task(torch.clamp(slack, min=0.0)) / (tasks.pi * tasks.c)
        t_max_k = tasks.t0 + tasks.c * torch.minimum(
            per_task(control_like(l_max, tasks.t0)), lbar_k)
        es_max = torch.minimum(
            torch.sum(tasks.pi * t_box_k, dim=-1),
            control_like((1.0 - stability_margin) / lam, tasks.t0))
        es2_max = torch.sum(tasks.pi * t_max_k * t_max_k, dim=-1)
        rho_max = lam * es_max
    return WorstCase(t_max_k=t_max_k, t_max=torch.amax(t_max_k, dim=-1),
                     es_max=es_max, es2_max=es2_max, rho_max=rho_max)


def stabilizable(tasks: TaskSet, lam: float, margin: float = 1e-6,
                 c_servers=1) -> Tensor:
    """Whether :func:`stability_clip` can honor its guarantee at ``lam``.

    The clip scales budgets toward l = 0, so its floor is the zero-token
    load rho_0 = lam E[t0]; once rho_0 >= c (1 - margin) no scaling reaches
    the slab and the clip returns l = 0 at rho = rho_0 (possibly >= c).
    Callers sweeping arrival rates must mark such cells unstable rather
    than treat them as clipped. ``c_servers`` is the M/G/c server count
    (default 1, the paper's M/G/1); ``lam`` and ``c_servers`` may be
    tensors with cell axes (``sweeps.solve_grid``'s c-grids).
    """
    rho0 = lam * torch.sum(tasks.pi * tasks.t0, dim=-1)
    return rho0 < c_servers * (1.0 - margin)


def stability_clip(tasks: TaskSet, lam: float, lengths: Tensor,
                   margin: float = 1e-6, c_servers=1) -> Tensor:
    """Scale l toward 0 so that lam E[S(l)] <= c (1 - margin).

    E[S] is affine in l, so scaling the vector by s in [0, 1] moves rho
    affinely between rho(0) < c and rho(l); solve for the s achieving
    rho = c (1 - margin). Identity for already-stable points. The
    guarantee holds only where :func:`stabilizable` does: past it the clip
    returns l = 0 at rho = rho_0.
    """
    cap = c_servers * (1.0 - margin)
    rho0 = lam * torch.sum(tasks.pi * tasks.t0, dim=-1)
    rho = service_moments(tasks, lengths, lam).rho
    s = torch.where(rho >= cap,
                    (cap - rho0) / torch.clamp(rho - rho0, min=1e-30),
                    torch.ones_like(rho))
    return lengths * torch.clamp(s, 0.0, 1.0)[..., None]


class PriorityWaits(NamedTuple):
    """Cobham per-class waits for non-preemptive M/G/1 priority."""

    per_task: np.ndarray    # [N] mean wait of each task's class
    mean_wait: np.ndarray   # scalar: sum_k pi_k W_k (arrival-averaged)
    residual: np.ndarray    # scalar: R = lam E[S^2] / 2
    class_of: np.ndarray    # [N] 0-based class index (0 = served first)


def priority_mean_waits(tasks: TaskSet, lengths, lam: float,
                        keys=None) -> PriorityWaits:
    """Cobham's non-preemptive priority formula, per task (beyond paper).

    Each task type is a Poisson class with rate lam pi_k and deterministic
    service t_k(l_k); with classes ordered by ascending key (lower key =
    served first, tasks sharing a key pooled into one class)

        W_k = R / ((1 - sigma_{k-1}) (1 - sigma_k)),
        R = lam E[S^2] / 2,   sigma_k = sum_{j in classes <= k} lam pi_j t_j

    With all keys equal it is the P-K wait R / (1 - rho). ``keys``
    defaults to the priority discipline's ordering (``-accuracy /
    service``, as ``queueing_sim.discipline_keys("priority")``). Host
    NumPy f64, as in the JAX package.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    t = np.asarray(tasks.t0) + np.asarray(tasks.c) * lengths
    pi = np.asarray(tasks.pi)
    if keys is None:
        A, b, D = (np.asarray(x) for x in (tasks.A, tasks.b, tasks.D))
        p = A * (1.0 - np.exp(-b * lengths)) + D
        keys = -p / np.maximum(t, 1e-12)
    keys = np.asarray(keys, dtype=np.float64)
    uniq, class_of = np.unique(keys, return_inverse=True)
    rho_class = np.bincount(class_of, weights=lam * pi * t,
                            minlength=uniq.shape[0])
    sigma = np.cumsum(rho_class)                       # sigma_k, inclusive
    sigma_prev = sigma - rho_class                     # sigma_{k-1}
    r = lam * float(np.sum(pi * t * t)) / 2.0
    with np.errstate(divide="ignore"):
        w_class = np.where((sigma < 1.0) & (sigma_prev < 1.0),
                           r / ((1.0 - sigma_prev) * (1.0 - sigma)), np.inf)
    per_task = w_class[class_of]
    return PriorityWaits(per_task=per_task,
                         mean_wait=np.sum(pi * per_task),
                         residual=np.asarray(r),
                         class_of=class_of)


def max_stable_budget(problem: Problem, margin: float = 1e-3) -> float:
    """Largest uniform budget keeping the queue stable (diagnostic):
    lam * sum_k pi_k (t0_k + c_k l) = 1 - margin solved for l."""
    tasks, lam = problem.tasks, problem.server.lam
    es0 = float(torch.sum(tasks.pi * tasks.t0))
    cbar = float(torch.sum(tasks.pi * tasks.c))
    l = ((1.0 - margin) / lam - es0) / cbar
    return max(0.0, min(l, problem.server.l_max))


class RetryFixedPoint(NamedTuple):
    """Effective-arrival-rate fixed point under timeout-with-retry.

    ``lam_eff`` solves ``lam_eff = lam * sum_{j<=K} p(lam_eff)^j`` with
    ``p`` the per-attempt timeout probability P(W > patience) at load
    ``lam_eff``. ``stable`` is the retry-extended certificate
    ``lam_eff * E[S] < 1`` at a converged fixed point; in the metastable
    regime the iteration pins at lam * (K + 1) with p = 1.
    """
    lam_eff: float
    p_timeout: float
    rho_eff: float
    stable: bool
    converged: bool


def timeout_probability(lam: float, es: float, es2: float,
                        patience: float) -> float:
    """P(wait > patience) for M/G/1 FIFO, exponential-tail approximation:
    P(W > t) = rho exp(-t rho / E[W]), 1 once rho >= 1. Host f64."""
    if not np.isfinite(patience):
        return 0.0
    rho = lam * es
    if rho >= 1.0:
        return 1.0
    if patience <= 0.0:
        return float(rho)
    w = lam * es2 / (2.0 * (1.0 - rho))
    if w <= 0.0:
        return 0.0
    return float(rho * np.exp(-patience * rho / w))


def retry_fixed_point(lam: float, es: float, es2: float, patience: float,
                      max_retries: int, max_iters: int = 500,
                      tol: float = 1e-12) -> RetryFixedPoint:
    """Solve the retry-inflated arrival-rate fixed point.

    ``g(x) = lam (1 - p(x)^(K+1)) / (1 - p(x))`` is monotone increasing,
    so iterating from ``x = lam`` reaches the least fixed point when one
    lies below saturation; past rho >= 1 it pins at lam (K + 1), the
    retry storm, reported unstable. The measured counterpart is
    ``queueing_sim.impatience``'s ``lam_eff``.
    """
    kk = int(max_retries)
    if kk == 0 or not np.isfinite(patience):
        p = timeout_probability(lam, es, es2, patience)
        rho_eff = lam * es
        return RetryFixedPoint(float(lam), p, float(rho_eff),
                               bool(rho_eff < 1.0), True)
    lam_eff = float(lam)
    p = 0.0
    converged = False
    for _ in range(max_iters):
        p = timeout_probability(lam_eff, es, es2, patience)
        if p >= 1.0:
            new = lam * (kk + 1)
        else:
            new = lam * (1.0 - p ** (kk + 1)) / (1.0 - p)
        if abs(new - lam_eff) <= tol * max(abs(lam_eff), 1.0):
            lam_eff = new
            converged = True
            break
        lam_eff = new
    rho_eff = lam_eff * es
    return RetryFixedPoint(float(lam_eff), float(p), float(rho_eff),
                           bool(converged and rho_eff < 1.0),
                           bool(converged))


def retry_stable(tasks: TaskSet, lengths, lam: float, patience: float,
                 max_retries: int) -> bool:
    """Retry-extended stability certificate at integer budgets
    ``lengths``: the mixture's moments on the host, then
    ``lam_eff * E[S] < 1`` at a converged :func:`retry_fixed_point`."""
    lengths = np.asarray(lengths, dtype=np.float64)
    t0, c, pi = (np.asarray(x) for x in (tasks.t0, tasks.c, tasks.pi))
    t = t0 + c * lengths
    es = float(np.sum(pi * t))
    es2 = float(np.sum(pi * t * t))
    return retry_fixed_point(lam, es, es2, patience, max_retries).stable

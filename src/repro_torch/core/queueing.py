"""M/G/1 queueing quantities for the token-allocation problem (Sec II-A).

The service time S takes value t_k(l_k) with probability pi_k; the server is
an M/G/1 FIFO queue. Mean waiting time is Pollaczek-Khinchine (eq 5).
Only the functions the solvers and the server call are here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .params import TaskSet, as_control

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
    """
    t_box_k = tasks.t0 + tasks.c * l_max
    if stability_margin is None:
        t_max_k = t_box_k
        es_max = torch.sum(tasks.pi * t_max_k)
        es2_max = torch.sum(tasks.pi * t_max_k * t_max_k)
        rho_max = lam * es_max
    else:
        es0 = torch.sum(tasks.pi * tasks.t0)
        slack = (1.0 - stability_margin) / lam - es0  # budget for pi c l
        # spending all slack on task k: pi_k c_k lbar_k = slack
        lbar_k = torch.clamp(slack, min=0.0) / (tasks.pi * tasks.c)
        t_max_k = tasks.t0 + tasks.c * torch.minimum(as_control(l_max),
                                                     lbar_k)
        es_max = torch.minimum(torch.sum(tasks.pi * t_box_k),
                               as_control((1.0 - stability_margin) / lam))
        es2_max = torch.sum(tasks.pi * t_max_k * t_max_k)
        rho_max = lam * es_max
    return WorstCase(t_max_k=t_max_k, t_max=torch.max(t_max_k),
                     es_max=es_max, es2_max=es2_max, rho_max=rho_max)


def stability_clip(tasks: TaskSet, lam: float, lengths: Tensor,
                   margin: float = 1e-6, c_servers=1) -> Tensor:
    """Scale l toward 0 so that lam E[S(l)] <= c (1 - margin).

    E[S] is affine in l, so scaling the vector by s in [0, 1] moves rho
    affinely between rho(0) < c and rho(l); solve for the s achieving
    rho = c (1 - margin). Identity for already-stable points.
    """
    cap = c_servers * (1.0 - margin)
    rho0 = lam * torch.sum(tasks.pi * tasks.t0, dim=-1)
    rho = service_moments(tasks, lengths, lam).rho
    s = torch.where(rho >= cap,
                    (cap - rho0) / torch.clamp(rho - rho0, min=1e-30),
                    torch.ones_like(rho))
    return lengths * torch.clamp(s, 0.0, 1.0)[..., None]

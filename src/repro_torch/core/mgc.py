"""M/G/c analytics for c model replicas behind one queue (beyond paper).

The port of ``repro.core.mgc``. The wait term is the Lee-Longton /
Allen-Cunneen approximation

    E[W_{M/G/c}] ~= (1 + CV^2) / 2 * E[W_{M/M/c}]

with E[W_{M/M/c}] from Erlang-C, or with ``correction="cosmetatos"`` the
Cosmetatos M/D/c refinement interpolated in CV^2; at c = 1 both reduce
exactly to the paper's P-K wait (eq 5). ``repro.core.mgc``'s docstring
gives the approximations' error against its c-server DES.

The host mirrors (``erlang_c_np``, ``mgc_wait_np``) are NumPy, as in the
JAX package. The objective and its solver are float64 torch on the host:
``solve_mgc`` runs the reference's projected gradient ascent with the
gradient from ``torch.autograd`` in place of ``jax.grad`` (the Lambert-W
fixed point of Sec III-B is P-K-specific).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..compat import CONTROL_DTYPE
from .fixed_point import project
from .params import Problem, as_control
from .queueing import service_moments

Tensor = torch.Tensor

#: Wait-term variants accepted by :func:`mean_wait_mgc` (see module docs).
MGC_CORRECTIONS = ("lee-longton", "cosmetatos")


def erlang_c(c, a: Tensor, c_max: int | None = None) -> Tensor:
    """Erlang-C probability of waiting, offered load a = lam E[S], c servers.

    The stable iterative Erlang-B recursion B(0) = 1, B(k) = a B / (k + a B),
    then C = B / (1 - rho + rho B). ``c`` may be an int or an integer tensor
    batched against ``a``; then ``c_max`` (the largest c) sets the depth
    and each lane freezes its B at its own c.
    """
    if c_max is None:
        c_max = int(c)
    c_t = torch.as_tensor(c)
    a = as_control(a)
    b = torch.ones_like(a)
    for k in range(1, int(c_max) + 1):
        b = torch.where(k <= c_t, a * b / (k + a * b), b)
    rho = a / c_t
    return b / torch.clamp(1.0 - rho * (1.0 - b), min=1e-12)


def erlang_c_np(c, a) -> np.ndarray:
    """Host-f64 mirror of :func:`erlang_c` (vectorized over cells)."""
    c = np.asarray(c)
    a = np.asarray(a, dtype=np.float64)
    b = np.ones_like(np.broadcast_arrays(a, c)[0], dtype=np.float64)
    for k in range(1, int(c.max()) + 1):
        b = np.where(k <= c, a * b / (k + a * b), b)
    rho = a / c
    return b / np.clip(1.0 - rho * (1.0 - b), 1e-12, None)


def _wait_factor(cv2, rho, c, correction: str, xp=torch):
    """Multiplier on E[W_{M/M/c}] for the chosen approximation family
    (``xp``: torch for the solver path, np for the host mirror)."""
    if correction == "lee-longton":
        return (1.0 + cv2) / 2.0
    if correction == "cosmetatos":
        # rho = 0 makes the correction 0/0 while the wait is 0: the inner
        # where keeps the division (and its gradient) finite
        pos = rho > 0.0
        f = xp.where(pos,
                     (1.0 - rho) * (c - 1.0)
                     * (xp.sqrt(4.0 + 5.0 * c) - 2.0)
                     / xp.where(pos, 16.0 * rho * c, 1.0),
                     0.0)
        return (1.0 - cv2) / 2.0 * (1.0 + f) + cv2
    raise ValueError(f"unknown correction {correction!r} "
                     f"(expected one of {MGC_CORRECTIONS})")


def mean_wait_mgc(problem: Problem, lengths: Tensor, c_servers,
                  c_max: int | None = None,
                  correction: str = "lee-longton") -> Tensor:
    """Approximate E[W] for M/G/c; ``lengths`` may carry leading batch axes
    ``[..., N]`` and ``c_servers`` broadcasts against them."""
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    cv2 = torch.clamp(m.es2 / torch.clamp(m.es ** 2, min=1e-30) - 1.0,
                      min=0.0)
    c = torch.as_tensor(c_servers, dtype=CONTROL_DTYPE)
    a = sp.lam * m.es
    rho = a / c
    pw = erlang_c(torch.as_tensor(c_servers), a,
                  c_max if c_max is not None else int(c.max()))
    w_mmc = pw * m.es / (c * torch.clamp(1.0 - rho, min=1e-9))
    return _wait_factor(cv2, rho, c, correction) * w_mmc


def mean_system_time_mgc(problem: Problem, lengths: Tensor, c_servers,
                         c_max: int | None = None,
                         correction: str = "lee-longton") -> Tensor:
    """E[T_sys] = E[W_{M/G/c}] + E[S] (the eq 6 analogue)."""
    m = service_moments(problem.tasks, lengths, problem.server.lam)
    return mean_wait_mgc(problem, lengths, c_servers, c_max, correction) + m.es


def mgc_wait_np(tasks, lengths, lam, c_servers,
                correction: str = "lee-longton") -> np.ndarray:
    """Host-f64 mirror of :func:`mean_wait_mgc` over ``[..., N]`` cells;
    unstable cells (lam E[S] >= c) return +inf."""
    lengths = np.asarray(lengths, dtype=np.float64)
    t = np.asarray(tasks.t0) + np.asarray(tasks.c) * lengths
    pi = np.asarray(tasks.pi)
    es = np.sum(pi * t, axis=-1)
    es2 = np.sum(pi * t * t, axis=-1)
    cv2 = np.clip(es2 / np.clip(es ** 2, 1e-30, None) - 1.0, 0.0, None)
    a = np.asarray(lam, dtype=np.float64) * es
    c = np.asarray(c_servers)
    rho = a / c
    pw = erlang_c_np(c, a)
    with np.errstate(divide="ignore", invalid="ignore"):
        w_mmc = pw * es / (c * (1.0 - rho))
        w = _wait_factor(cv2, rho, c, correction, xp=np) * w_mmc
    return np.where(rho < 1.0, w, np.inf)


def objective_mgc(problem: Problem, lengths: Tensor, c_servers,
                  c_max: int | None = None,
                  correction: str = "lee-longton") -> Tensor:
    """J_c(l) = alpha E[p] - E[W_{M/G/c}] - E[S]; -inf outside rho/c < 1.
    At c = 1 it equals ``core.objective.objective``."""
    tasks, sp = problem.tasks, problem.server
    m = service_moments(tasks, lengths, sp.lam)
    rho = m.rho / torch.as_tensor(c_servers, dtype=CONTROL_DTYPE)
    acc = torch.sum(tasks.pi * tasks.accuracy(lengths), dim=-1)
    j = (sp.alpha * acc
         - mean_wait_mgc(problem, lengths, c_servers, c_max, correction)
         - m.es)
    return torch.where(rho < 1.0, j, torch.full_like(j, -torch.inf))


class MGcResult(NamedTuple):
    lengths: Tensor
    value: Tensor
    iterations: int


def solve_mgc(problem: Problem, c_servers: int, tol: float = 1e-8,
              max_iters: int = 50_000,
              correction: str = "lee-longton") -> MGcResult:
    """Projected gradient ascent on the M/G/c objective, the reference's
    step rule (grow 1.2x on an ascent, halve on a descent), the gradient
    from ``torch.autograd``."""
    sp = problem.server

    def jfun(l):
        return objective_mgc(problem, l, c_servers, correction=correction)

    def gfun(l):
        l = l.detach().requires_grad_(True)
        return torch.autograd.grad(jfun(l), l)[0]

    l = torch.zeros(problem.tasks.n_tasks, dtype=CONTROL_DTYPE)
    eta = 1.0
    it = 0
    j_prev = float(jfun(l))
    while it < max_iters:
        g = gfun(l)
        cand = project(l + eta * g, sp.l_max)
        j_new = float(jfun(cand))
        if not math.isfinite(j_new) or j_new < j_prev - 1e-12:
            eta *= 0.5
            if eta < 1e-12:
                break
            it += 1
            continue
        moved = float(torch.max(torch.abs(cand - l)))
        l, j_prev = cand, j_new
        eta *= 1.2
        it += 1
        if moved / max(eta, 1e-12) < tol:
            break
    return MGcResult(lengths=l, value=as_control(j_prev), iterations=it)


def pod_replica_tradeoff(problem: Problem, max_replicas: int = 8) -> list:
    """One shared-queue solve per replica count: ``[(c, J_c, l_c)]``."""
    out = []
    for c in range(1, max_replicas + 1):
        r = solve_mgc(problem, c)
        out.append((c, float(r.value), r.lengths.numpy()))
    return out

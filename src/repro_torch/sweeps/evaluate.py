"""Couple solved grid cells to the analytic P-K curve and the batched DES.

For every cell ``(lam_c, l_c)`` of a solved operating grid this module
computes

* the Pollaczek-Khinchine steady-state prediction (eqs 5-6) at the cell's
  budgets, and
* a Monte-Carlo estimate from the batched Lindley simulator
  (``queueing_sim.batched``), with 95% confidence half-widths over seeds,

and reports the analytic-vs-DES gap per cell. All cells share one
common-random-number :class:`~repro_torch.queueing_sim.workload.StreamBatch`:
the batch is generated once at unit rate and each cell's arrival times are
the same underlying exponential draws scaled by ``1/lam_c`` (numpy's
``exponential(scale)`` is ``scale *`` the standard draw, so this matches
``generate_streams(lam_c)`` up to cumsum round-off) — gaps between cells
are therefore differences in *operating point*, not in sampling noise.

Near saturation the finite-horizon DES mean is biased low (the queue has
not mixed); ``warmup_frac`` discards the head of every stream before
averaging, which is what the heavy-traffic validation grids use.

``backend="numpy"`` (the default) runs the DES on the host;
``backend="torch"`` runs it through the CUDA lanes of ``csrc/des_scan.cu``
(``des_lindley``, ``des_free_server``, ``des_windowed``) on ``device``,
each bitwise equal to its plain version, so both backends give the same
numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.mgc import mgc_wait_np
from ..core.params import TaskSet
from ..queueing_sim.batched import _lindley
from ..queueing_sim.disciplines import (DEFAULT_WINDOW, discipline_keys,
                                        srpt_start_finish,
                                        windowed_start_finish)
from ..queueing_sim.mg1 import accuracy_np
from ..queueing_sim.multiserver import _dispatch as _mgc_dispatch
from ..queueing_sim.stats import ci95
from ..queueing_sim.workload import StreamBatch, generate_streams

__all__ = ["GridEvaluation", "evaluate_cells", "evaluate_solution"]


@dataclasses.dataclass(frozen=True)
class GridEvaluation:
    """Per-cell analytic-vs-DES comparison; all arrays are ``[C]``."""

    lam: np.ndarray
    lengths: np.ndarray             # [C, N] budgets actually simulated
    # Pollaczek-Khinchine steady state (eqs 5-6)
    pk_wait: np.ndarray
    pk_system_time: np.ndarray
    pk_rho: np.ndarray
    pk_accuracy: np.ndarray         # E[p] = sum_k pi_k p_k(l_k)
    # batched-DES estimates (seed means) + 95% half-widths over seeds
    des_wait: np.ndarray
    des_system_time: np.ndarray
    des_accuracy: np.ndarray        # realized fraction correct (Bernoulli)
    des_accuracy_prob: np.ndarray   # mean p over simulated queries
    des_utilization: np.ndarray
    ci_wait: np.ndarray
    ci_system_time: np.ndarray
    # coupling
    gap_system_time: np.ndarray     # des - pk
    covered: np.ndarray             # |gap| <= ci_system_time
    n_seeds: int
    n_queries: int
    warmup: int                     # queries discarded per stream
    c: np.ndarray | None = None     # [C] servers per cell (None = all 1)

    def objective(self, alpha) -> np.ndarray:
        """Realized J = alpha E[p] - E[T_sys] per cell (affine in alpha).

        Same convention as ``SweepResult.objective_at``: the accuracy term
        is the mean success probability over the *simulated* queries
        (realized type mixture), the delay term the simulated mean system
        time — so a whole alpha grid costs no extra simulation.
        """
        return np.asarray(alpha) * self.des_accuracy_prob \
            - self.des_system_time


def evaluate_cells(tasks: TaskSet, lam, lengths, *, n_seeds: int = 8,
                   n_queries: int = 10_000, seed: int = 0,
                   backend: str = "numpy", warmup_frac: float = 0.0,
                   base: StreamBatch | None = None,
                   discipline: str = "fifo", c=1,
                   window: int = DEFAULT_WINDOW,
                   max_chunk_elems: int = 2 ** 24,
                   device=None) -> GridEvaluation:
    """Evaluate ``[C]`` cells of ``(lam, lengths[C, N])`` against P-K + DES.

    ``base`` may supply a pre-generated unit-rate (``lam=1``) stream batch
    to share across calls; otherwise one is drawn from ``seed``. Cells are
    processed in chunks of at most ``max_chunk_elems`` array elements so a
    large grid never materializes a ``[C, S, n]`` tensor at once.

    ``discipline`` selects the simulated service order; the ``pk_*``
    columns are always the FIFO Pollaczek-Khinchine steady state, so under
    SJF/priority ``gap_system_time`` measures the discipline's gain over
    the paper's FIFO analysis (and ``covered`` is only a validation
    criterion for ``discipline="fifo"``). Unstable cells (rho >= 1) have
    infinite P-K predictions and are never ``covered``.

    ``c`` (int or ``[C]`` per-cell server counts, FIFO only) switches the
    DES to the batched M/G/c next-free-server kernel and the ``pk_*``
    columns to the Erlang-C/Lee-Longton prediction (identical to P-K at
    c = 1; see ``core.mgc`` for the documented approximation error —
    ``covered`` then absorbs both Monte-Carlo and approximation error, so
    heavy-traffic cells validate tightest). ``des_utilization`` is per
    server, and stability is the c-server condition rho / c < 1.

    ``backend="torch"`` simulates on ``device`` (default the card, raising
    without one; ``"cpu"`` runs the lanes' plain versions); SRPT has no
    lane and stays on the host.
    """
    lam = np.atleast_1d(np.asarray(lam, dtype=np.float64))
    lengths = np.asarray(lengths, dtype=np.float64)
    if lengths.ndim == 1:
        lengths = np.broadcast_to(lengths[None], (lam.shape[0],) +
                                  lengths.shape)
    C = lam.shape[0]
    c_cells = np.broadcast_to(np.asarray(c, dtype=np.int64), (C,))
    multi = bool(np.any(c_cells > 1))
    if multi and discipline != "fifo":
        raise ValueError("c > 1 cells are FIFO-only (the masked-argmin "
                         "engine is single-server)")
    if base is None:
        base = generate_streams(tasks, 1.0, n_seeds, n_queries, seed=seed)
    S, n = base.n_seeds, base.n_queries
    w = int(round(np.clip(warmup_frac, 0.0, 0.9) * n))

    t0 = np.asarray(tasks.t0)
    c_slope = np.asarray(tasks.c)
    pi = np.asarray(tasks.pi)
    t_table = t0 + c_slope * lengths                # [C, N]
    p_table = accuracy_np(tasks, lengths)           # [C, N]

    # analytic steady state per cell, f64 on host: P-K (eqs 3, 5, 6) on
    # the single-server path, Erlang-C/Lee-Longton on c-grids
    es = np.sum(pi * t_table, axis=-1)
    es2 = np.sum(pi * t_table * t_table, axis=-1)
    rho = lam * es
    if multi:
        pk_wait = mgc_wait_np(tasks, lengths, lam, c_cells)
    else:
        with np.errstate(divide="ignore", invalid="ignore"):
            pk_wait = np.where(rho < 1.0,
                               lam * es2 / (2.0 * (1.0 - rho)), np.inf)
    pk_sys = pk_wait + es
    pk_acc = np.sum(pi * p_table, axis=-1)

    chunk = max(1, int(max_chunk_elems // max(S * n, 1)))
    des_wait = np.empty((C, S))
    des_sys = np.empty((C, S))
    des_acc = np.empty((C, S))
    des_acc_prob = np.empty((C, S))
    des_util = np.empty((C, S))
    for lo in range(0, C, chunk):
        hi = min(lo + chunk, C)
        sl = slice(lo, hi)
        # CRN: unit-rate arrivals rescaled per cell
        arr = base.arrivals[None] / lam[sl, None, None]        # [c, S, n]
        services = t_table[sl][:, base.types]                  # [c, S, n]
        p_query = p_table[sl][:, base.types]                   # [c, S, n]
        if discipline == "fifo" and multi:
            # split the chunk by server count: c = 1 cells keep the
            # vectorized Lindley cumsum (the per-query panel recursion is
            # only needed where a free-server choice actually exists)
            start = np.empty_like(services)
            finish = np.empty_like(services)
            arr_b = np.broadcast_to(arr, services.shape)
            one = c_cells[sl] == 1
            if one.any():
                start[one], finish[one] = _lindley(arr_b[one],
                                                   services[one], backend,
                                                   device)
            if (~one).any():
                start[~one], finish[~one] = _mgc_dispatch(
                    arr_b[~one], services[~one],
                    np.broadcast_to(c_cells[sl][~one, None],
                                    services[~one].shape[:-1]),
                    backend, device)
        elif discipline == "fifo":
            start, finish = _lindley(arr, services, backend, device)
        elif discipline == "srpt":
            # preemptive kernel; start is the effective finish - service
            arr_b = np.broadcast_to(arr, services.shape)
            start, finish, _ = srpt_start_finish(arr_b, services,
                                                 window=window)
        else:
            arr_b = np.broadcast_to(arr, services.shape)
            keys = discipline_keys(discipline, arrivals=arr_b,
                                   services=services, accuracy=p_query)
            start, finish, _ = windowed_start_finish(
                arr_b, services, keys, window=window, backend=backend,
                device=device)
        tail = slice(w, None)
        des_wait[sl] = (start - arr)[..., tail].mean(axis=-1)
        des_sys[sl] = (finish - arr)[..., tail].mean(axis=-1)
        des_acc[sl] = (base.correct_us[None] <
                       p_query)[..., tail].mean(axis=-1)
        des_acc_prob[sl] = p_query[..., tail].mean(axis=-1)
        # utilization over the observation window [w-th arrival, last
        # finish]: count only the busy time inside the window (a service
        # straddling its left edge contributes its overlap, not its whole
        # duration, and warmup-era services contribute nothing), so the
        # estimate is a true time-average in [0, 1] even near saturation
        t_obs = arr[..., w]
        busy = np.maximum(finish - np.maximum(start, t_obs[..., None]),
                          0.0).sum(axis=-1)
        # max, not [..., -1]: under SJF/priority (or with c > 1 servers)
        # the last-arriving query need not finish last (same value bitwise
        # for single-server FIFO)
        span = finish.max(axis=-1) - t_obs
        des_util[sl] = busy / np.maximum(span, 1e-12) / c_cells[sl, None]

    gap = des_sys.mean(axis=-1) - pk_sys
    ci_sys = ci95(des_sys)
    return GridEvaluation(
        lam=lam, lengths=lengths,
        pk_wait=pk_wait, pk_system_time=pk_sys, pk_rho=rho,
        pk_accuracy=pk_acc,
        des_wait=des_wait.mean(axis=-1), des_system_time=des_sys.mean(axis=-1),
        des_accuracy=des_acc.mean(axis=-1),
        des_accuracy_prob=des_acc_prob.mean(axis=-1),
        des_utilization=des_util.mean(axis=-1),
        ci_wait=ci95(des_wait), ci_system_time=ci_sys,
        gap_system_time=gap,
        covered=(np.abs(gap) <= ci_sys) & (rho < c_cells),
        n_seeds=S, n_queries=n, warmup=w, c=c_cells,
    )


def evaluate_solution(tasks: TaskSet, sol, *, use: str = "int",
                      **kwargs) -> GridEvaluation:
    """Evaluate every cell of a :class:`~repro_torch.sweeps.solver_grid.GridSolution`.

    ``use`` selects the integer (``"int"``, default — what a server would
    deploy) or continuous (``"cont"``) optimum. Unstable/infeasible cells
    pass through: their P-K prediction is ``inf`` and ``covered`` is
    False. The grid's server axis (``GridSolution.c``) threads through to
    the DES/analytics automatically unless ``c`` is passed explicitly.
    """
    flat = sol.ravel()
    lengths = flat.lengths_int if use == "int" else flat.lengths_cont
    kwargs.setdefault("c", np.asarray(flat.c, dtype=np.int64))
    return evaluate_cells(tasks, flat.lam, lengths, **kwargs)

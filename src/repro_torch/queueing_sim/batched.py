"""Batched M/G/1 FIFO simulation via the Lindley recursion.

The legacy simulator (``mg1.simulate``) is a scalar Python heapq event loop.
That generality is only needed for the beyond-paper SJF/priority disciplines;
under FIFO — the paper's discipline — a non-preemptive single server obeys
the Lindley recursion

    start_i  = max(arrival_i, finish_{i-1})
    finish_i = start_i + service_i

which unrolls into the max-plus closed form

    finish_i = CS_i + max_{j<=i} (arrival_j - CS_{j-1}),   CS_i = sum_{k<=i} S_k

i.e. one cumulative sum plus one running maximum. This module implements
that two ways:

* **NumPy cumulative pass** (:func:`lindley_numpy`): ``cumsum`` +
  ``maximum.accumulate`` over the trailing query axis, vectorized over
  arbitrary leading batch axes — an entire (lambda-grid x policy x seed)
  sweep is a handful of O(total) array ops.
* **Torch lane** (:func:`lindley_torch`): the scan over queries as one
  CUDA kernel (``kernels/des_scan.py``, a thread a stream), float64,
  replicating the event loop's exact operation order; it takes the place
  of the JAX package's vmapped ``lax.scan`` (``lindley_jax``). On the
  CPU, when asked for, it runs the kernel's plain version.

Layered on top:

* :func:`simulate_fifo` — drop-in scalar replacement for
  ``mg1.simulate(..., discipline="fifo")`` (same :class:`SimResult`).
* :func:`simulate_fifo_batch` — a policy stack ``[P, N]`` against a
  :class:`StreamBatch` ``[S, n]`` in one call, returning ``[P, S]`` stats.
* :func:`sweep` / :class:`SweepResult` — the fig3/fig4 grid: policies x
  arrival rates x seeds with per-cell means, 95% confidence intervals, the
  analytic rho from ``core.queueing.service_moments``, and optional
  ``core.queueing.stability_clip`` projection of unstable cells.

SJF and priority ride the same sweep through the masked-argmin engine in
``queueing_sim.disciplines`` (``sweep(discipline=...)``); the heapq event
loop remains the asserted reference for all three disciplines.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from ..core.params import Problem, as_control
from ..core.queueing import service_moments, stability_clip
from ..kernels import des_scan
from .mg1 import SimResult, accuracy_np
from .stats import ci95
from .workload import Stream, StreamBatch, generate_streams

__all__ = [
    "lindley_numpy", "lindley_torch", "simulate_fifo", "simulate_fifo_batch",
    "sweep", "BatchStats", "SweepResult",
]


# --------------------------------------------------------------------------
# Lindley kernels
# --------------------------------------------------------------------------

def lindley_numpy(arrivals, services):
    """Vectorized FIFO start/finish times, ``[..., n] -> ([..., n], [..., n])``.

    One cumulative pass: O(n) work per stream, no Python loop over queries.
    Leading axes are independent streams (seeds, policies, arrival rates...).
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    cs = np.cumsum(services, axis=-1)
    # slack_j = arrival_j - CS_{j-1}; computed in place to keep the pass at
    # three large temporaries (cs, finish, start) for the whole grid
    finish = arrivals - cs
    finish += services
    np.maximum.accumulate(finish, axis=-1, out=finish)
    finish += cs
    start = finish - services
    return start, finish


def lindley_torch(arrivals, services, device=None):
    """The Lindley recursion as one CUDA kernel over flattened leading axes.

    Runs in float64 and reproduces the heapq event loop's operation order
    exactly, so it is bitwise-comparable to the reference DES. ``device``
    defaults to the card (raising without one); ``device="cpu"`` runs the
    kernel's plain version. Returns host numpy arrays shaped like the
    inputs.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    shape = arrivals.shape
    n = shape[-1]
    if n == 0 or arrivals.size == 0:
        return np.zeros(shape), np.zeros(shape)
    dev = resolve_device(device or DEFAULT_DEVICE)
    a = torch.from_numpy(np.ascontiguousarray(arrivals).reshape(-1, n))
    s = torch.from_numpy(np.ascontiguousarray(services).reshape(-1, n))
    st, fin = des_scan.lindley(a.to(dev), s.to(dev))
    return (st.cpu().numpy().reshape(shape), fin.cpu().numpy().reshape(shape))


def _lindley(arrivals, services, backend: str, device=None):
    if backend == "numpy":
        return lindley_numpy(arrivals, services)
    if backend == "torch":
        return lindley_torch(arrivals, services, device)
    raise ValueError(f"unknown backend {backend!r} (expected 'numpy'|'torch')")


# --------------------------------------------------------------------------
# Stats layers
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Per-cell statistics over leading batch axes (query axis reduced)."""

    mean_wait: np.ndarray
    mean_system_time: np.ndarray
    mean_service: np.ndarray
    utilization: np.ndarray
    accuracy: np.ndarray
    mean_accuracy_prob: np.ndarray
    objective: np.ndarray


def _service_table(problem: Problem, lengths: np.ndarray) -> np.ndarray:
    """t_k(l_k) for a stack of allocations, ``[..., N] -> [..., N]``."""
    t0 = np.asarray(problem.tasks.t0)
    c = np.asarray(problem.tasks.c)
    return t0 + c * np.asarray(lengths, dtype=np.float64)


def _accuracy_table(problem: Problem, lengths: np.ndarray) -> np.ndarray:
    """p_k(l_k) for a stack of allocations (shared f64 mirror of eq 2)."""
    return accuracy_np(problem.tasks, lengths)


def _batch_stats(problem: Problem, arrivals, services, start, finish,
                 p_query, correct_us) -> BatchStats:
    """Reduce per-query trajectories to per-cell statistics.

    ``arrivals``/``correct_us`` may have fewer leading axes than
    ``start``/``finish`` (streams shared across a policy stack); means are
    taken before broadcasting so no ``[P, S, n]`` temporaries materialize.
    """
    mean_arrival = np.asarray(arrivals).mean(axis=-1)
    mean_wait = start.mean(axis=-1) - mean_arrival
    mean_sys = finish.mean(axis=-1) - mean_arrival
    busy = services.sum(axis=-1)
    # max, not [..., -1]: under non-FIFO disciplines the last-arriving
    # query need not finish last (same value bitwise for FIFO)
    makespan = np.maximum(finish.max(axis=-1), 1e-12)
    acc_prob = p_query.mean(axis=-1)
    shape = np.broadcast_shapes(mean_wait.shape, acc_prob.shape)
    return BatchStats(
        mean_wait=np.broadcast_to(mean_wait, shape),
        mean_system_time=np.broadcast_to(mean_sys, shape),
        mean_service=np.broadcast_to(services.mean(axis=-1), shape),
        utilization=np.broadcast_to(busy / makespan, shape),
        accuracy=(correct_us < p_query).mean(axis=-1),
        mean_accuracy_prob=acc_prob,
        objective=problem.server.alpha * acc_prob - np.broadcast_to(
            mean_sys, shape),
    )


def _type_frequencies(types: np.ndarray, n_tasks: int) -> np.ndarray:
    """Realized type mixture per replicate, ``[S, n] -> [S, N]``."""
    S, n = types.shape
    idx = types + n_tasks * np.arange(S)[:, None]
    counts = np.bincount(idx.ravel(), minlength=S * n_tasks)
    return counts.reshape(S, n_tasks) / max(n, 1)


def _batch_stats_tabular(problem: Problem, t_table, p_table, types,
                         arrivals, correct_us, start, finish,
                         makespan) -> BatchStats:
    """Lean :class:`BatchStats` for table-driven services, ``-> [P, S]``.

    When every query's service time and accuracy come from per-task tables
    (the analytic model — not a custom ``service_time_fn``), the mixture
    statistics collapse onto the ``[S, N]`` type histogram: E[S], E[p] and
    the busy time are histogram-table inner products instead of
    ``[P, S, n]`` per-query passes, and only the delay means still touch
    the trajectories. Same definitions as :func:`_batch_stats` up to
    summation order (agreement ~1e-12 relative); ``makespan`` is the
    ``[P, S]`` end of the last busy period, which work conservation makes
    discipline-independent.
    """
    n = arrivals.shape[-1]
    freq = _type_frequencies(types, t_table.shape[-1])         # [S, N]
    mean_arrival = arrivals.mean(axis=-1)                      # [S]
    mean_start = start.mean(axis=-1)                           # [P, S]
    mean_finish = finish.mean(axis=-1)                         # [P, S]
    mean_service = freq @ t_table.T                            # [S, P]
    acc_prob = (freq @ p_table.T).T                            # [P, S]
    P = t_table.shape[0]
    accuracy = np.empty((P, arrivals.shape[0]))
    for p in range(P):
        accuracy[p] = (correct_us < p_table[p][types]).mean(axis=-1)
    mean_sys = mean_finish - mean_arrival
    return BatchStats(
        mean_wait=mean_start - mean_arrival,
        mean_system_time=mean_sys,
        mean_service=mean_service.T,
        utilization=n * mean_service.T / np.maximum(makespan, 1e-12),
        accuracy=accuracy,
        mean_accuracy_prob=acc_prob,
        objective=problem.server.alpha * acc_prob - mean_sys,
    )


def simulate_fifo(problem: Problem, lengths, stream: Stream,
                  backend: str = "numpy", device=None) -> SimResult:
    """Drop-in fast path for ``mg1.simulate(problem, lengths, stream)``.

    FIFO only. Agrees with the heapq reference within ~1e-10 on identical
    streams (see ``tests/test_batched_sim.py``).
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    n = len(stream.queries)
    n_tasks = problem.tasks.n_tasks
    if n == 0:
        return SimResult(mean_wait=0.0, mean_system_time=0.0,
                         mean_service=0.0, utilization=0.0, accuracy=0.0,
                         mean_accuracy_prob=0.0, objective=0.0,
                         per_task_system_time=np.zeros(n_tasks),
                         per_task_count=np.zeros(n_tasks, dtype=np.int64),
                         n=0)
    types = np.array([q.task for q in stream.queries])
    arrivals = np.array([q.arrival for q in stream.queries])
    us = np.array([q.correct_u for q in stream.queries])
    services = _service_table(problem, lengths)[types]
    start, finish = _lindley(arrivals, services, backend, device)
    p_query = _accuracy_table(problem, lengths)[types]
    stats = _batch_stats(problem, arrivals, services, start, finish,
                         p_query, us)
    sys_times = finish - arrivals
    per_task_sys = np.zeros(n_tasks)
    per_task_cnt = np.bincount(types, minlength=n_tasks)
    for k in range(n_tasks):
        if per_task_cnt[k]:
            per_task_sys[k] = sys_times[types == k].mean()
    return SimResult(
        mean_wait=float(stats.mean_wait),
        mean_system_time=float(stats.mean_system_time),
        mean_service=float(stats.mean_service),
        utilization=float(stats.utilization),
        accuracy=float(stats.accuracy),
        mean_accuracy_prob=float(stats.mean_accuracy_prob),
        objective=float(stats.objective),
        per_task_system_time=per_task_sys,
        per_task_count=per_task_cnt,
        n=n,
    )


def simulate_fifo_batch(problem: Problem, lengths, batch: StreamBatch,
                        backend: str = "numpy", metrics=None,
                        device=None) -> BatchStats:
    """Simulate a policy stack against a seed batch in one call.

    ``lengths``: ``[N]`` or ``[P, N]`` token budgets; ``batch``: ``[S, n]``
    streams. Returns :class:`BatchStats` with shape ``[S]`` or ``[P, S]``.

    ``metrics`` (an ``obs.metrics.MetricsRegistry``) folds the full
    per-query wait / system-time distributions into the ``des.wait`` /
    ``des.system_time`` streaming histograms — one vectorized pass over
    the whole ``[P, S, n]`` tensor, so percentile-grade statistics ride a
    sweep for a few integer passes. Because histogram snapshots merge
    associatively, per-seed lanes folded separately (e.g. by
    ``obs.metrics.histogram_per_lane``) combine bit-identically with this
    whole-tensor fold. ``metrics=None`` (default) costs one ``is None``
    check.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    single = lengths.ndim == 1
    L = lengths[None, :] if single else lengths          # [P, N]
    t_table = _service_table(problem, L)                 # [P, N]
    p_table = _accuracy_table(problem, L)                # [P, N]
    services = t_table[:, batch.types]                   # [P, S, n]
    start, finish = _lindley(batch.arrivals, services, backend, device)
    if metrics is not None:
        metrics.histogram("des.wait").record_many(start - batch.arrivals)
        metrics.histogram("des.system_time").record_many(
            finish - batch.arrivals)
        metrics.counter("des.queries").inc(start.size)
    stats = _batch_stats_tabular(problem, t_table, p_table, batch.types,
                                 batch.arrivals, batch.correct_us, start,
                                 finish, finish[..., -1])
    if single:
        stats = BatchStats(**{f.name: getattr(stats, f.name)[0]
                              for f in dataclasses.fields(BatchStats)})
    return stats


# --------------------------------------------------------------------------
# Sweep layer: (arrival rate x policy x seed) grids in one batched call
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Aggregated (lambda x policy) grid; all per-cell arrays are ``[L, P]``.

    ``mean_*``/``utilization``/``accuracy``/``objective`` are means over the
    seed axis; ``ci_*`` are 95% normal-approximation half-widths over seeds.
    ``rho_analytic`` is the Pollaczek-Khinchine utilization from
    ``service_moments`` at the (possibly stability-clipped) budgets actually
    simulated, recorded in ``lengths`` ``[L, P, N]``.

    ``stable`` marks cells whose simulated operating point satisfies
    rho < 1; statistics of unstable cells (a zero-token baseline already at
    or beyond saturation cannot be projected into the stability slab by
    ``stability_clip``) are NaN rather than finite-horizon garbage.
    ``discipline`` records the service order simulated; ``overflow_frac``
    is the per-cell fraction of seed streams that took the heapq fallback
    of the masked-argmin engine (always 0 under FIFO).
    """

    lams: np.ndarray
    policy_names: tuple
    lengths: np.ndarray
    rho_analytic: np.ndarray
    mean_wait: np.ndarray
    mean_system_time: np.ndarray
    utilization: np.ndarray
    accuracy: np.ndarray
    mean_accuracy_prob: np.ndarray
    objective: np.ndarray
    ci_wait: np.ndarray
    ci_system_time: np.ndarray
    ci_objective: np.ndarray
    n_seeds: int
    n_queries: int
    stable: np.ndarray | None = None
    overflow_frac: np.ndarray | None = None
    discipline: str = "fifo"
    c_servers: int = 1

    def objective_at(self, alpha: float) -> np.ndarray:
        """Re-weight the realized objective post-hoc for an alpha sweep.

        J = alpha * E[p] - E[T_sys] is affine in alpha given the simulated
        accuracy and delay, so a whole alpha grid costs no extra simulation.
        """
        return alpha * self.mean_accuracy_prob - self.mean_system_time

    def cell(self, lam_idx: int, policy: str) -> dict:
        p = self.policy_names.index(policy)
        return {
            "lam": float(self.lams[lam_idx]),
            "lengths": self.lengths[lam_idx, p],
            "rho_analytic": float(self.rho_analytic[lam_idx, p]),
            "mean_wait": float(self.mean_wait[lam_idx, p]),
            "mean_system_time": float(self.mean_system_time[lam_idx, p]),
            "utilization": float(self.utilization[lam_idx, p]),
            "accuracy": float(self.accuracy[lam_idx, p]),
            "objective": float(self.objective[lam_idx, p]),
            "ci_system_time": float(self.ci_system_time[lam_idx, p]),
        }


def _grid_budgets(problem: Problem, policies, lams, clip_unstable: bool,
                  margin: float, c_servers: int = 1):
    """Per-cell (possibly clipped) budgets for a (lambda x policy) grid.

    Returns ``(names, lengths [L, P, N], rho [L, P], masked [L, P])``;
    ``masked`` marks cells still at rho >= c after a *requested* clip (a
    baseline past saturation cannot be projected into the slab — see
    :func:`~repro_torch.core.queueing.stabilizable`) — their simulation
    is skipped and
    their statistics NaN. ``c_servers`` threads the M/G/c stability
    condition rho / c < 1 through the clip and the mask, so multi-server
    cells are not spuriously clipped against the single-server slab
    (``rho`` itself stays the *offered* load lam E[S]). With
    ``clip_unstable=False`` nothing is masked: the caller explicitly asked
    for raw finite-horizon statistics, and ``SweepResult.stable`` still
    reports stability truthfully. Shared by :func:`sweep`,
    ``disciplines.sweep_disciplines``, and ``multiserver.sweep_mgc``.
    """
    names = tuple(policies.keys())
    P = len(names)
    Lg = len(lams)
    n_tasks = problem.tasks.n_tasks
    for k in names:
        pk = np.asarray(policies[k], dtype=np.float64)
        # a scalar or mis-sized policy would otherwise broadcast (or
        # crash deep in np.stack / the service table) — fail loudly here
        if pk.shape != (n_tasks,):
            raise ValueError(
                f"policy {k!r} has shape {pk.shape}, expected "
                f"({n_tasks},) — one token budget per task type")
    base = np.stack([np.asarray(policies[k], dtype=np.float64)
                     for k in names])                      # [P, N]
    lengths = np.empty((Lg, P, base.shape[-1]))
    rho = np.empty((Lg, P))
    for i, lam in enumerate(lams):
        lp = base
        if clip_unstable:
            lp = stability_clip(problem.tasks, float(lam),
                                as_control(base), margin,
                                c_servers).numpy()
        lengths[i] = lp
        rho[i] = service_moments(problem.tasks, as_control(lp),
                                 float(lam)).rho.numpy()
    masked = (rho >= c_servers) if clip_unstable \
        else np.zeros_like(rho, bool)
    return names, lengths, rho, masked


def _sweep_result(problem: Problem, lams, names, lengths, rho, masked,
                  per_seed: Mapping[str, np.ndarray], overflow,
                  n_seeds: int, n_queries: int,
                  discipline: str) -> SweepResult:
    """Aggregate per-seed cell statistics ``[L, P, S]`` into a
    :class:`SweepResult`, NaN-masking ``masked`` (unstabilizable) cells.
    Shared by :func:`sweep` and ``disciplines.sweep_disciplines``."""
    nan = np.where(masked, np.nan, 0.0)
    agg = {name: slab.mean(axis=-1) + nan for name, slab in per_seed.items()}
    return SweepResult(
        lams=np.asarray(lams, dtype=np.float64),
        policy_names=names,
        lengths=lengths,
        rho_analytic=rho,
        mean_wait=agg["mean_wait"],
        mean_system_time=agg["mean_system_time"],
        utilization=agg["utilization"],
        accuracy=agg["accuracy"],
        mean_accuracy_prob=agg["mean_accuracy_prob"],
        objective=agg["objective"],
        ci_wait=ci95(per_seed["mean_wait"]) + nan,
        ci_system_time=ci95(per_seed["mean_system_time"]) + nan,
        ci_objective=ci95(per_seed["objective"]) + nan,
        n_seeds=n_seeds,
        n_queries=n_queries,
        stable=rho < 1.0,
        overflow_frac=overflow.mean(axis=-1),
        discipline=discipline,
    )


def sweep(problem: Problem, policies: Mapping[str, Sequence[float]],
          lams: Sequence[float], n_seeds: int = 16,
          n_queries: int = 10_000, seed: int = 0, backend: str = "numpy",
          clip_unstable: bool = True, margin: float = 1e-3,
          prompt_len_range=(16, 128), discipline: str = "fifo",
          window: int = 512,
          max_chunk_elems: int = 2 ** 24, device=None) -> SweepResult:
    """Monte-Carlo (lambda x policy x seed) grid in batched simulator calls.

    For every arrival rate, the same master ``seed`` regenerates the batch,
    so cells are common random numbers across policies, rates, AND
    disciplines (the exponential gaps at different rates are exact scalings
    of one another) — a fig3-style grid swept once per discipline compares
    service orders on identical sample paths.

    Budgets that would destabilize a cell (rho >= 1) are projected onto the
    stability slab with ``stability_clip`` when ``clip_unstable`` is set —
    mirroring what the projected solvers guarantee for their own iterates.
    Cells the clip cannot save (the zero-token baseline itself sits at
    rho_0 >= 1 - margin, so ``stability_clip`` returns l = 0 with
    rho = rho_0) are skipped and recorded with ``stable=False`` and NaN
    statistics instead of masquerading as clipped-stable simulations.
    With ``clip_unstable=False`` nothing is clipped, skipped, or
    NaN-masked — the caller gets raw finite-horizon statistics and
    ``stable`` still reports which cells sit at rho < 1.

    ``discipline`` selects FIFO (vectorized Lindley pass), SJF, or
    priority (masked-argmin engine from ``queueing_sim.disciplines`` with
    heapq fallback past ``window``). The grid is simulated in lambda-axis
    chunks of at most ``max_chunk_elems`` array elements, so large grids
    never materialize the full ``[L, P, S, n]`` tensors at once; chunking
    does not change any output bit (pinned by ``tests/test_batched_sim``).
    """
    if discipline != "fifo":
        # deferred: disciplines.py imports this module at load time
        from .disciplines import (discipline_keys, srpt_start_finish,
                                  windowed_start_finish)

    names, lengths, rho, masked = _grid_budgets(problem, policies, lams,
                                                clip_unstable, margin)
    Lg, P = rho.shape

    # per-seed cell statistics, filled lambda-chunk by lambda-chunk
    per_seed = {f.name: np.empty((Lg, P, n_seeds))
                for f in dataclasses.fields(BatchStats)}
    overflow = np.zeros((Lg, P, n_seeds), dtype=bool)
    chunk = max(1, int(max_chunk_elems // max(P * n_seeds * n_queries, 1)))
    for lo in range(0, Lg, chunk):
        hi = min(lo + chunk, Lg)
        todo = [i for i in range(lo, hi) if not masked[i].all()]
        if not todo:
            continue  # whole rows are NaN-masked anyway: skip simulating
        c = len(todo)
        services = np.empty((c, P, n_seeds, n_queries))
        arrivals = np.empty((c, 1, n_seeds, n_queries))
        p_query = np.empty((c, P, n_seeds, n_queries))
        us = np.empty((c, 1, n_seeds, n_queries))
        for j, i in enumerate(todo):
            batch = generate_streams(problem.tasks, float(lams[i]), n_seeds,
                                     n_queries, seed=seed,
                                     prompt_len_range=prompt_len_range)
            services[j] = _service_table(problem, lengths[i])[:, batch.types]
            p_query[j] = _accuracy_table(problem, lengths[i])[:, batch.types]
            arrivals[j, 0] = batch.arrivals
            us[j, 0] = batch.correct_us
        if discipline == "fifo":
            start, finish = _lindley(arrivals, services, backend, device)
        elif discipline == "srpt":
            arr_b = np.broadcast_to(arrivals, services.shape)
            start, finish, ovf = srpt_start_finish(arr_b, services,
                                                   window=window)
            overflow[todo] = ovf
        else:
            arr_b = np.broadcast_to(arrivals, services.shape)
            keys = discipline_keys(discipline, arrivals=arr_b,
                                   services=services, accuracy=p_query)
            start, finish, ovf = windowed_start_finish(
                arr_b, services, keys, window=window, backend=backend,
                device=device)
            overflow[todo] = ovf
        stats = _batch_stats(problem, arrivals, services, start, finish,
                             p_query, us)
        for name, slab in per_seed.items():
            slab[todo] = getattr(stats, name)

    return _sweep_result(problem, lams, names, lengths, rho, masked,
                         per_seed, overflow, n_seeds, n_queries, discipline)

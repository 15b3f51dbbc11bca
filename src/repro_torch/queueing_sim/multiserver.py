"""Batched M/G/c simulation: c data-parallel replicas behind one queue.

The paper's DES is single-server; a pod running c model replicas behind a
shared admission queue is an M/G/c system, the setting the analytic
Lee-Longton layer in ``core.mgc`` approximates. Under FIFO the c-server
sample path has the same shape as the Lindley recursion one level up: the
queries start in arrival order, each on the earliest-free server,

    start_i  = max(arrival_i, min_j free_j)
    finish_i = start_i + service_i,      free_{argmin_j} <- finish_i

i.e. one argmin over a ``[streams, c]`` free-time panel per query. The
panel recursion is inherently sequential in the query axis (this is the
Kiefer-Wolfowitz vector recursion; no cumulative closed form exists for
c > 1), so the batched kernels vectorize across *streams* — seeds,
policies, arrival-rate cells, and even per-stream server counts (absent
servers are pinned at ``free = +inf`` so the argmin never picks them) —
and pay one tiny [B, c] step per query:

* :func:`free_server_numpy` — numpy panel recursion, one Python step per
  query over the whole flattened batch.
* :func:`free_server_torch` — the same recursion as one CUDA kernel
  (``kernels/des_scan.py``, a thread a stream, the panel in registers) in
  f64; it takes the place of the JAX package's vmapped ``lax.scan``
  (``free_server_jax``).

Both agree with the heapq c-server oracle (``mg1.event_loop_mgc``)
*bitwise* per query — the heapq loop computes the identical
``max(arrival, min free)`` arithmetic — and match the Lindley fast path
at c = 1 to ~1e-11 (the closed-form cumsum reorders the float additions;
the sequential recursions themselves are identical).
``tests/test_multiserver.py`` pins both, plus the
Erlang-C/Lee-Longton cross-check at c in {2, 4} up to rho = 0.9 (see
``core.mgc`` for the approximation's documented error envelope).

Layered on top: :func:`simulate_mgc` (scalar ``SimResult`` drop-in),
:func:`simulate_mgc_batch` (policy stacks x seed batches), and
:func:`sweep_mgc` (the fig3-style (lambda x policy x seed) grid with the
c-server stability contract rho / c < 1 threaded through
``core.queueing.stability_clip``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from ..core.params import Problem
from ..kernels import des_scan
from .batched import (BatchStats, _accuracy_table, _batch_stats,
                      _batch_stats_tabular, _grid_budgets, _lindley,
                      _service_table, _sweep_result)
from .mg1 import (SimResult, empty_result, event_loop_mgc, mgc_prediction,
                  result_from_trajectory, stream_arrays)
from .workload import Stream, StreamBatch, generate_streams

__all__ = [
    "free_server_numpy", "free_server_torch", "simulate_mgc",
    "simulate_mgc_batch", "sweep_mgc", "mgc_prediction",
]


def _free_panel(c_servers, leading_shape) -> np.ndarray:
    """Initial ``[B, c_max]`` server free times; absent servers at +inf.

    ``c_servers`` is an int or an integer array broadcastable to
    ``leading_shape`` (per-stream replica counts — e.g. one arrival-rate
    cell per pod size); the panel width is the batch-wide maximum and the
    argmin can never select a lane with ``free = +inf``.
    """
    c = np.broadcast_to(np.asarray(c_servers, dtype=np.int64),
                        leading_shape).reshape(-1)
    if np.any(c < 1):
        raise ValueError("c_servers must be >= 1")
    c_max = int(c.max()) if c.size else 1
    free = np.zeros((c.shape[0], c_max))
    free[np.arange(c_max)[None, :] >= c[:, None]] = np.inf
    return free


def free_server_numpy(arrivals, services, c_servers) -> tuple:
    """FIFO M/G/c start/finish times, ``[..., n] -> ([..., n], [..., n])``.

    Leading axes are independent streams; ``c_servers`` broadcasts against
    them (int for a uniform pod). One Python step per query, vectorized
    across the flattened batch: argmin over the ``[B, c]`` free-time
    panel, ``start = max(arrival, free[argmin])``, scatter the finish
    back. At ``c_servers=1`` this is the sequential Lindley recursion
    (agreeing with the ``batched.lindley_numpy`` closed form to float
    round-off, ~1e-11, and with the heapq loop bitwise).
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    shape = arrivals.shape
    n = shape[-1]
    if n == 0 or arrivals.size == 0:
        return np.zeros(shape), np.zeros(shape)
    a = np.ascontiguousarray(arrivals).reshape(-1, n)
    s = np.ascontiguousarray(services).reshape(-1, n)
    free = _free_panel(c_servers, shape[:-1])
    B = a.shape[0]
    rows = np.arange(B)
    start = np.empty((B, n))
    finish = np.empty((B, n))
    for i in range(n):
        j = np.argmin(free, axis=1)
        st = np.maximum(a[:, i], free[rows, j])
        fi = st + s[:, i]
        start[:, i] = st
        finish[:, i] = fi
        free[rows, j] = fi
    return start.reshape(shape), finish.reshape(shape)


def free_server_torch(arrivals, services, c_servers, device=None) -> tuple:
    """One CUDA kernel for :func:`free_server_numpy` (f64).

    Same contract; the free-time panel of each stream lives in its
    thread's registers, one step per query (at most
    ``kernels.des_scan.MAX_C`` servers on the card). ``device`` defaults to
    the card (raising without one); ``device="cpu"`` runs the kernel's
    plain version. Returns host numpy arrays.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    shape = arrivals.shape
    n = shape[-1]
    if n == 0 or arrivals.size == 0:
        return np.zeros(shape), np.zeros(shape)
    free0 = _free_panel(c_servers, shape[:-1])
    dev = resolve_device(device or DEFAULT_DEVICE)
    a = torch.from_numpy(np.ascontiguousarray(arrivals).reshape(-1, n))
    s = torch.from_numpy(np.ascontiguousarray(services).reshape(-1, n))
    st, fi = des_scan.free_server(a.to(dev), s.to(dev),
                                  torch.from_numpy(free0).to(dev))
    return st.cpu().numpy().reshape(shape), fi.cpu().numpy().reshape(shape)


def _dispatch(arrivals, services, c_servers, backend: str,
              device=None) -> tuple:
    if backend == "numpy":
        return free_server_numpy(arrivals, services, c_servers)
    if backend == "torch":
        return free_server_torch(arrivals, services, c_servers, device)
    raise ValueError(f"unknown backend {backend!r} (expected 'numpy'|'torch')")


def _per_server_utilization(stats: BatchStats, c_servers) -> BatchStats:
    """Rescale busy-time utilization to per-server occupancy (rho / c)."""
    c = np.broadcast_to(np.asarray(c_servers, dtype=np.float64),
                        np.asarray(stats.utilization).shape)
    return dataclasses.replace(stats, utilization=stats.utilization / c)


def simulate_mgc(problem: Problem, lengths, stream: Stream,
                 c_servers: int, discipline: str = "fifo",
                 backend: str = "numpy",
                 service_time_fn=None, device=None) -> SimResult:
    """Scalar c-server drop-in for ``mg1.simulate(..., c_servers=...)``.

    FIFO runs the batched next-free-server kernel; SJF/priority keys fall
    back to the heapq oracle (``mg1.event_loop_mgc`` — the masked-argmin
    engine is single-server). Utilization is per server.
    """
    if discipline == "srpt":
        raise NotImplementedError("srpt is single-server only; use "
                                  "mg1.simulate / simulate_discipline")
    lengths = np.asarray(lengths, dtype=np.float64)
    if len(stream.queries) == 0:
        return empty_result(problem)
    types, arrivals, services, us, keys = stream_arrays(
        problem, lengths, stream, discipline, service_time_fn)
    if discipline == "fifo":
        start, finish = _dispatch(arrivals, services, c_servers, backend,
                                  device)
    else:
        start, finish = event_loop_mgc(arrivals, services, keys, c_servers)
    res = result_from_trajectory(problem, lengths, types, arrivals,
                                 services, us, start, finish)
    res.utilization /= c_servers
    return res


def simulate_mgc_batch(problem: Problem, lengths, batch: StreamBatch,
                       c_servers, backend: str = "numpy",
                       device=None) -> BatchStats:
    """``simulate_fifo_batch`` with a server axis.

    ``lengths``: ``[N]`` or ``[P, N]`` budgets; ``batch``: ``[S, n]``
    streams; ``c_servers``: int or array broadcastable to the stats shape
    (``[S]`` / ``[P, S]``). Returns :class:`BatchStats` with per-server
    utilization.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    single = lengths.ndim == 1
    L = lengths[None, :] if single else lengths          # [P, N]
    services = _service_table(problem, L)[:, batch.types]   # [P, S, n]
    p_query = _accuracy_table(problem, L)[:, batch.types]
    c = np.asarray(c_servers)
    if single and c.ndim == 1:
        c = c[None]                                       # align to [P, S]
    start, finish = _dispatch(batch.arrivals[None], services,
                              np.broadcast_to(c, services.shape[:-1]),
                              backend, device)
    stats = _batch_stats(problem, batch.arrivals[None], services, start,
                         finish, p_query, batch.correct_us[None])
    stats = _per_server_utilization(stats, np.broadcast_to(
        c, np.asarray(stats.utilization).shape))
    if single:
        stats = BatchStats(**{f.name: getattr(stats, f.name)[0]
                              for f in dataclasses.fields(BatchStats)})
    return stats


def sweep_mgc(problem: Problem, policies, lams, c_servers: int,
              n_seeds: int = 16, n_queries: int = 10_000, seed: int = 0,
              backend: str = "numpy", clip_unstable: bool = True,
              margin: float = 1e-3, prompt_len_range=(16, 128),
              device=None):
    """FIFO (lambda x policy x seed) grid on a c-server pod.

    The c-server analogue of ``batched.sweep``: common-random-number
    streams across rates and policies, budgets projected into the
    *c-server* stability slab lam E[S] <= c (1 - margin)
    (``stability_clip(c_servers=...)``) so multi-server cells are not
    spuriously clipped against the single-server condition, and cells
    whose zero-token load already sits at rho_0 >= c marked unstable with
    NaN statistics. ``SweepResult.rho_analytic`` records the *offered*
    load lam E[S] (erlangs); ``stable`` is rho < c.
    """
    names, lengths, rho, masked = _grid_budgets(problem, policies, lams,
                                                clip_unstable, margin,
                                                c_servers=c_servers)
    Lg, P = rho.shape
    per_seed = {f.name: np.empty((Lg, P, n_seeds))
                for f in dataclasses.fields(BatchStats)}
    overflow = np.zeros((Lg, P, n_seeds), dtype=bool)
    for i, lam in enumerate(lams):
        if masked[i].all():
            continue
        batch = generate_streams(problem.tasks, float(lam), n_seeds,
                                 n_queries, seed=seed,
                                 prompt_len_range=prompt_len_range)
        t_tab = _service_table(problem, lengths[i])          # [P, N]
        p_tab = _accuracy_table(problem, lengths[i])
        svc = t_tab[:, batch.types]                          # [P, S, n]
        if c_servers == 1:
            st, fin = _lindley(batch.arrivals[None], svc, backend, device)
        else:
            st, fin = _dispatch(batch.arrivals[None], svc, c_servers,
                                backend, device)
        stats = _batch_stats_tabular(problem, t_tab, p_tab, batch.types,
                                     batch.arrivals, batch.correct_us,
                                     st, fin, fin.max(axis=-1))
        stats = _per_server_utilization(stats, c_servers)
        for name, slab in per_seed.items():
            slab[i] = getattr(stats, name)
    res = _sweep_result(problem, lams, names, lengths, rho, masked,
                        per_seed, overflow, n_seeds, n_queries, "fifo")
    return dataclasses.replace(res, stable=rho < c_servers,
                               c_servers=c_servers)

"""Batched non-FIFO disciplines on the vectorized fast path.

Covers the non-preemptive SJF / priority orderings, preemptive SRPT, and
their *predicted-size* counterparts SPJF / SPRPT, where the scheduler
keys on a noisy service-time estimate (``data.predictor``) instead of
the true size — at zero prediction error SPJF is bitwise SJF and SPRPT
is bitwise SRPT (pinned in ``tests/test_prediction.py`` and
``benchmarks/prediction_bench.py``).

The heapq event loop (``mg1.simulate``) handles every discipline but runs
one scalar stream per Python call, so the discipline ablations could not
ride the (lambda x policy x seed) grids that the Lindley fast path in
``batched`` made cheap. This module closes that gap with a masked-argmin
event loop: arrivals are time-sorted, so at every service completion the
candidate set is a contiguous window of arrived-but-unserved queries, and
one ``argmin`` over masked per-query keys (ties break on query index,
matching the heapq's ``(key, qid)`` ordering) picks the next job.

Two kernels implement the O(n * window) pass:

* :func:`windowed_numpy` — busy-period form, loop-free over batch cells.
  A work-conserving non-preemptive single server has discipline-
  INDEPENDENT busy periods (the unfinished-workload path never depends on
  service order), so the FIFO Lindley pass from ``batched`` yields the
  busy-period partition once for every discipline. The first query of a
  busy period is always served first, length-<=2 periods are FIFO
  outright, and longer periods run the masked-argmin completion loop —
  bucketed by length and sorted into descending-length prefixes so every
  numpy op stays dense. Python-step count is bounded by the longest busy
  period, independent of ``n x batch``.
* :func:`windowed_torch` — sliding-window form: one step per completion
  over a fixed ``[window]`` candidate mask that slides past served
  prefixes, as one CUDA kernel (``kernels/des_scan.py``, a warp a
  stream) in f64; it takes the place of the JAX package's vmapped
  ``lax.scan`` (``windowed_jax``).

Both kernels flag streams whose candidate window ever exceeds ``window``
(default ``DEFAULT_WINDOW`` = 512); :func:`windowed_start_finish` re-runs
exactly the flagged streams through the heapq reference
(``mg1.event_loop``), so every stream is exact regardless of window size.
``tests/test_disciplines.py`` pins per-query start/finish agreement with
the reference at 1e-10 across disciplines, backends, and overflowing
windows.

Preemptive disciplines run on a separate two-panel kernel
(:func:`srpt_numpy` / :func:`sprpt_numpy`, shared implementation): a
*true-remaining* panel governs completions and elapsed work while the
scheduler's argmin runs on a *key-remaining* panel — identical for SRPT,
the predictor's noisy estimate for SPRPT (an underestimated long job can
monopolize the server, which is exactly the tail pathology the
prediction-error frontier in ``sweeps.prediction`` measures). Both fall
back to the heapq references ``mg1.srpt_event_loop`` /
``mg1.sprpt_event_loop`` on window overflow.

On top of the kernels: :func:`simulate_discipline` (scalar drop-in for
``mg1.simulate``), :func:`simulate_batch` (policy stacks x seed batches,
any discipline), and :func:`discipline_keys` — the one definition of the
per-query priority keys, shared with ``mg1.simulate``,
``serving.scheduler``, ``serving.replay``, and the masked-argmin engine.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from ..core.params import Problem
from ..kernels import des_scan
from .batched import (_accuracy_table, _batch_stats, _batch_stats_tabular,
                      _grid_budgets, _lindley, _service_table,
                      _sweep_result, BatchStats, lindley_numpy,
                      simulate_fifo_batch)
from .mg1 import (SimResult, empty_result, event_loop,
                  result_from_trajectory, sprpt_event_loop,
                  srpt_event_loop, stream_arrays)
from .workload import Stream, StreamBatch, generate_streams

__all__ = [
    "DISCIPLINES", "PREEMPTIVE_DISCIPLINES", "PREDICTED_DISCIPLINES",
    "ALL_DISCIPLINES", "DEFAULT_WINDOW", "discipline_keys",
    "windowed_numpy", "windowed_torch", "windowed_start_finish",
    "srpt_numpy", "srpt_start_finish", "sprpt_numpy", "sprpt_start_finish",
    "simulate_discipline", "simulate_batch", "sweep_disciplines",
]

#: Non-preemptive disciplines served by the masked-argmin engine.
DISCIPLINES = ("fifo", "sjf", "priority")

#: Preemptive disciplines with their own kernels (remaining-work state
#: cannot ride the completion-ordered masked-argmin pass).
PREEMPTIVE_DISCIPLINES = ("srpt", "sprpt")

#: Disciplines ordered by a *predicted* service time instead of the true
#: one (Mitzenmacher & Shahout): "spjf" = shortest predicted job first
#: (non-preemptive; rides the masked-argmin engine with predicted keys),
#: "sprpt" = shortest predicted remaining processing time (preemptive;
#: its own panel kernel). Both require a per-query ``predicted`` array
#: and reduce bitwise to SJF / SRPT when ``predicted == services``.
PREDICTED_DISCIPLINES = ("spjf", "sprpt")

ALL_DISCIPLINES = DISCIPLINES + ("spjf",) + PREEMPTIVE_DISCIPLINES

#: Fixed capacity of the masked-argmin candidate window. Streams whose
#: arrived-but-unserved span ever exceeds it fall back to the heapq loop.
DEFAULT_WINDOW = 512


def discipline_keys(discipline: str, *, arrivals=None, services=None,
                    accuracy=None, predicted=None):
    """Service-priority keys (lower = served first), any leading shape.

    * ``fifo``: the arrival time — queue order is arrival order.
    * ``sjf``: the service time t_k(l_k) — shortest job first.
    * ``priority``: ``-accuracy / service`` — highest marginal accuracy
      per second of service first (the eq-7 utility numerator per unit of
      occupied server time; beyond-paper ablation).
    * ``srpt``: the *remaining* work, which at admission time equals the
      full service time — the key a non-preemptive admission queue (the
      serving scheduler) orders SRPT work by; the DES engines instead
      track remaining work through preemptions (:func:`srpt_numpy`,
      ``mg1.srpt_event_loop``).
    * ``spjf`` / ``sprpt``: the *predicted* service time (``predicted``
      is required — e.g. ``data.predictor.LengthPredictor.predict`` over
      the true services). At admission the predicted remaining equals
      the full prediction, so both share the key; the preemptive DES
      kernels (:func:`sprpt_numpy`, ``mg1.sprpt_event_loop``) track
      predicted remaining through preemptions.

    When both ``predicted`` and ``services`` are given their shapes must
    match exactly — a mis-sized prediction array raises ``ValueError``
    rather than silently broadcasting to the wrong queries.

    This is the single numerical definition used by the heapq reference
    (``mg1.simulate``), the vectorized engine here, and the serving
    scheduler's admission heap, so the three stay key-compatible.
    """
    if discipline == "fifo":
        return np.asarray(arrivals, dtype=np.float64)
    if discipline in ("sjf", "srpt"):
        return np.asarray(services, dtype=np.float64)
    if discipline in PREDICTED_DISCIPLINES:
        if predicted is None:
            raise ValueError(
                f"discipline {discipline!r} requires a per-query "
                "'predicted' service-time array (see data.predictor)")
        p = np.asarray(predicted, dtype=np.float64)
        if services is not None:
            s = np.asarray(services, dtype=np.float64)
            if p.shape != s.shape:
                raise ValueError(
                    f"predicted service shape {p.shape} must match the "
                    f"services shape {s.shape} exactly (one prediction "
                    "per query; silent broadcasting is not allowed)")
        return p
    if discipline == "priority":
        s = np.asarray(services, dtype=np.float64)
        return -np.asarray(accuracy, dtype=np.float64) / np.maximum(s, 1e-12)
    raise ValueError(f"unknown discipline {discipline!r} "
                     f"(expected one of {ALL_DISCIPLINES})")


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _flatten(arrivals, services, keys):
    arrivals, services, keys = np.broadcast_arrays(arrivals, services, keys)
    shape = arrivals.shape
    n = shape[-1]
    B = arrivals.size // n if n else 0
    f64 = lambda x: np.ascontiguousarray(x, dtype=np.float64).reshape(B, n)
    return f64(arrivals), f64(services), f64(keys), shape, B, n


def windowed_numpy(arrivals, services, keys,
                   window: int = DEFAULT_WINDOW, fifo_finish=None):
    """Busy-period masked-argmin pass, ``[..., n] -> start/finish/overflow``.

    Leading axes are independent streams. Returns ``(start, finish,
    overflow)`` where ``overflow`` has the leading shape; a flagged
    stream's rows hold its FIFO schedule (defined but wrong for the
    requested keys) — use :func:`windowed_start_finish` for the exact
    heapq fallback. A busy period longer than ``window`` triggers the
    flag; the arrived-but-unserved candidate set is always contained in
    the current busy period, so this bound is conservative.

    ``fifo_finish`` may pass the precomputed FIFO Lindley finish times
    (same shape as ``arrivals``) to skip the internal pass — the sweep
    layer shares one pass across all disciplines of a grid.
    """
    start, finish, overflow = _windowed_numpy_multi(
        arrivals, services, [keys], window, fifo_finish)
    return start[0], finish[0], overflow


def _windowed_numpy_multi(arrivals, services, keys_list,
                          window: int = DEFAULT_WINDOW, fifo_finish=None):
    """K-lane core of :func:`windowed_numpy`.

    ``keys_list`` holds K per-query key arrays over the same
    arrival/service grid (e.g. SJF and priority lanes of one sweep). The
    busy structure is key-independent, so the Lindley pass, the
    busy-period split, the length-<=2 closed forms, the overflow flags,
    and all bucket setup except the key panel are computed once and shared
    across lanes. Returns ``(start[K, ...], finish[K, ...], overflow)``.
    """
    K = len(keys_list)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    shape = arrivals.shape
    n = shape[-1]
    B = arrivals.size // n if n else 0
    if n == 0 or B == 0:
        return (np.zeros((K,) + shape), np.zeros((K,) + shape),
                np.zeros(shape[:-1], dtype=bool))
    a = np.ascontiguousarray(arrivals, dtype=np.float64).reshape(B, n)
    s = np.ascontiguousarray(services, dtype=np.float64).reshape(B, n)
    fks = [np.ascontiguousarray(np.broadcast_to(kk, shape),
                                dtype=np.float64).reshape(-1)
           for kk in keys_list]
    # discipline-independent busy structure from the FIFO Lindley pass
    if fifo_finish is None:
        _, fin_f = lindley_numpy(a, s)
    else:
        fin_f = np.broadcast_to(fifo_finish, shape).reshape(B, n)
    new_bp = np.empty((B, n), dtype=bool)
    new_bp[:, 0] = True
    new_bp[:, 1:] = a[:, 1:] > fin_f[:, :-1]

    fa, fs = a.ravel(), s.ravel()
    Bn = B * n
    f = np.flatnonzero(new_bp.ravel())        # first query of each period
    L = np.diff(np.append(f, Bn))             # period lengths (never cross
    sb = f // n                               # streams: each stream's first
    overflow = np.zeros(B, dtype=bool)        # query starts a period)
    overflow[sb[L > window]] = True
    keep = ~overflow[sb]

    start = np.empty((K, Bn))
    finish = np.empty((K, Bn))
    ovf_rows = np.flatnonzero(overflow)
    if ovf_rows.size:
        # defined placeholder for flagged streams (see docstring)
        st_f = fin_f - s
        for b in ovf_rows:
            sl = slice(b * n, (b + 1) * n)
            start[:, sl] = st_f[b]
            finish[:, sl] = fin_f[b]

    # closed forms: a period's first query is served at its own arrival
    # under ANY non-preemptive discipline, and a length-2 period is FIFO
    # (its second query is the only candidate at the first completion).
    f1 = f[keep]
    fin1 = fa[f1] + fs[f1]
    start[:, f1] = fa[f1]
    finish[:, f1] = fin1
    f2 = f[keep & (L == 2)] + 1
    fin2a = fa[f2 - 1] + fs[f2 - 1]
    start[:, f2] = fin2a
    finish[:, f2] = fin2a + fs[f2]

    # length-3 periods close in two vectorized picks: query 1 has always
    # arrived by the head's finish (busy-period continuity), so the only
    # branch is whether query 2 has too — if so the masked argmin is a
    # two-way key comparison (ties to the earlier arrival), else FIFO.
    f3 = f[keep & (L == 3)]
    if f3.size:
        fin0 = fa[f3] + fs[f3]
        arrived2 = fa[f3 + 2] <= fin0
        for k, fk in enumerate(fks):
            two_first = arrived2 & (fk[f3 + 2] < fk[f3 + 1])
            i1 = f3 + np.where(two_first, 2, 1)
            i2 = f3 + np.where(two_first, 1, 2)
            start[k, i1] = fin0
            fin1 = fin0 + fs[i1]
            finish[k, i1] = fin1
            start[k, i2] = fin1
            finish[k, i2] = fin1 + fs[i2]

    # masked-argmin completion loop for longer periods, in length ranges;
    # setup (gathers, panels, ordering) is shared across the K key lanes
    for lo_b, bound in _buckets(window):
        exact = lo_b == bound
        sel = keep & (L >= lo_b) & (L <= bound)
        if not sel.any():
            continue
        fb, Lb = f[sel], L[sel]
        if exact:
            maxL = bound
        else:
            # descending-length order: at completion step t only the
            # leading prefix of rows is still active, keeping ops dense
            order = np.argsort(-Lb, kind="stable")
            fb, Lb = fb[order], Lb[order]
            maxL = int(Lb[0])
        M = fb.shape[0]
        offs = np.arange(maxL)
        if exact:
            idx = fb[:, None] + offs[None, :]
            arr_w = fa[idx]
            svc_w = fs[idx]
            valid = None
            active = np.full(maxL - 1, M)
        else:
            idx = np.minimum(fb[:, None] + offs[None, :], Bn - 1)
            valid = offs[None, :] < Lb[:, None]
            arr_w = np.where(valid, fa[idx], np.inf)
            svc_w = np.where(valid, fs[idx], 0.0)
            active = M - np.searchsorted(Lb[::-1], np.arange(1, maxL),
                                         side="right")
        head_fin = fa[fb] + fs[fb]
        # scratch panels: the masked-argmin step runs allocation-free,
        # with not-yet-arrived slots pushed out of contention by a huge
        # finite offset (0 for candidates, so candidate keys stay exact);
        # the loop only tracks the service permutation — start/finish are
        # reconstructed afterwards by one cumulative pass per period,
        # seeded with the head arrival so the summation order (and hence
        # every bit) matches the sequential event loop
        big = 1e300
        cand = np.empty((M, maxL), dtype=bool)
        masked = np.empty((M, maxL))
        rows = np.arange(M)
        for k, fk in enumerate(fks):
            if exact:
                key_w = fk[idx]
            else:
                key_w = np.where(valid, fk[idx], np.inf)
            key_w[:, 0] = np.inf              # head already served
            free_t = head_fin.copy()
            perm = np.zeros((M, maxL), dtype=np.int64)
            for t in range(1, maxL):
                Mt = int(active[t - 1])
                ft = free_t[:Mt]
                np.greater(arr_w[:Mt], ft[:, None], out=cand[:Mt])
                np.multiply(cand[:Mt], big, out=masked[:Mt])
                masked[:Mt] += key_w[:Mt]
                slot = np.argmin(masked[:Mt], axis=1)
                perm[:Mt, t] = slot
                free_t[:Mt] = ft + svc_w[rows[:Mt], slot]
                key_w[rows[:Mt], slot] = np.inf
            svc_o = np.take_along_axis(svc_w, perm, axis=1)
            ext = np.empty((M, maxL + 1))
            ext[:, 0] = fa[fb]
            ext[:, 1:] = svc_o
            start_o = np.cumsum(ext[:, :-1], axis=1)
            qid = fb[:, None] + perm
            if exact:
                start[k, qid.ravel()] = start_o.ravel()
                finish[k, qid.ravel()] = (start_o + svc_o).ravel()
            else:
                start[k, qid[valid]] = start_o[valid]
                finish[k, qid[valid]] = start_o[valid] + svc_o[valid]
    return (start.reshape((K,) + shape), finish.reshape((K,) + shape),
            overflow.reshape(shape[:-1]))


def _buckets(window: int) -> list:
    """(lo, hi) length ranges for the completion loop. Each range pays its
    own setup plus one loop iteration per completion step, so the split
    balances padding waste (finer is better) against dispatch overhead
    (coarser is better): an exact zero-padding block for the plentiful
    length-4 periods, x2 ranges to 16, then x4 for the sparse long tail."""
    bounds = []
    b, step = 4, 2
    prev = 3
    while b < window:
        bounds.append((prev + 1, b))
        prev = b
        if b >= 16:
            step = 4
        b *= step
    if prev < window:
        bounds.append((prev + 1, window))
    return bounds


def windowed_torch(arrivals, services, keys, window: int = DEFAULT_WINDOW,
                   device=None):
    """Sliding-window masked-argmin pass (f64) as one CUDA kernel.

    Same contract as :func:`windowed_numpy`; the overflow flag here is the
    instantaneous arrived-but-unserved span exceeding ``window`` (a
    slightly tighter condition than the busy-period bound, so the flags
    may differ between backends on marginal streams — results after the
    :func:`windowed_start_finish` fallback are identical). Streams are
    padded with ``window`` slots of +inf arrival and key and 0 service, as
    in the JAX package. ``device`` defaults to the card (raising without
    one); ``device="cpu"`` runs the kernel's plain version. The card takes
    windows up to ``kernels.des_scan.MAX_WINDOW``.
    """
    a, s, k, shape, B, n = _flatten(arrivals, services, keys)
    if n == 0 or B == 0:
        return (np.zeros(shape), np.zeros(shape),
                np.zeros(shape[:-1], dtype=bool))
    W = int(window)
    dev = resolve_device(device or DEFAULT_DEVICE)
    pad = np.full((B, W), np.inf)
    ap = torch.from_numpy(np.concatenate([a, pad], axis=1)).to(dev)
    sp = torch.from_numpy(np.concatenate([s, np.zeros((B, W))],
                                         axis=1)).to(dev)
    kp = torch.from_numpy(np.concatenate([k, pad], axis=1)).to(dev)
    st, fin, ovf = des_scan.windowed(ap, sp, kp, W)
    return (st.cpu().numpy().reshape(shape),
            fin.cpu().numpy().reshape(shape),
            ovf.cpu().numpy().reshape(shape[:-1]))


def windowed_start_finish(arrivals, services, keys,
                          window: int = DEFAULT_WINDOW,
                          backend: str = "numpy", fifo_finish=None,
                          device=None):
    """Exact per-query start/finish under arbitrary priority keys.

    Dispatches to the requested kernel, then replays any stream whose
    window overflowed through the heapq reference (``mg1.event_loop``), so
    the result is exact for every stream and any ``window >= 1``. Returns
    ``(start, finish, overflow)``; ``overflow`` reports which streams took
    the fallback. ``fifo_finish`` is forwarded to :func:`windowed_numpy`,
    ``device`` to :func:`windowed_torch`.
    """
    if backend == "numpy":
        start, finish, ovf = windowed_numpy(arrivals, services, keys, window,
                                            fifo_finish=fifo_finish)
    elif backend == "torch":
        start, finish, ovf = windowed_torch(arrivals, services, keys, window,
                                            device)
    else:
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected 'numpy'|'torch')")
    if ovf.any():
        start, finish, ovf = _apply_fallback(arrivals, services, keys,
                                             start, finish, ovf)
    return start, finish, ovf


def _apply_fallback(arrivals, services, keys, start, finish, ovf):
    """Replay overflowed streams through the heapq reference in place."""
    a, s, k = np.broadcast_arrays(arrivals, services, keys)
    shape = a.shape
    n = shape[-1]
    a2 = a.reshape(-1, n)
    s2 = s.reshape(-1, n)
    k2 = k.reshape(-1, n)
    # broadcast or read-only outputs; copy before patching
    if not start.flags.writeable:
        start = np.array(start, copy=True)
        finish = np.array(finish, copy=True)
    st2 = start.reshape(-1, n)
    fi2 = finish.reshape(-1, n)
    for b in np.flatnonzero(ovf.ravel()):
        st2[b], fi2[b] = event_loop(a2[b], s2[b], k2[b])
    return st2.reshape(shape), fi2.reshape(shape), ovf


# --------------------------------------------------------------------------
# preemptive SRPT kernel
# --------------------------------------------------------------------------

def _srpt_bucket(arr_w, svc_w, Lb, fin_o) -> None:
    """SRPT over one dense length-bucket of busy periods, in place.

    ``arr_w`` / ``svc_w`` are ``[M, maxL]`` per-period panels in arrival
    (= qid) order, inf/0-padded past each row's true length ``Lb``
    (descending). Columns ARE qid order, so ``np.argmin``'s first-index
    rule reproduces the heapq's (remaining, qid) tie-break exactly. At
    step k only the leading prefix of rows still has arrivals
    (descending-length sort); a row whose last arrival has passed sees
    ``ta = inf`` (the padding) and drains to completion. Float-op order
    matches ``mg1.srpt_event_loop`` term for term, so agreement is
    bitwise in practice.
    """
    M, maxL = arr_w.shape
    rem = np.full((M, maxL), np.inf)
    rem[:, 0] = svc_w[:, 0]              # the head job, served at arrival
    t = arr_w[:, 0].copy()
    rows = np.arange(M)

    def serve_until(Mt: int, ta: np.ndarray) -> None:
        sub, tt = rem[:Mt], t[:Mt]
        rr = rows[:Mt]
        bounded = np.isfinite(ta)
        while True:
            j = np.argmin(sub, axis=1)   # first min = lowest qid
            m = sub[rr, j]
            fin_t = tt + m
            can = np.isfinite(m) & (fin_t <= ta)
            if not can.any():
                act = np.isfinite(m) & bounded
                if act.any():
                    ra = rr[act]
                    sub[ra, j[act]] = m[act] - (ta[act] - tt[act])
                tt[bounded] = ta[bounded]
                return
            rc, jc = rr[can], j[can]
            tt[can] = fin_t[can]
            fin_o[rc, jc] = fin_t[can]
            sub[rc, jc] = np.inf

    for k in range(1, maxL):
        Mt = int(np.searchsorted(-Lb, -k, side="right"))  # rows with L >= k
        serve_until(Mt, arr_w[:Mt, k])   # inf past a row's length: drains
        valid_k = np.isfinite(arr_w[:Mt, k])
        rem[:Mt, k][valid_k] = svc_w[:Mt, k][valid_k]
    Mt = int(np.searchsorted(-Lb, -maxL, side="right"))
    serve_until(Mt, np.full(Mt, np.inf))


def srpt_numpy(arrivals, services, window: int = DEFAULT_WINDOW,
               fifo_finish=None) -> tuple:
    """Preemptive SRPT finish times, ``[..., n] -> (finish, overflow)``.

    Shortest-Remaining-Processing-Time over independent streams (leading
    axes): between consecutive arrivals the server drains the job with
    the least remaining work, and each arrival preempts whatever is
    running if it is shorter.

    SRPT is work-conserving, so its busy periods are the FIFO Lindley
    ones (the unfinished-workload path is discipline-independent) — the
    same decomposition the non-preemptive masked-argmin engine rides.
    Each busy period is simulated independently on a dense
    length-bucketed panel (:func:`_srpt_bucket`): length-1 and length-2
    periods close in vectorized form (a length-2 period has exactly one
    preempt-or-not branch), longer ones run the remaining-work panel
    loop whose per-step cost is the *period length*, not a global
    window. Ops replicate the heapq reference's (remaining, qid)
    tie-breaking and float order, so agreement with
    ``mg1.srpt_event_loop`` is bitwise in practice.

    A busy period longer than ``window`` flags its stream in
    ``overflow``; flagged rows hold the FIFO schedule (defined but wrong
    for SRPT) and :func:`srpt_start_finish` replays exactly those
    streams through the heapq reference. ``fifo_finish`` may pass the
    precomputed FIFO Lindley finish times to skip the internal pass (the
    sweep layer shares one pass across all disciplines). Start times are
    undefined under preemption; callers derive waits as system minus
    service time.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    shape = arrivals.shape
    n = shape[-1]
    B = arrivals.size // n if n else 0
    if n == 0 or B == 0:
        return np.zeros(shape), np.zeros(shape[:-1], dtype=bool)
    a = np.ascontiguousarray(arrivals).reshape(B, n)
    s = np.ascontiguousarray(services).reshape(B, n)
    # discipline-independent busy structure from the FIFO Lindley pass
    if fifo_finish is None:
        _, fin_f = lindley_numpy(a, s)
    else:
        fin_f = np.broadcast_to(fifo_finish, shape).reshape(B, n)
    new_bp = np.empty((B, n), dtype=bool)
    new_bp[:, 0] = True
    new_bp[:, 1:] = a[:, 1:] > fin_f[:, :-1]

    fa, fs = a.ravel(), s.ravel()
    Bn = B * n
    f = np.flatnonzero(new_bp.ravel())        # first query of each period
    L = np.diff(np.append(f, Bn))
    sb = f // n
    overflow = np.zeros(B, dtype=bool)
    overflow[sb[L > window]] = True
    keep = ~overflow[sb]

    finish = np.empty(Bn)
    ovf_rows = np.flatnonzero(overflow)
    for b in ovf_rows:
        # defined placeholder for flagged streams (see docstring)
        finish[b * n:(b + 1) * n] = fin_f[b]

    # closed forms: a lone job finishes at arrival + service; a length-2
    # period has one branch — the second arrival preempts iff its service
    # is strictly below the head's remaining work at that instant
    f1 = f[keep & (L == 1)]
    finish[f1] = fa[f1] + fs[f1]
    f2 = f[keep & (L == 2)]
    if f2.size:
        rem0 = fs[f2] - (fa[f2 + 1] - fa[f2])
        s1 = fs[f2 + 1]
        pre = s1 < rem0
        fin_first = fa[f2 + 1] + np.where(pre, s1, rem0)
        finish[np.where(pre, f2 + 1, f2)] = fin_first
        finish[np.where(pre, f2, f2 + 1)] = fin_first + np.where(pre, rem0,
                                                                 s1)

    # dense panel loop for longer periods, in length ranges (cf. the
    # non-preemptive engine's bucketing; length 3 gets its own exact
    # bucket — ``_buckets`` starts at 4)
    ranges = ([(3, 3)] if window >= 3 else []) + _buckets(window)
    for lo_b, bound in ranges:
        sel = keep & (L >= lo_b) & (L <= bound)
        if not sel.any():
            continue
        fb, Lb = f[sel], L[sel]
        order = np.argsort(-Lb, kind="stable")
        fb, Lb = fb[order], Lb[order]
        maxL = int(Lb[0])
        M = fb.shape[0]
        offs = np.arange(maxL)
        idx = np.minimum(fb[:, None] + offs[None, :], Bn - 1)
        valid = offs[None, :] < Lb[:, None]
        arr_w = np.where(valid, fa[idx], np.inf)
        svc_w = np.where(valid, fs[idx], 0.0)
        fin_o = np.empty((M, maxL))
        _srpt_bucket(arr_w, svc_w, Lb, fin_o)
        finish[idx[valid]] = fin_o[valid]

    return finish.reshape(shape), overflow.reshape(shape[:-1])


def srpt_start_finish(arrivals, services,
                      window: int = DEFAULT_WINDOW,
                      fifo_finish=None) -> tuple:
    """Exact SRPT trajectories with heapq fallback on window overflow.

    Returns ``(start, finish, overflow)`` shaped like the non-preemptive
    engines so the sweep layers stay uniform; ``start`` is the *effective*
    start ``finish - service`` (service as if contiguous, ending at the
    true completion), making ``start - arrival`` the time in system not
    being served — the natural preemptive analogue of queueing delay.
    ``fifo_finish`` is forwarded to :func:`srpt_numpy`.
    """
    finish, ovf = srpt_numpy(arrivals, services, window, fifo_finish)
    if ovf.any():
        a, s = np.broadcast_arrays(np.asarray(arrivals, dtype=np.float64),
                                   np.asarray(services, dtype=np.float64))
        n = a.shape[-1]
        a2 = a.reshape(-1, n)
        s2 = s.reshape(-1, n)
        f2 = finish.reshape(-1, n)
        for b in np.flatnonzero(ovf.ravel()):
            f2[b] = srpt_event_loop(a2[b], s2[b])
        finish = f2.reshape(a.shape)
    start = finish - np.asarray(services, dtype=np.float64)
    return start, finish, ovf


# --------------------------------------------------------------------------
# preemptive SPRPT kernel (predicted keys, true completions)
# --------------------------------------------------------------------------

def _sprpt_bucket(arr_w, svc_w, prd_w, Lb, fin_o) -> None:
    """SPRPT over one dense length-bucket of busy periods, in place.

    The predicted twin of :func:`_srpt_bucket`: two panels instead of
    one — ``trem`` (true remaining work: governs completion instants)
    and ``prem`` (predicted remaining work: the argmin selection key).
    Both are charged the same elapsed time on preemption, so an
    underestimated job's ``prem`` goes negative and it monopolizes the
    server until its true work drains — the reference failure mode.
    With ``prd_w == svc_w`` the two panels stay numerically identical
    and every float op matches :func:`_srpt_bucket` term for term, so
    zero prediction error is bitwise SRPT.
    """
    M, maxL = arr_w.shape
    trem = np.full((M, maxL), np.inf)
    prem = np.full((M, maxL), np.inf)
    trem[:, 0] = svc_w[:, 0]             # the head job, served at arrival
    prem[:, 0] = prd_w[:, 0]
    t = arr_w[:, 0].copy()
    rows = np.arange(M)

    def serve_until(Mt: int, ta: np.ndarray) -> None:
        subt, subp, tt = trem[:Mt], prem[:Mt], t[:Mt]
        rr = rows[:Mt]
        bounded = np.isfinite(ta)
        while True:
            j = np.argmin(subp, axis=1)  # first min = lowest qid
            m = subt[rr, j]              # TRUE remaining of the selection
            fin_t = tt + m
            can = np.isfinite(m) & (fin_t <= ta)
            if not can.any():
                act = np.isfinite(m) & bounded
                if act.any():
                    ra, ja = rr[act], j[act]
                    el = ta[act] - tt[act]
                    subt[ra, ja] = m[act] - el
                    subp[ra, ja] = subp[ra, ja] - el
                tt[bounded] = ta[bounded]
                return
            rc, jc = rr[can], j[can]
            tt[can] = fin_t[can]
            fin_o[rc, jc] = fin_t[can]
            subt[rc, jc] = np.inf
            subp[rc, jc] = np.inf

    for k in range(1, maxL):
        Mt = int(np.searchsorted(-Lb, -k, side="right"))  # rows with L >= k
        serve_until(Mt, arr_w[:Mt, k])   # inf past a row's length: drains
        valid_k = np.isfinite(arr_w[:Mt, k])
        trem[:Mt, k][valid_k] = svc_w[:Mt, k][valid_k]
        prem[:Mt, k][valid_k] = prd_w[:Mt, k][valid_k]
    Mt = int(np.searchsorted(-Lb, -maxL, side="right"))
    serve_until(Mt, np.full(Mt, np.inf))


def sprpt_numpy(arrivals, services, predicted,
                window: int = DEFAULT_WINDOW, fifo_finish=None) -> tuple:
    """Preemptive SPRPT finish times, ``[..., n] -> (finish, overflow)``.

    Shortest-Predicted-Remaining-Processing-Time: :func:`srpt_numpy`
    with the selection key driven by ``predicted`` service times while
    completions follow the true ``services``. SPRPT serves *some* job
    whenever work is present regardless of prediction quality, so it is
    work-conserving and rides the same FIFO-Lindley busy-period
    decomposition; per period the dense panel loop is
    :func:`_sprpt_bucket`. ``predicted`` must match the broadcast
    arrival/service shape exactly (one prediction per query — no silent
    broadcasting). Pinned against ``mg1.sprpt_event_loop``; bitwise SRPT
    at ``predicted == services``. Same overflow/fallback contract as
    :func:`srpt_numpy`.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    services = np.asarray(services, dtype=np.float64)
    arrivals, services = np.broadcast_arrays(arrivals, services)
    predicted = np.asarray(predicted, dtype=np.float64)
    if predicted.shape != services.shape:
        raise ValueError(
            f"predicted service shape {predicted.shape} must match the "
            f"broadcast arrival/service shape {services.shape} exactly "
            "(one prediction per query; silent broadcasting is not "
            "allowed)")
    shape = arrivals.shape
    n = shape[-1]
    B = arrivals.size // n if n else 0
    if n == 0 or B == 0:
        return np.zeros(shape), np.zeros(shape[:-1], dtype=bool)
    a = np.ascontiguousarray(arrivals).reshape(B, n)
    s = np.ascontiguousarray(services).reshape(B, n)
    p = np.ascontiguousarray(predicted).reshape(B, n)
    # discipline-independent busy structure from the FIFO Lindley pass
    if fifo_finish is None:
        _, fin_f = lindley_numpy(a, s)
    else:
        fin_f = np.broadcast_to(fifo_finish, shape).reshape(B, n)
    new_bp = np.empty((B, n), dtype=bool)
    new_bp[:, 0] = True
    new_bp[:, 1:] = a[:, 1:] > fin_f[:, :-1]

    fa, fs, fp = a.ravel(), s.ravel(), p.ravel()
    Bn = B * n
    f = np.flatnonzero(new_bp.ravel())        # first query of each period
    L = np.diff(np.append(f, Bn))
    sb = f // n
    overflow = np.zeros(B, dtype=bool)
    overflow[sb[L > window]] = True
    keep = ~overflow[sb]

    finish = np.empty(Bn)
    ovf_rows = np.flatnonzero(overflow)
    for b in ovf_rows:
        # defined placeholder for flagged streams (see srpt_numpy)
        finish[b * n:(b + 1) * n] = fin_f[b]

    # closed forms: a lone job finishes at arrival + service; a length-2
    # period preempts iff the newcomer's PREDICTION is strictly below the
    # head's predicted remaining (and the head still has true work left —
    # an exact-boundary arrival sees the completion first)
    f1 = f[keep & (L == 1)]
    finish[f1] = fa[f1] + fs[f1]
    f2 = f[keep & (L == 2)]
    if f2.size:
        rem0 = fs[f2] - (fa[f2 + 1] - fa[f2])
        prem0 = fp[f2] - (fa[f2 + 1] - fa[f2])
        s1 = fs[f2 + 1]
        pre = (fp[f2 + 1] < prem0) & (rem0 > 0)
        fin_first = fa[f2 + 1] + np.where(pre, s1, rem0)
        finish[np.where(pre, f2 + 1, f2)] = fin_first
        finish[np.where(pre, f2, f2 + 1)] = fin_first + np.where(pre, rem0,
                                                                 s1)

    # dense panel loop for longer periods (cf. srpt_numpy's bucketing)
    ranges = ([(3, 3)] if window >= 3 else []) + _buckets(window)
    for lo_b, bound in ranges:
        sel = keep & (L >= lo_b) & (L <= bound)
        if not sel.any():
            continue
        fb, Lb = f[sel], L[sel]
        order = np.argsort(-Lb, kind="stable")
        fb, Lb = fb[order], Lb[order]
        maxL = int(Lb[0])
        M = fb.shape[0]
        offs = np.arange(maxL)
        idx = np.minimum(fb[:, None] + offs[None, :], Bn - 1)
        valid = offs[None, :] < Lb[:, None]
        arr_w = np.where(valid, fa[idx], np.inf)
        svc_w = np.where(valid, fs[idx], 0.0)
        prd_w = np.where(valid, fp[idx], 0.0)
        fin_o = np.empty((M, maxL))
        _sprpt_bucket(arr_w, svc_w, prd_w, Lb, fin_o)
        finish[idx[valid]] = fin_o[valid]

    return finish.reshape(shape), overflow.reshape(shape[:-1])


def sprpt_start_finish(arrivals, services, predicted,
                       window: int = DEFAULT_WINDOW,
                       fifo_finish=None) -> tuple:
    """Exact SPRPT trajectories with heapq fallback on window overflow.

    The predicted twin of :func:`srpt_start_finish`: overflowed streams
    replay through ``mg1.sprpt_event_loop``; ``start`` is the effective
    ``finish - service`` (see :func:`srpt_start_finish` for why).
    """
    finish, ovf = sprpt_numpy(arrivals, services, predicted, window,
                              fifo_finish)
    if ovf.any():
        a, s = np.broadcast_arrays(np.asarray(arrivals, dtype=np.float64),
                                   np.asarray(services, dtype=np.float64))
        p = np.asarray(predicted, dtype=np.float64)
        n = a.shape[-1]
        a2 = a.reshape(-1, n)
        s2 = s.reshape(-1, n)
        p2 = p.reshape(-1, n)
        f2 = finish.reshape(-1, n)
        for b in np.flatnonzero(ovf.ravel()):
            f2[b] = sprpt_event_loop(a2[b], s2[b], p2[b])
        finish = f2.reshape(a.shape)
    start = finish - np.asarray(services, dtype=np.float64)
    return start, finish, ovf


# --------------------------------------------------------------------------
# simulation layers
# --------------------------------------------------------------------------

def _predict_services(predictor, services, stream_seed) -> np.ndarray:
    """Predicted services over a ``[..., S, n]`` grid.

    One standard-normal draw per query (the trailing ``[S, n]`` axes),
    seeded by ``(predictor.seed, stream_seed)`` and broadcast across any
    leading policy axis — so policy stacks and disciplines sharing a
    stream batch are compared on common random predictions. ``None``
    selects the zero-error oracle (predicted == true services, bitwise).
    """
    from ..data.predictor import LengthPredictor

    if predictor is None:
        predictor = LengthPredictor()
    z = None
    if predictor.sigma > 0:
        rng = np.random.default_rng((int(predictor.seed), int(stream_seed)))
        z = np.broadcast_to(rng.standard_normal(services.shape[-2:]),
                            services.shape)
    return predictor.predict(services, z=z)


def simulate_discipline(problem: Problem, lengths, stream: Stream,
                        discipline: str = "fifo", backend: str = "numpy",
                        window: int = DEFAULT_WINDOW,
                        service_time_fn=None,
                        predicted=None, device=None) -> SimResult:
    """Fast drop-in for ``mg1.simulate`` under any discipline.

    Agrees with the heapq reference within ~1e-10 per query on identical
    streams (bitwise in practice), including when the stream overflows
    ``window`` and takes the fallback. ``srpt``/``sprpt`` run the
    preemptive panel kernels (:func:`srpt_numpy` / :func:`sprpt_numpy`;
    numpy-only — ``backend`` selects the kernel for the non-preemptive
    disciplines). The predicted disciplines ("spjf"/"sprpt") require
    ``predicted``: a per-query predicted-service array of length
    ``len(stream)`` (shape-validated; see ``data.predictor``). SPJF rides
    the masked-argmin engine with the prediction as its key, so it works
    on both backends.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    if len(stream.queries) == 0:
        return empty_result(problem)
    types, arrivals, services, us, keys = stream_arrays(
        problem, lengths, stream, discipline, service_time_fn, predicted)
    if discipline == "fifo":
        start, finish = _lindley(arrivals, services, backend, device)
    elif discipline == "srpt":
        start, finish, _ = srpt_start_finish(arrivals, services, window)
    elif discipline == "sprpt":
        start, finish, _ = sprpt_start_finish(arrivals, services, keys,
                                              window)
    else:
        start, finish, _ = windowed_start_finish(arrivals, services, keys,
                                                 window, backend,
                                                 device=device)
    return result_from_trajectory(problem, lengths, types, arrivals,
                                  services, us, start, finish)


def simulate_batch(problem: Problem, lengths, batch: StreamBatch,
                   discipline: str = "fifo", backend: str = "numpy",
                   window: int = DEFAULT_WINDOW,
                   predictor=None, device=None) -> BatchStats:
    """``simulate_fifo_batch`` with a discipline axis.

    ``lengths``: ``[N]`` or ``[P, N]`` token budgets; ``batch``: ``[S, n]``
    streams. Returns :class:`BatchStats` with shape ``[S]`` or ``[P, S]``.
    FIFO routes to the Lindley fast path; SJF/priority/SPJF run the
    masked-argmin engine (with heapq fallback on window overflow);
    SRPT/SPRPT run the preemptive panel kernels. The predicted
    disciplines take ``predictor`` (a ``data.predictor.LengthPredictor``;
    ``None`` = the zero-error oracle, making SPJF/SPRPT bitwise
    SJF/SRPT). Noise draws are one standard normal per query — seeded by
    ``(predictor.seed, batch.seed)`` and shared across the policy axis,
    so policies are compared on common random predictions.
    """
    if discipline == "fifo":
        return simulate_fifo_batch(problem, lengths, batch, backend=backend,
                                   device=device)
    if discipline not in ALL_DISCIPLINES:
        raise ValueError(f"unknown discipline {discipline!r} "
                         f"(expected one of {ALL_DISCIPLINES})")
    lengths = np.asarray(lengths, dtype=np.float64)
    single = lengths.ndim == 1
    L = lengths[None, :] if single else lengths           # [P, N]
    services = _service_table(problem, L)[:, batch.types]   # [P, S, n]
    p_query = _accuracy_table(problem, L)[:, batch.types]   # [P, S, n]
    arr = np.broadcast_to(batch.arrivals[None], services.shape)
    predicted = None
    if discipline in PREDICTED_DISCIPLINES:
        predicted = _predict_services(predictor, services, batch.seed)
    if discipline == "srpt":
        start, finish, _ = srpt_start_finish(arr, services, window)
    elif discipline == "sprpt":
        start, finish, _ = sprpt_start_finish(arr, services, predicted,
                                              window)
    else:
        keys = discipline_keys(discipline, arrivals=arr, services=services,
                               accuracy=p_query, predicted=predicted)
        start, finish, _ = windowed_start_finish(arr, services, keys,
                                                 window, backend,
                                                 device=device)
    stats = _batch_stats(problem, batch.arrivals, services, start, finish,
                         p_query, batch.correct_us)
    if single:
        stats = BatchStats(**{f.name: getattr(stats, f.name)[0]
                              for f in dataclasses.fields(BatchStats)})
    return stats


def sweep_disciplines(problem: Problem, policies, lams,
                      disciplines=DISCIPLINES, n_seeds: int = 16,
                      n_queries: int = 10_000, seed: int = 0,
                      backend: str = "numpy", clip_unstable: bool = True,
                      margin: float = 1e-3, prompt_len_range=(16, 128),
                      window: int = DEFAULT_WINDOW,
                      predictor=None, device=None) -> dict:
    """The full discipline-ablation grid with all shared work amortized.

    Equivalent to ``{d: batched.sweep(..., discipline=d) for d in
    disciplines}`` — identical common-random-number streams, per-field
    agreement to ~1e-12 — but computes everything the disciplines share
    only once per arrival rate: stream generation, the per-task
    service/accuracy tables, the batched ``stability_clip`` projection,
    and the FIFO Lindley pass (which both *is* the FIFO result and
    supplies the busy-period split for the masked-argmin engine). Work
    conservation makes utilization, realized accuracy, and the service
    mixture discipline-independent, so only the delay means are computed
    per discipline — non-FIFO lanes run through one K-lane engine call.
    This is the fast path behind ``benchmarks/discipline_ablation``;
    memory peaks at one ``[P, S, n]`` tensor per field (the lambda axis
    is streamed, never materialized). Grid setup and aggregation are the
    ``sweep`` helpers, so the clip/NaN-unstable contract is identical.

    The predicted disciplines ("spjf"/"sprpt") use ``predictor`` (a
    ``data.predictor.LengthPredictor``; ``None`` = zero-error oracle).
    The per-query noise normals are drawn once per ``(predictor.seed,
    seed)`` pair and reused across the lambda axis — types (hence true
    services) are already common random numbers across lambda, so the
    predicted lanes are too.
    """
    for d in disciplines:
        if d not in ALL_DISCIPLINES:
            raise ValueError(f"unknown discipline {d!r}")
    names, lengths, rho, masked = _grid_budgets(problem, policies, lams,
                                                clip_unstable, margin)
    Lg, P = rho.shape
    want_predicted = any(d in PREDICTED_DISCIPLINES for d in disciplines)

    per_seed = {d: {nm: np.zeros((Lg, P, n_seeds)) for nm in
                    ("mean_wait", "mean_system_time", "mean_service",
                     "utilization", "accuracy", "mean_accuracy_prob",
                     "objective")} for d in disciplines}
    ovf = {d: np.zeros((Lg, P, n_seeds), dtype=bool) for d in disciplines}

    for i, lam in enumerate(lams):
        if masked[i].all():
            continue  # whole row is NaN-masked anyway: skip simulating
        batch = generate_streams(problem.tasks, float(lam), n_seeds,
                                 n_queries, seed=seed,
                                 prompt_len_range=prompt_len_range)
        t_tab = _service_table(problem, lengths[i])        # [P, N]
        p_tab = _accuracy_table(problem, lengths[i])       # [P, N]
        svc = t_tab[:, batch.types]                        # [P, S, n]
        arr_b = np.broadcast_to(batch.arrivals[None], svc.shape)
        st_f, fin_f = lindley_numpy(arr_b, svc)
        fifo_stats = _batch_stats_tabular(problem, t_tab, p_tab,
                                          batch.types, batch.arrivals,
                                          batch.correct_us, st_f, fin_f,
                                          fin_f[..., -1])
        mean_arr = batch.arrivals.mean(axis=-1)
        non_fifo = [d for d in disciplines
                    if d != "fifo" and d not in PREEMPTIVE_DISCIPLINES]
        pred = (_predict_services(predictor, svc, seed)
                if want_predicted else None)

        def _keys(d):
            if d == "sjf":
                return svc
            if d == "spjf":
                return pred
            return discipline_keys("priority", services=t_tab,
                                   accuracy=p_tab)[:, batch.types]

        delay = {}
        if "fifo" in disciplines:
            delay["fifo"] = (fifo_stats.mean_wait,
                             fifo_stats.mean_system_time)
        if "srpt" in disciplines:
            # preemptive lane: its own busy-period kernel sharing the
            # Lindley pass; SRPT is still work-conserving, so the shared
            # (utilization/accuracy/service) columns below remain valid
            st_p, fin_p, o = srpt_start_finish(arr_b, svc, window,
                                               fifo_finish=fin_f)
            delay["srpt"] = (st_p.mean(axis=-1) - mean_arr,
                             fin_p.mean(axis=-1) - mean_arr)
            ovf["srpt"][i] = o
        if "sprpt" in disciplines:
            # predicted-preemptive lane: same Lindley sharing (SPRPT is
            # work-conserving regardless of prediction quality)
            st_p, fin_p, o = sprpt_start_finish(arr_b, svc, pred, window,
                                                fifo_finish=fin_f)
            delay["sprpt"] = (st_p.mean(axis=-1) - mean_arr,
                              fin_p.mean(axis=-1) - mean_arr)
            ovf["sprpt"][i] = o
        if non_fifo and backend == "numpy":
            # one K-lane busy-period pass: split/setup shared across lanes
            st_k, fin_k, o = _windowed_numpy_multi(
                arr_b, svc, [_keys(d) for d in non_fifo], window,
                fifo_finish=fin_f)
            if o.any():
                for kk, d in enumerate(non_fifo):
                    st_k[kk], fin_k[kk], _ = _apply_fallback(
                        arr_b, svc, _keys(d), st_k[kk], fin_k[kk], o)
            for kk, d in enumerate(non_fifo):
                delay[d] = (st_k[kk].mean(axis=-1) - mean_arr,
                            fin_k[kk].mean(axis=-1) - mean_arr)
                ovf[d][i] = o
        else:
            for d in non_fifo:
                start, fin, o = windowed_start_finish(arr_b, svc, _keys(d),
                                                      window, backend,
                                                      device=device)
                delay[d] = (start.mean(axis=-1) - mean_arr,
                            fin.mean(axis=-1) - mean_arr)
                ovf[d][i] = o
        for d in disciplines:
            wait_i, sys_i = delay[d]
            cell = per_seed[d]
            cell["mean_wait"][i] = wait_i
            cell["mean_system_time"][i] = sys_i
            # work conservation: everything but delay is discipline-shared
            cell["mean_service"][i] = fifo_stats.mean_service
            cell["utilization"][i] = fifo_stats.utilization
            cell["accuracy"][i] = fifo_stats.accuracy
            cell["mean_accuracy_prob"][i] = fifo_stats.mean_accuracy_prob
            cell["objective"][i] = (problem.server.alpha
                                    * fifo_stats.mean_accuracy_prob - sys_i)

    return {d: _sweep_result(problem, lams, names, lengths, rho, masked,
                             per_seed[d], ovf[d], n_seeds, n_queries, d)
            for d in disciplines}

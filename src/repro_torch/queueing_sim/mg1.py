"""Event-driven M/G/1 simulation of the LLM server (paper Sec IV).

Service times are deterministic per type, t_k(l_k); randomness enters via
Poisson arrivals and type draws. FIFO is the paper's discipline; SJF,
non-preemptive priority, preemptive SRPT, and the predicted-length
variants SPJF/SPRPT are beyond-paper ablations showing how much of the
optimal allocation's gain is discipline-specific (and how much survives
an imperfect length predictor).

This heapq event loop is the *reference* path: it handles every discipline
but simulates one scalar stream per Python call. Batched workloads should
use the vectorized fast paths, which agree with this loop to ~1e-10 on
identical streams:

* FIFO: the Lindley recursion in ``queueing_sim.batched``
  (``simulate_fifo`` / ``simulate_fifo_batch``), pinned by
  ``tests/test_batched_sim.py``.
* SJF / priority: the masked-argmin engine in
  ``queueing_sim.disciplines`` (``simulate_discipline`` /
  ``simulate_batch``), pinned by ``tests/test_disciplines.py``. Streams
  whose queue outgrows the engine's window fall back to
  :func:`event_loop` here, so this loop stays the single source of truth.

The simulator also evaluates the realized objective: per-query accuracy is
Bernoulli(p_k(l_k)) using the stream's pre-drawn uniforms so that policies
are compared on common random numbers.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

import numpy as np

from ..core.params import Problem, as_control
from .workload import Stream


@dataclasses.dataclass
class SimResult:
    mean_wait: float
    mean_system_time: float
    mean_service: float
    utilization: float
    accuracy: float              # realized fraction correct
    mean_accuracy_prob: float    # E[p_k(l_k)] under the realized mixture
    objective: float             # alpha * acc_prob - mean_system_time
    per_task_system_time: np.ndarray
    per_task_count: np.ndarray
    n: int


def empty_result(problem: Problem) -> SimResult:
    """Zeroed :class:`SimResult` for an empty stream (means over 0 queries)."""
    n_tasks = problem.tasks.n_tasks
    return SimResult(
        mean_wait=0.0, mean_system_time=0.0, mean_service=0.0,
        utilization=0.0, accuracy=0.0, mean_accuracy_prob=0.0,
        objective=0.0,
        per_task_system_time=np.zeros(n_tasks),
        per_task_count=np.zeros(n_tasks, dtype=np.int64),
        n=0,
    )


def stream_arrays(problem: Problem, lengths, stream: Stream,
                  discipline: str = "fifo", service_time_fn=None,
                  predicted=None) -> tuple:
    """Unpack one stream into ``(types, arrivals, services, us, keys)``.

    The single preamble shared by the heapq reference (:func:`simulate`)
    and the vectorized engine (``disciplines.simulate_discipline``), so
    service model and key semantics cannot drift between the two paths.
    The predicted disciplines ("spjf"/"sprpt") require ``predicted``: a
    per-query predicted-service array of length ``len(stream)`` (shape is
    validated — no silent broadcasting).
    """
    # deferred: disciplines imports this module for the fallback path
    from .disciplines import discipline_keys

    lengths = np.asarray(lengths, dtype=np.float64)
    types = np.array([q.task for q in stream.queries])
    arrivals = np.array([q.arrival for q in stream.queries])
    us = np.array([q.correct_u for q in stream.queries])
    if service_time_fn is None:
        t0 = np.asarray(problem.tasks.t0)
        c = np.asarray(problem.tasks.c)
        services = (t0 + c * lengths)[types]
    else:
        services = np.array([service_time_fn(q, lengths)
                             for q in stream.queries])
    accuracy = (accuracy_np(problem.tasks, lengths)[types]
                if discipline == "priority" else None)
    keys = discipline_keys(discipline, arrivals=arrivals, services=services,
                           accuracy=accuracy, predicted=predicted)
    return types, arrivals, services, us, keys


def accuracy_np(tasks, lengths) -> np.ndarray:
    """p_k(l_k) (eq 2) in host float64.

    The one numpy definition both simulator paths score correctness
    through, as in the JAX package, so the two agree bitwise.
    """
    A, b, D = (np.asarray(x) for x in (tasks.A, tasks.b, tasks.D))
    return A * (1.0 - np.exp(-b * np.asarray(lengths, dtype=np.float64))) + D


def event_loop(arrivals: np.ndarray, services: np.ndarray,
               keys: np.ndarray) -> tuple:
    """Reference non-preemptive single-server pass: per-query start/finish.

    ``keys`` are the service-priority keys (lower = served first; FIFO is
    ``keys = arrivals``); ties break on query index, i.e. arrival order.
    This is the heapq loop the vectorized engines are pinned against, and
    their fallback when a stream overflows the masked-argmin window.
    """
    n = len(arrivals)
    start = np.zeros(n)
    finish = np.zeros(n)
    ready: list[tuple[float, int]] = []   # (key, qid) heap of waiting queries
    i = 0  # next arrival index
    busy_until = 0.0
    served = 0
    while served < n:
        # admit all arrivals up to the moment the server frees
        while i < n and (arrivals[i] <= busy_until or not ready):
            if arrivals[i] > busy_until and not ready:
                # idle period: jump to next arrival
                busy_until = arrivals[i]
            heapq.heappush(ready, (float(keys[i]), i))
            i += 1
        _, qid = heapq.heappop(ready)
        t = max(busy_until, arrivals[qid])
        start[qid] = t
        finish[qid] = t + services[qid]
        busy_until = finish[qid]
        served += 1
    return start, finish


def event_loop_mgc(arrivals: np.ndarray, services: np.ndarray,
                   keys: np.ndarray, c_servers: int) -> tuple:
    """Reference non-preemptive c-server pass: per-query start/finish.

    The M/G/c generalization of :func:`event_loop`: ``c_servers`` servers
    share one queue; at every decision instant (earliest server-free time,
    or the next arrival when the queue is empty) the min-key waiting query
    starts on the earliest-free server. With FIFO keys this is the pinned
    oracle for the batched next-free-server kernel in
    ``queueing_sim.multiserver`` (identical arithmetic: start =
    max(arrival, min free time), so agreement is to float noise).
    ``c_servers=1`` replicates :func:`event_loop` exactly.
    """
    n = len(arrivals)
    start = np.zeros(n)
    finish = np.zeros(n)
    free = [0.0] * int(c_servers)         # heap of server free times
    heapq.heapify(free)
    ready: list[tuple[float, int]] = []   # (key, qid) heap of waiting queries
    i = 0  # next arrival index
    served = 0
    while served < n:
        t_free = free[0]
        # admit all arrivals up to the earliest server-free instant
        while i < n and (arrivals[i] <= t_free or not ready):
            if arrivals[i] > t_free and not ready:
                # idle period: jump to next arrival
                t_free = arrivals[i]
            heapq.heappush(ready, (float(keys[i]), i))
            i += 1
        _, qid = heapq.heappop(ready)
        t = max(free[0], arrivals[qid])
        start[qid] = t
        finish[qid] = t + services[qid]
        heapq.heapreplace(free, finish[qid])
        served += 1
    return start, finish


def srpt_event_loop(arrivals: np.ndarray, services: np.ndarray) -> np.ndarray:
    """Reference preemptive SRPT pass: per-query finish times.

    Shortest-Remaining-Processing-Time: at every instant the server works
    on the job with the least remaining work, preempting on arrival of a
    shorter job. Ties break on query index (arrival order), matching the
    vectorized kernel in ``queueing_sim.disciplines.srpt_numpy``, which is
    pinned against this loop per query. Start times are not well defined
    under preemption (service is interrupted); callers derive waits as
    system time minus service time.
    """
    n = len(arrivals)
    finish = np.zeros(n)
    heap: list[tuple[float, int]] = []    # (remaining work, qid)
    t = 0.0
    i = 0
    while i < n or heap:
        if not heap:
            # idle: jump to the next arrival
            t = float(arrivals[i])
            heapq.heappush(heap, (float(services[i]), i))
            i += 1
            continue
        rem, qid = heap[0]
        if i < n and arrivals[i] < t + rem:
            # arrival preempts (or queues): charge elapsed work first
            heapq.heapreplace(heap, (rem - (float(arrivals[i]) - t), qid))
            t = float(arrivals[i])
            heapq.heappush(heap, (float(services[i]), i))
            i += 1
        else:
            t = t + rem
            finish[qid] = t
            heapq.heappop(heap)
    return finish


def sprpt_event_loop(arrivals: np.ndarray, services: np.ndarray,
                     predicted: np.ndarray) -> np.ndarray:
    """Reference preemptive SPRPT pass: per-query finish times.

    Shortest-*Predicted*-Remaining-Processing-Time (Mitzenmacher &
    Shahout): the scheduler sees only ``predicted`` service times; at
    every instant the server works on the job whose predicted remaining
    work (prediction minus attained service) is smallest, preempting on
    arrival of a job with a smaller prediction. Completion is governed by
    the TRUE service requirement, so an underestimated job's predicted
    remaining goes negative and it keeps the server until done — exactly
    the starvation failure mode that erodes SPRPT's advantage as
    prediction error grows. With ``predicted == services`` every heap key
    and float operation coincides with :func:`srpt_event_loop`, so the
    zero-error case is bitwise SRPT (pinned in
    ``tests/test_prediction.py``). Ties break on query index, matching
    the vectorized panel kernel ``disciplines.sprpt_numpy``.
    """
    n = len(arrivals)
    finish = np.zeros(n)
    heap: list[tuple[float, int]] = []    # (predicted remaining, qid)
    trem = np.asarray(services, dtype=np.float64).copy()  # true remaining
    t = 0.0
    i = 0
    while i < n or heap:
        if not heap:
            # idle: jump to the next arrival
            t = float(arrivals[i])
            heapq.heappush(heap, (float(predicted[i]), i))
            i += 1
            continue
        prem, qid = heap[0]
        tr = trem[qid]
        if i < n and arrivals[i] < t + tr:
            # arrival preempts (or queues): charge elapsed work against
            # both the predicted key and the true remaining work
            heapq.heapreplace(heap, (prem - (float(arrivals[i]) - t), qid))
            trem[qid] = tr - (float(arrivals[i]) - t)
            t = float(arrivals[i])
            heapq.heappush(heap, (float(predicted[i]), i))
            i += 1
        else:
            t = t + tr
            finish[qid] = t
            heapq.heappop(heap)
    return finish


def result_from_trajectory(problem: Problem, lengths, types, arrivals,
                           services, correct_us, start,
                           finish) -> SimResult:
    """Reduce one stream's per-query trajectory to a :class:`SimResult`.

    Shared by the heapq reference and the vectorized discipline engine so
    both paths aggregate with bit-identical operations.
    """
    waits = start - arrivals
    sys_times = finish - arrivals
    p = accuracy_np(problem.tasks, lengths)
    correct = correct_us < p[types]
    acc_prob = float(np.mean(p[types]))
    per_task_sys = np.zeros(problem.tasks.n_tasks)
    per_task_cnt = np.bincount(types, minlength=problem.tasks.n_tasks)
    for k in range(problem.tasks.n_tasks):
        if per_task_cnt[k]:
            per_task_sys[k] = sys_times[types == k].mean()
    return SimResult(
        mean_wait=float(waits.mean()),
        mean_system_time=float(sys_times.mean()),
        mean_service=float(services.mean()),
        utilization=float(services.sum() / max(finish.max(), 1e-12)),
        accuracy=float(correct.mean()),
        mean_accuracy_prob=acc_prob,
        objective=float(problem.server.alpha * acc_prob - sys_times.mean()),
        per_task_system_time=per_task_sys,
        per_task_count=per_task_cnt,
        n=len(arrivals),
    )


def simulate(problem: Problem, lengths, stream: Stream,
             discipline: str = "fifo",
             service_time_fn: Callable | None = None,
             c_servers: int = 1, predicted=None) -> SimResult:
    """Simulate the queue under integer budgets ``lengths``.

    discipline: "fifo" (paper), "sjf" (shortest-job-first, non-preemptive),
    "priority" (highest marginal utility per second first), "srpt"
    (preemptive shortest-remaining-work), or the predicted variants
    "spjf" / "sprpt" which order by a noisy length prediction instead of
    the true service time (all beyond paper). The predicted disciplines
    require ``predicted``: a per-query predicted-service array, e.g. from
    ``data.predictor.LengthPredictor.predict``; with
    ``predicted == services`` they reduce bitwise to SJF / SRPT.
    ``service_time_fn(query, lengths) -> float`` overrides the analytic
    service model (used to couple the DES to the real decode engine).
    ``c_servers`` > 1 simulates the M/G/c pod (non-preemptive disciplines
    only) through :func:`event_loop_mgc`; utilization is then per server
    (busy time over c * makespan). Waits under "srpt"/"sprpt" are
    reported as system time minus service time (start times are
    undefined under preemption).
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    if len(stream.queries) == 0:
        return empty_result(problem)
    types, arrivals, services, us, keys = stream_arrays(
        problem, lengths, stream, discipline, service_time_fn, predicted)
    if discipline in ("srpt", "sprpt"):
        if c_servers != 1:
            raise NotImplementedError(f"{discipline} is single-server only")
        if discipline == "srpt":
            finish = srpt_event_loop(arrivals, services)
        else:
            finish = sprpt_event_loop(arrivals, services, keys)
        start = finish - services
    elif c_servers == 1:
        start, finish = event_loop(arrivals, services, keys)
    else:
        start, finish = event_loop_mgc(arrivals, services, keys, c_servers)
    res = result_from_trajectory(problem, lengths, types, arrivals,
                                 services, us, start, finish)
    if c_servers > 1:
        res.utilization /= c_servers
    return res


def pk_prediction(problem: Problem, lengths) -> dict:
    """Analytical P-K prediction for cross-checking the DES (float64)."""
    from ..core.queueing import mean_system_time, mean_wait, service_moments

    lam = problem.server.lam
    m = service_moments(problem.tasks, as_control(lengths), lam)
    return {
        "mean_wait": float(mean_wait(m, lam)),
        "mean_system_time": float(mean_system_time(m, lam)),
        "mean_service": float(m.es),
        "utilization": float(m.rho),
    }


def mgc_prediction(problem: Problem, lengths, c_servers: int,
                   correction: str = "lee-longton") -> dict:
    """Analytic M/G/c (Erlang-C / Lee-Longton) prediction, host f64.

    The c-server analogue of :func:`pk_prediction` (identical at
    ``c_servers=1``); ``utilization`` is per server, rho / c. See
    ``core.mgc`` for the approximation's documented error envelope.
    """
    from ..core.mgc import mgc_wait_np

    lengths = np.asarray(lengths, dtype=np.float64)
    tasks, lam = problem.tasks, problem.server.lam
    t = np.asarray(tasks.t0) + np.asarray(tasks.c) * lengths
    es = float(np.sum(np.asarray(tasks.pi) * t))
    w = float(mgc_wait_np(tasks, lengths, lam, c_servers, correction))
    return {
        "mean_wait": w,
        "mean_system_time": w + es,
        "mean_service": es,
        "utilization": lam * es / c_servers,
    }

"""Stepped DES with occupancy-dependent service rate (beyond paper).

Cross-validation lane for ``core.batch_service``: instead of assigning
each request an a-priori service time, this simulator serves a rolling
in-flight batch whose service RATE depends on its size — exactly the
coupling the occupancy-corrected analytics approximate:

* requests arrive Poisson(lam), draw a task type ~ pi, and carry their
  paper-model batch-of-one work t0_k + c_k l_k (eq 1) in seconds,
* admission is FIFO while fewer than ``max_batch`` requests are in
  flight (the engine's concurrency limit — the same back-pressure
  semantics as ``ContinuousBatchingEngine.admit_many``),
* with b requests in flight, every member's remaining work drains at
  rate ``1 / r(b)`` where ``r(b) = t_step(b) / t_step(1)`` — the fluid
  limit of a fused-step engine whose step at occupancy b costs
  ``t_step(b)`` wall seconds while advancing every member one token, so
  a request served alone takes exactly its eq-1 service time and a
  request in company is slowed by the occupancy ratio.

The loop is event-driven (next member completion or next
occupancy-changing arrival, O(events) total) rather than per-token, but
the occupancy coupling is preserved: the drain rate is re-evaluated
whenever the batch size changes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core.batch_service import StepLatencyModel
from ..core.params import TaskSet

__all__ = ["BatchServiceSim", "simulate_batch_service"]


class BatchServiceSim(NamedTuple):
    """Per-request outcomes of one occupancy-dependent DES run."""

    mean_wait: float           # admission - arrival
    mean_service: float        # departure - admission
    mean_system_time: float    # departure - arrival
    mean_occupancy: float      # busy-time-averaged in-flight batch size
    exp_occupancy: float       # mean occupancy a request EXPERIENCES over
    #                            its own service (size-biased; the DES
    #                            ground truth for core.batch_service's
    #                            tagged-customer b_bar)
    peak_occupancy: int
    n: int
    waits: np.ndarray
    services: np.ndarray


def simulate_batch_service(tasks: TaskSet, lengths, lam: float,
                           model: StepLatencyModel, max_batch: int,
                           n: int = 2000, seed: int = 0,
                           horizon: float | None = None) -> BatchServiceSim:
    """Run ``n`` requests through the occupancy-dependent server.

    Event loop: while requests remain, (1) admit FIFO arrivals into free
    flight slots, (2) advance the whole flight to the next event (a
    member's work reaching zero at the current drain rate 1/r(b), or an
    arrival that could change the occupancy), retiring finished members.
    An idle server jumps to the next arrival. The simulation clock starts
    at the first arrival.
    """
    model.validate()
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, dtype=np.float64)
    pi = np.asarray(tasks.pi)
    arrivals = np.cumsum(rng.exponential(1.0 / lam, size=n))
    types = rng.choice(pi.shape[0], size=n, p=pi / pi.sum())
    # total batch-of-one service work per request (paper eq 1); the
    # occupancy slowdown multiplies the DRAIN time of this work
    work0 = (np.asarray(tasks.t0)[types]
             + np.asarray(tasks.c)[types] * lengths[types])

    admit_t = np.zeros(n)
    depart_t = np.zeros(n)
    occ_int = np.zeros(n)           # integral of b dt over own service
    in_flight: list[int] = []       # request indices
    remaining = np.zeros(n)         # seconds of batch-of-one work left
    t = float(arrivals[0])
    next_arrival = 0                # first not-yet-queued request
    queue: list[int] = []
    done = 0
    occ_time = 0.0                  # integral of b dt (over busy time)
    busy_time = 0.0
    peak = 0

    while done < n:
        while next_arrival < n and arrivals[next_arrival] <= t:
            queue.append(next_arrival)
            next_arrival += 1
        while queue and len(in_flight) < max_batch:
            i = queue.pop(0)
            in_flight.append(i)
            admit_t[i] = t
            remaining[i] = work0[i]
        if not in_flight:
            t = float(arrivals[next_arrival])
            continue
        b = len(in_flight)
        peak = max(peak, b)
        r = float(model.ratio(b))
        # next event: a member finishing, or an arrival that could join
        # a non-full flight (changing the occupancy mid-quantum)
        dt_finish = min(remaining[i] for i in in_flight) * r
        dt = dt_finish
        if next_arrival < n and b < max_batch:
            dt = min(dt, float(arrivals[next_arrival]) - t)
        dt = max(dt, 0.0)
        for i in in_flight:
            remaining[i] -= dt / r
            occ_int[i] += b * dt
        t += dt
        occ_time += b * dt
        busy_time += dt
        still = []
        for i in in_flight:
            if remaining[i] <= 1e-12:
                depart_t[i] = t
                done += 1
            else:
                still.append(i)
        in_flight = still
        if horizon is not None and t > horizon:
            break

    served = depart_t > 0
    waits = (admit_t - arrivals)[served]
    services = (depart_t - admit_t)[served]
    exp_occ = occ_int[served] / np.maximum(services, 1e-12)
    return BatchServiceSim(
        mean_wait=float(waits.mean()) if waits.size else 0.0,
        mean_service=float(services.mean()) if services.size else 0.0,
        mean_system_time=float((waits + services).mean())
        if waits.size else 0.0,
        mean_occupancy=float(occ_time / max(busy_time, 1e-12)),
        exp_occupancy=float(exp_occ.mean()) if exp_occ.size else 0.0,
        peak_occupancy=int(peak),
        n=int(served.sum()),
        waits=waits, services=services)

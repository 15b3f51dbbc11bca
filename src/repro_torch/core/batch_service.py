"""Occupancy-dependent batch-service model (beyond paper, Sec II bridge).

The port of ``repro.core.batch_service``, NumPy as there. The paper's
latency model t_k(l) = t0_k + c_k l (eq 1) calibrates the per-token cost
c_k against an engine decoding ONE request. A continuous batching engine
decodes b requests per fused step, and the step latency grows with the
batch ("occupancy"), roughly affinely:

    t_step(b) = d0 + d1 * b

(d0 = weight streaming / dispatch floor, amortized over the batch;
d1 = per-row KV + activation cost). Each member of a b-sized batch pays
t_step(b) per OWN token, so the per-token cost at steady occupancy b_bar
is c_k * r(b_bar), r(b) = t_step(b) / t_step(1). The occupancy a request
experiences (the tagged customer plus lam * E[S] others by Little's law,
capped by the engine's concurrency limit) is the fixed point

    b_bar = clip(1 + lam * E[S(b_bar)], 1, max_batch),
    E[S(b)] = sum_k pi_k (t0_k + c_k r(b) l_k),

solved by damped iteration. The corrected task set then feeds the M/G/c
wait (``core.mgc.mgc_wait_np`` with c_servers = max_batch).
``repro.core.batch_service`` documents the account's accuracy against its
stepped DES. ``fit_step_latency`` takes the (occupancy, step seconds)
points a continuous engine's measured decode steps give.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np

from .mgc import mgc_wait_np
from .params import TaskSet

__all__ = ["StepLatencyModel", "fit_step_latency", "occupancy_fixed_point",
           "corrected_taskset", "batch_service_wait", "BatchServiceResult"]


@dataclasses.dataclass(frozen=True)
class StepLatencyModel:
    """Affine decode-step latency t_step(b) = d0 + d1 * b (seconds)."""

    d0: float
    d1: float

    def t_step(self, b):
        return self.d0 + self.d1 * np.asarray(b, dtype=np.float64)

    def ratio(self, b):
        """r(b) = t_step(b) / t_step(1): per-token slowdown at occupancy b
        relative to the batch-of-one calibration point."""
        return self.t_step(b) / self.t_step(1)

    def validate(self) -> None:
        if self.t_step(1) <= 0:
            raise ValueError("t_step(1) must be > 0")
        if self.d1 < 0:
            raise ValueError("d1 must be >= 0 (steps don't speed up "
                             "with occupancy)")


def fit_step_latency(batch_sizes: Sequence[float],
                     step_seconds: Sequence[float]) -> StepLatencyModel:
    """Least-squares affine fit of measured decode-step latencies.

    ``batch_sizes`` / ``step_seconds`` are paired measurements (b_i, t_i)
    of one fused decode step at occupancy b_i (a continuous engine's
    measured decode steps). A negative fitted slope (measurement noise
    on a flat machine) is clamped to 0, keeping the model valid.
    """
    b = np.asarray(batch_sizes, dtype=np.float64)
    t = np.asarray(step_seconds, dtype=np.float64)
    if b.shape != t.shape or b.size < 2:
        raise ValueError("need >= 2 paired (batch, seconds) measurements")
    X = np.stack([np.ones_like(b), b], axis=1)
    (d0, d1), *_ = np.linalg.lstsq(X, t, rcond=None)
    d1 = max(float(d1), 0.0)
    if d1 == 0.0:
        d0 = float(t.mean())
    m = StepLatencyModel(d0=float(d0), d1=d1)
    m.validate()
    return m


def occupancy_fixed_point(tasks: TaskSet, lengths, lam: float,
                          model: StepLatencyModel, max_batch: int,
                          damping: float = 0.5, tol: float = 1e-10,
                          max_iters: int = 10_000):
    """Solve b_bar = clip(1 + lam * E[S(b_bar)], 1, max_batch) by damped
    iteration (the tagged-customer occupancy — see module docs).

    The map is monotone non-decreasing and affine-in-b inside the clip,
    so damped iteration converges whenever a fixed point exists; if the
    uncapped map has slope >= 1 (lam * E[pi c l] * d1 / t_step(1) >= 1,
    service demand outrunning the slowdown feedback) the iteration walks
    to the cap and returns max_batch — the engine saturates its
    concurrency limit and the queue absorbs the rest, which is exactly
    what the M/G/c wait stage then prices.

    Returns ``(b_bar, converged, iterations)``.
    """
    lengths = np.asarray(lengths, dtype=np.float64)
    pi = np.asarray(tasks.pi)
    t0 = float(np.sum(pi * np.asarray(tasks.t0)))
    cl = float(np.sum(pi * np.asarray(tasks.c) * lengths))

    def es(b):
        return t0 + cl * model.ratio(b)

    def step(b):
        return min(float(max_batch), max(1.0, 1.0 + lam * es(b)))

    b = step(1.0)
    for i in range(max_iters):
        new = (1.0 - damping) * b + damping * step(b)
        if abs(new - b) < tol:
            return new, True, i + 1
        b = new
    return b, False, max_iters


def corrected_taskset(tasks: TaskSet, model: StepLatencyModel,
                      b_bar: float) -> TaskSet:
    """Occupancy-corrected task set: c_k scaled by r(b_bar).

    t0_k (prefill + fixed overhead) is left untouched — prefill runs as
    its own dispatch and its cost is not amortized over decode occupancy
    in the engines this models.
    """
    r = float(model.ratio(b_bar))
    return dataclasses.replace(tasks, c=np.asarray(tasks.c) * r)


class BatchServiceResult(NamedTuple):
    """Occupancy-corrected queueing prediction at one operating point."""

    b_bar: float            # steady-state in-service occupancy
    ratio: float            # r(b_bar) = t_step(b_bar) / t_step(1)
    mean_wait: float        # M/G/c wait of the corrected mixture
    mean_service: float     # E[S] at the corrected c
    mean_system_time: float
    converged: bool
    iterations: int


def batch_service_wait(tasks: TaskSet, lengths, lam: float,
                       model: StepLatencyModel, max_batch: int,
                       correction: str = "lee-longton",
                       damping: float = 0.5) -> BatchServiceResult:
    """Occupancy-corrected mean wait of a continuous-batching server.

    Pipeline: solve the occupancy fixed point, scale the task set's
    per-token costs by r(b_bar), then price the queue as M/G/c with
    c_servers = max_batch (the engine's concurrency limit) via
    ``core.mgc.mgc_wait_np``. With a flat latency model (d1 = 0) this
    reduces exactly to the uncorrected M/G/c prediction, and with
    max_batch = 1 to the paper's M/G/1 P-K wait.
    """
    model.validate()
    b_bar, converged, iters = occupancy_fixed_point(
        tasks, lengths, lam, model, max_batch, damping=damping)
    corrected = corrected_taskset(tasks, model, b_bar)
    lengths = np.asarray(lengths, dtype=np.float64)
    wait = float(mgc_wait_np(corrected, lengths, lam,
                             c_servers=max_batch, correction=correction))
    pi = np.asarray(corrected.pi)
    es = float(np.sum(pi * (np.asarray(corrected.t0)
                            + np.asarray(corrected.c) * lengths)))
    return BatchServiceResult(
        b_bar=float(b_bar), ratio=float(model.ratio(b_bar)),
        mean_wait=wait, mean_service=es, mean_system_time=wait + es,
        converged=bool(converged), iterations=int(iters))

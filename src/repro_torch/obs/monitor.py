"""Predicted-vs-measured drift monitor for the closed-loop controller.

The port of ``repro.obs.monitor`` (NumPy only). It compares the queueing
model's *live prediction*, Pollaczek-Khinchine at ``c=1`` (Lee-Longton via
``core.mgc``'s host mirrors for ``c>1``) evaluated at the online
estimator's current ``(lambda, E[S], E[S^2])`` point, against the
*measured* wait distribution folded into a streaming histogram since the
last re-solve. When the relative error on the mean (and optionally a tail
percentile, via the M/G/1 exponential-tail approximation
``P(W > t) = rho * exp(-t / (W/rho))``) exceeds ``rel_tol`` for
``patience`` consecutive checks, :meth:`DriftMonitor.check` returns a
:class:`DriftReport` with ``fired=True``: the structured alarm the
``ReplayHarness`` drift mode re-solves on, on evidence of model mismatch
instead of on a blind block clock.

A check with fewer than ``min_samples`` waits since the last resolve
reports ``reason="insufficient-data"`` and never fires (cold starts and
freshly reset windows are not drift). ``note_resolve()`` resets the
measurement window and the patience counter after the controller acts.

Disabled-path cost: the monitor exists only when constructed; producers
hold ``monitor=None`` and guard with one ``is not None`` check.
``observe`` is a vectorised histogram fold (a few integer passes per
block); ``check`` is O(buckets) and runs once per control block.
"""
from __future__ import annotations

import dataclasses

from .metrics import StreamingHistogram

__all__ = ["DriftMonitor", "DriftReport", "predicted_wait_quantile"]


def predicted_wait_quantile(q: float, mean_wait: float, rho: float) -> float:
    """M/G/1 exponential-tail wait quantile at percentile ``q`` in [0,100].

    The waiting time has an atom of mass ``1 - rho`` at zero and an
    approximately exponential conditional tail with mean ``W / rho``
    (exact for M/M/1; the standard heavy-traffic approximation
    otherwise): ``P(W > t) = rho * exp(-t / (W/rho))``.
    """
    p = q / 100.0
    if rho <= 0.0 or mean_wait <= 0.0 or p <= 1.0 - rho:
        return 0.0
    wc = mean_wait / rho
    import math
    return wc * math.log(rho / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Structured outcome of one drift check."""

    fired: bool                 # alarm: re-solve now
    reason: str                 # "drift" | "ok" | "insufficient-data"
    n: int                      # waits measured since last resolve
    predicted_wait: float       # model mean wait at the estimator point
    measured_wait: float        # measured mean wait
    rel_err: float              # |measured - predicted| / max(predicted, floor)
    predicted_q: float          # model tail quantile (exponential tail)
    measured_q: float           # measured tail quantile (histogram)
    rel_err_q: float            # tail relative error
    rho: float                  # estimator utilization at check time
    strikes: int                # consecutive over-tolerance checks
    # overload alarm (orthogonal to drift): the estimated utilization
    # itself crossed the monitor's ``rho_alarm`` threshold — the signal
    # admission control escalates on even when the queueing model still
    # fits the measurements (a correct model of an overloaded queue is
    # not drift, but it is an emergency)
    overload: bool = False

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DriftMonitor:
    """Accumulates measured waits and flags predicted-vs-measured drift.

    Parameters
    ----------
    rel_tol : relative error on the mean wait that counts as a strike.
    patience : consecutive striking checks required before firing (one
        noisy block never triggers a re-solve).
    min_samples : minimum waits in the window before checks are live.
    q : tail percentile to track alongside the mean (report-only by
        default; set ``gate_tail=True`` to require BOTH mean and tail
        over tolerance for a strike).
    wait_floor : absolute floor in the relative-error denominator so
        near-zero predicted waits (light traffic) don't divide to noise.
    rho_alarm : estimated-utilization threshold for the ``overload``
        flag on every report (instant — no patience: overload at the
        estimator's time constant is already smoothed). ``n_overloads``
        counts alarmed checks for reporting.
    """

    def __init__(self, *, rel_tol: float = 0.25, patience: int = 2,
                 min_samples: int = 64, q: float = 90.0,
                 gate_tail: bool = False, wait_floor: float = 1e-9,
                 bits: int = 5, rho_alarm: float = 0.95):
        self.rel_tol = float(rel_tol)
        self.patience = int(patience)
        self.min_samples = int(min_samples)
        self.q = float(q)
        self.gate_tail = bool(gate_tail)
        self.wait_floor = float(wait_floor)
        self.rho_alarm = float(rho_alarm)
        self.n_overloads = 0
        self._bits = int(bits)
        self._hist = StreamingHistogram(bits=self._bits)
        self._strikes = 0
        self.history: list = []     # DriftReport per check

    # -------------------------------------------------------------- feeding
    def observe(self, waits) -> None:
        """Fold a block of measured waits into the current window."""
        self._hist.record_many(waits)

    def note_resolve(self) -> None:
        """Reset the window after the controller re-solved: subsequent
        checks measure drift against the NEW operating point only."""
        self._hist = StreamingHistogram(bits=self._bits)
        self._strikes = 0

    # ------------------------------------------------------------- checking
    def _predict(self, state: dict) -> tuple:
        """(mean_wait, rho) from an estimator-state dict.

        ``state`` follows ``serving.estimators.EstimatorState.as_dict``:
        keys ``lam``, ``es``, ``es2`` (``None`` while the estimators are
        cold -> predicted 0), plus optional ``c_servers`` (NOT ``c``,
        which is the per-task latency slope there). P-K at c_servers=1;
        Erlang-C x Lee-Longton via ``core.mgc`` beyond (lazy import — the
        monitor stays dependency-free for the common case).
        """
        def val(key):
            v = state.get(key)
            return 0.0 if v is None else float(v)

        lam, es, es2 = val("lam"), val("es"), val("es2")
        c = int(state.get("c_servers") or 1)
        rho = lam * es / c
        if lam <= 0.0 or es <= 0.0 or rho >= 1.0:
            return 0.0, rho
        if c == 1:
            return lam * es2 / (2.0 * (1.0 - rho)), rho
        import numpy as np

        from ..core.mgc import _wait_factor, erlang_c_np
        cv2 = max(es2 / (es * es) - 1.0, 0.0)
        wait_mmc = float(erlang_c_np(c, lam * es)) / (c / es - lam)
        factor = float(_wait_factor(cv2, rho, c, "lee-longton", xp=np))
        return wait_mmc * factor, rho

    def check(self, state: dict) -> DriftReport:
        """Compare model prediction at ``state`` vs the measured window."""
        snap = self._hist.snapshot()
        predicted, rho = self._predict(state)
        predicted_q = predicted_wait_quantile(self.q, predicted, rho)
        measured = snap.mean
        measured_q = snap.percentile(self.q)
        denom = max(predicted, self.wait_floor)
        rel_err = abs(measured - predicted) / denom
        denom_q = max(predicted_q, self.wait_floor)
        rel_err_q = abs(measured_q - predicted_q) / denom_q
        # the overload alarm bypasses the sample gate: rho comes from the
        # estimators, not the wait window, and an empty window right
        # after a resolve is exactly when an overload must not be masked
        overload = rho >= self.rho_alarm
        if overload:
            self.n_overloads += 1

        if snap.n < self.min_samples:
            report = DriftReport(
                fired=False, reason="insufficient-data", n=snap.n,
                predicted_wait=predicted, measured_wait=measured,
                rel_err=rel_err, predicted_q=predicted_q,
                measured_q=measured_q, rel_err_q=rel_err_q, rho=rho,
                strikes=self._strikes, overload=overload)
            self.history.append(report)
            return report

        strike = rel_err > self.rel_tol
        if self.gate_tail:
            strike = strike and rel_err_q > self.rel_tol
        self._strikes = self._strikes + 1 if strike else 0
        fired = self._strikes >= self.patience
        report = DriftReport(
            fired=fired, reason="drift" if fired else "ok", n=snap.n,
            predicted_wait=predicted, measured_wait=measured,
            rel_err=rel_err, predicted_q=predicted_q,
            measured_q=measured_q, rel_err_q=rel_err_q, rho=rho,
            strikes=self._strikes, overload=overload)
        self.history.append(report)
        return report

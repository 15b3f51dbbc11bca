"""Online estimation of the serving operating point (the learning half of
the closed loop).

The port of ``repro.serving.estimators`` (NumPy only, no torch): the
solver stack (``core.allocator``, ``sweeps.solve_grid``) consumes an
operating point (lambda, pi, service moments); in production none of those
are oracle-known and must be estimated from the live request stream, the
"queueing control with predicted parameters" problem Mitzenmacher & Shahout
(arXiv 2503.07545) pose. The replay harness (``serving.replay``) threads
this estimator family through its block loop:

* :class:`RateEstimator`: arrival rate. Averages inter-arrival GAPS and
  inverts the mean (``lambda_hat = 1 / mean(gap)``). Never average
  reciprocal gaps: for exponential gaps ``E[1/X] = inf``, so an EWMA of
  ``1/gap`` is divergent and biased, and one near-zero gap spikes the
  estimate by ~``w/gap``.
* :class:`MixtureEstimator`: task-type mixture pi from observed type
  indices.
* :class:`ServiceMomentEstimator`: mixture service moments E[S], E[S^2]
  from observed per-request service times (the P-K inputs, eq 3/5).
* :class:`LatencyCalibrator`: per-task latency curve (t0_k, c_k) by
  weighted least squares of observed service time on the deployed token
  budget: the re-solve needs the *curve* t_k(l) = t0_k + c_k l (eq 1),
  not just the moments at the current budgets. Identifiability requires
  budget variation within a task; the replay harness provides it by
  jittering a small fraction of budgets (exploration).

Every estimator supports two memories behind one interface:

* ``mode="ewma"``: bias-corrected exponentially-weighted means with
  half-life measured in observations. Batch updates fold a whole control
  block at once in closed form and equal observation-at-a-time updates
  to round-off.
* ``mode="window"``: plain means over a sliding window of the last
  ``window`` observations.

:class:`EstimatorState` is the frozen snapshot the harness records per
control block and exposes through ``ServingReport.estimator_state``.

**Observation guards.** Production telemetry is dirty: a dropped clock
read arrives as NaN, an overflow as Inf, a race as a negative service
time. EWMA and window folds are means, so a single NaN would poison every
later estimate (``nan`` stays in the numerator forever) and, through
them, the re-solved budgets. Every ``observe_*`` therefore *skips* invalid
rows (non-finite anywhere; non-positive service times; out-of-range
types; out-of-order arrival gaps) and counts them in ``n_skipped``,
surfaced through ``EstimatorState.n_skipped`` so monitoring can alarm on
a corruption rate while the estimates themselves never degrade.

The arithmetic is the JAX package's, operation for operation, so the same
observation blocks give bitwise the same states
(``tests/test_torch_replay.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "RateEstimator", "MixtureEstimator", "ServiceMomentEstimator",
    "LatencyCalibrator", "OnlineEstimators", "EstimatorState",
]


# --------------------------------------------------------------------------
# Memory backends: one batched-mean interface, EWMA or sliding window
# --------------------------------------------------------------------------

class _EwmaMean:
    """Bias-corrected exponentially-weighted mean of (vector) observations.

    With per-observation decay ``a = 2^(-1/halflife)``, a batch of ``m``
    rows folds in closed form::

        num <- a^m num + (1-a) sum_i a^(m-1-i) x_i
        den <- a^m den + (1-a) sum_i a^(m-1-i)

    and ``mean = num / den`` — identical (to round-off) to ``m`` single
    updates. ``den -> 1`` as observations accumulate; normalizing by it
    removes the cold-start bias toward the zero init.
    """

    def __init__(self, halflife: float):
        if halflife <= 0:
            raise ValueError("halflife must be > 0")
        self._a = math.exp(-math.log(2.0) / halflife)
        self._num: np.ndarray | float = 0.0
        self._den: float = 0.0
        self.n = 0

    def update(self, x) -> None:
        x = np.asarray(x, dtype=np.float64)
        m = x.shape[0]
        if m == 0:
            return
        a = self._a
        w = (1.0 - a) * a ** np.arange(m - 1, -1, -1)   # [m], newest last
        self._num = a ** m * self._num + w @ x
        self._den = a ** m * self._den + float(w.sum())
        self.n += m

    @property
    def mean(self):
        if self._den <= 0.0:
            return None
        return self._num / self._den


class _WindowMean:
    """Plain mean over the trailing ``window`` observations."""

    def __init__(self, window: int):
        if window <= 0:
            raise ValueError("window must be > 0")
        self._window = int(window)
        self._buf: np.ndarray | None = None
        self.n = 0

    def update(self, x) -> None:
        x = np.asarray(x, dtype=np.float64)
        if x.shape[0] == 0:
            return
        self._buf = x if self._buf is None else \
            np.concatenate([self._buf, x], axis=0)
        if self._buf.shape[0] > self._window:
            self._buf = self._buf[-self._window:]
        self.n += x.shape[0]

    @property
    def mean(self):
        if self._buf is None:
            return None
        return self._buf.mean(axis=0)


def _make_mean(mode: str, halflife: float, window: int):
    if mode == "ewma":
        return _EwmaMean(halflife)
    if mode == "window":
        return _WindowMean(window)
    raise ValueError(f"unknown estimator mode {mode!r} "
                     "(expected 'ewma'|'window')")


# --------------------------------------------------------------------------
# Estimators
# --------------------------------------------------------------------------

class RateEstimator:
    """lambda_hat = 1 / (windowed/EWMA mean of inter-arrival gaps).

    ``t_origin`` anchors the first gap (the replay clock starts at 0); pass
    ``t_origin=None`` to discard the first timestamp instead (unknown
    origin, the allocator's convention).
    """

    def __init__(self, halflife: float = 2048.0, mode: str = "ewma",
                 window: int = 8192, t_origin: float | None = 0.0):
        self._mean = _make_mean(mode, halflife, window)
        self._last_t = t_origin
        self.n_skipped = 0

    def observe_arrivals(self, ts) -> None:
        """Fold a block of absolute arrival timestamps (sorted).

        Non-finite timestamps are skipped and counted (``n_skipped``)
        before gaps are formed, so one NaN clock read costs one gap, not
        the whole estimate; negative gaps (out-of-order stamps) are
        likewise skipped rather than folded."""
        ts = np.asarray(ts, dtype=np.float64)
        bad = ~np.isfinite(ts)
        if bad.any():
            self.n_skipped += int(bad.sum())
            ts = ts[~bad]
        if ts.shape[0] == 0:
            return
        if self._last_t is None:
            self._last_t = float(ts[0])
            ts = ts[1:]
            if ts.shape[0] == 0:
                return
        gaps = np.diff(ts, prepend=self._last_t)
        self._last_t = float(ts[-1])
        neg = gaps < 0.0
        if neg.any():
            self.n_skipped += int(neg.sum())
            gaps = gaps[~neg]
        self._mean.update(gaps)

    def observe(self, t: float) -> None:
        self.observe_arrivals([t])

    @property
    def n(self) -> int:
        return self._mean.n

    @property
    def gap(self) -> float | None:
        m = self._mean.mean
        return None if m is None else float(m)

    @property
    def lam(self) -> float | None:
        g = self.gap
        return None if g is None else 1.0 / max(g, 1e-12)


class MixtureEstimator:
    """Type-mixture pi_hat from observed task indices (one-hot means)."""

    def __init__(self, n_tasks: int, halflife: float = 2048.0,
                 mode: str = "ewma", window: int = 8192):
        self.n_tasks = int(n_tasks)
        self._mean = _make_mean(mode, halflife, window)
        self.n_skipped = 0

    def observe_types(self, types) -> None:
        """Fold observed type indices; out-of-range indices (a corrupted
        router tag) are skipped and counted, never folded."""
        types = np.asarray(types, dtype=np.int64)
        bad = (types < 0) | (types >= self.n_tasks)
        if bad.any():
            self.n_skipped += int(bad.sum())
            types = types[~bad]
        if types.shape[0] == 0:
            return
        onehot = np.zeros((types.shape[0], self.n_tasks))
        onehot[np.arange(types.shape[0]), types] = 1.0
        self._mean.update(onehot)

    @property
    def n(self) -> int:
        return self._mean.n

    @property
    def pi(self) -> np.ndarray | None:
        m = self._mean.mean
        if m is None:
            return None
        s = m.sum()
        return m / s if s > 0 else np.full(self.n_tasks, 1.0 / self.n_tasks)


class ServiceMomentEstimator:
    """Mixture moments E[S], E[S^2] from observed service times (eq 3)."""

    def __init__(self, halflife: float = 2048.0, mode: str = "ewma",
                 window: int = 8192):
        self._mean = _make_mean(mode, halflife, window)
        self.n_skipped = 0

    def observe_services(self, s) -> None:
        """Fold observed service times; non-finite or non-positive values
        (NaN/Inf telemetry, negative clock races) are skipped and
        counted — one poisoned measurement must not NaN the P-K inputs
        forever (the EWMA numerator never recovers from a NaN fold)."""
        s = np.asarray(s, dtype=np.float64)
        bad = ~(np.isfinite(s) & (s > 0.0))
        if bad.any():
            self.n_skipped += int(bad.sum())
            s = s[~bad]
        if s.shape[0] == 0:
            return
        self._mean.update(np.stack([s, s * s], axis=-1))

    @property
    def n(self) -> int:
        return self._mean.n

    @property
    def es(self) -> float | None:
        m = self._mean.mean
        return None if m is None else float(m[0])

    @property
    def es2(self) -> float | None:
        m = self._mean.mean
        return None if m is None else float(m[1])

    def rho(self, lam: float) -> float | None:
        es = self.es
        return None if es is None else float(lam) * es

    def pk_wait(self, lam: float) -> float | None:
        """Pollaczek-Khinchine E[W] (eq 5) at the estimated moments."""
        es2, rho = self.es2, self.rho(lam)
        if es2 is None or rho is None:
            return None
        return lam * es2 / (2.0 * (1.0 - rho)) if rho < 1.0 else math.inf


class LatencyCalibrator:
    """Per-task online WLS fit of the latency curve t_k(l) = t0_k + c_k l.

    Maintains (EWMA or windowed) means of ``[l, s, l^2, l*s]`` per task;
    the slope is ``cov(l, s) / var(l)`` whenever the deployed budgets show
    enough within-task variation (``var(l) > var_min`` with >= 2 samples),
    else the last identified slope (or the uninformed prior) is kept and
    the intercept tracks ``mean(s) - c_hat * mean(l)``. Estimates are
    clipped to the solver's validity domain (``c_hat >= c_min > 0``,
    ``t0_hat >= t0_min``) so an estimated TaskSet always validates.
    """

    def __init__(self, n_tasks: int, halflife: float = 2048.0,
                 mode: str = "ewma", window: int = 8192,
                 t0_prior: float = 0.1, c_prior: float = 0.01,
                 var_min: float = 1e-6, c_min: float = 1e-5,
                 t0_min: float = 1e-6):
        self.n_tasks = int(n_tasks)
        self._means = [_make_mean(mode, halflife, window)
                       for _ in range(self.n_tasks)]
        self._c_hat = np.full(self.n_tasks, float(c_prior))
        self._identified = np.zeros(self.n_tasks, dtype=bool)
        self._t0_prior = float(t0_prior)
        self._var_min = float(var_min)
        self._c_min = float(c_min)
        self._t0_min = float(t0_min)
        self.n_skipped = 0

    def observe(self, types, budgets, services) -> None:
        """Fold (type, budget, service) rows; rows with a non-finite /
        non-positive service, non-finite / negative budget, or
        out-of-range type are skipped and counted."""
        types = np.asarray(types, dtype=np.int64)
        budgets = np.asarray(budgets, dtype=np.float64)
        services = np.asarray(services, dtype=np.float64)
        ok = (np.isfinite(services) & (services > 0.0)
              & np.isfinite(budgets) & (budgets >= 0.0)
              & (types >= 0) & (types < self.n_tasks))
        if not ok.all():
            self.n_skipped += int((~ok).sum())
            types, budgets, services = types[ok], budgets[ok], services[ok]
        for k in np.unique(types):
            sel = types == k
            l, s = budgets[sel], services[sel]
            self._means[k].update(np.stack([l, s, l * l, l * s], axis=-1))

    @property
    def n(self) -> int:
        return sum(m.n for m in self._means)

    def params(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns ``(t0_hat [N], c_hat [N], identified [N])``."""
        t0 = np.full(self.n_tasks, self._t0_prior)
        for k, m in enumerate(self._means):
            mm = m.mean
            if mm is None:
                continue
            ml, ms, mll, mls = mm
            var = mll - ml * ml
            if m.n >= 2 and var > self._var_min:
                self._c_hat[k] = max((mls - ml * ms) / var, self._c_min)
                self._identified[k] = True
            t0[k] = max(ms - self._c_hat[k] * ml, self._t0_min)
        return t0, self._c_hat.copy(), self._identified.copy()


# --------------------------------------------------------------------------
# Bundle + snapshot
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EstimatorState:
    """Frozen snapshot of every online estimate at one control instant."""

    lam: float                  # arrival-rate estimate (nan before data)
    pi: np.ndarray              # [N] mixture estimate
    es: float                   # E[S] estimate (nan before data)
    es2: float                  # E[S^2] estimate
    rho: float                  # lam * E[S]
    t0: np.ndarray              # [N] latency intercept estimates
    c: np.ndarray               # [N] latency slope estimates
    identified: np.ndarray      # [N] slope identified from data?
    n_arrivals: int
    n_services: int
    # invalid observations skipped by the guards (NaN/Inf/non-positive),
    # summed across the bank — a health signal for monitoring, not an
    # input to any estimate
    n_skipped: int = 0

    @property
    def pk_wait(self) -> float:
        """P-K E[W] (eq 5) at the estimated operating point."""
        if not np.isfinite(self.rho):
            return math.nan
        return (self.lam * self.es2 / (2.0 * (1.0 - self.rho))
                if self.rho < 1.0 else math.inf)

    def as_dict(self) -> dict:
        """JSON-able snapshot (``ServingReport.estimator_state``)."""
        return {
            "lam": float(self.lam),
            "pi": [float(p) for p in self.pi],
            "es": float(self.es),
            "es2": float(self.es2),
            "rho": float(self.rho),
            "pk_wait": float(self.pk_wait),
            "t0": [float(v) for v in self.t0],
            "c": [float(v) for v in self.c],
            "identified": [bool(v) for v in self.identified],
            "n_arrivals": int(self.n_arrivals),
            "n_services": int(self.n_services),
            "n_skipped": int(self.n_skipped),
        }


class OnlineEstimators:
    """The full estimator bank one serving control loop needs.

    ``observe_block(arrivals, types, budgets, services)`` folds one control
    block of per-request observations into every estimator; ``state()``
    snapshots them. This is the object the replay harness threads through
    its block loop.
    """

    def __init__(self, n_tasks: int, halflife: float = 2048.0,
                 mode: str = "ewma", window: int = 8192,
                 t0_prior: float = 0.1, c_prior: float = 0.01):
        self.rate = RateEstimator(halflife, mode, window)
        self.mixture = MixtureEstimator(n_tasks, halflife, mode, window)
        self.moments = ServiceMomentEstimator(halflife, mode, window)
        self.latency = LatencyCalibrator(n_tasks, halflife, mode, window,
                                         t0_prior=t0_prior, c_prior=c_prior)
        self.n_tasks = int(n_tasks)

    def observe_block(self, arrivals, types, budgets, services) -> None:
        self.rate.observe_arrivals(arrivals)
        self.mixture.observe_types(types)
        self.moments.observe_services(services)
        self.latency.observe(types, budgets, services)

    def state(self) -> EstimatorState:
        lam = self.rate.lam
        pi = self.mixture.pi
        es, es2 = self.moments.es, self.moments.es2
        t0, c, ident = self.latency.params()
        lam_f = math.nan if lam is None else lam
        es_f = math.nan if es is None else es
        return EstimatorState(
            lam=lam_f,
            pi=(np.full(self.n_tasks, 1.0 / self.n_tasks)
                if pi is None else pi),
            es=es_f,
            es2=math.nan if es2 is None else es2,
            rho=lam_f * es_f,
            t0=t0, c=c, identified=ident,
            n_arrivals=self.rate.n,
            n_services=self.moments.n,
            n_skipped=(self.rate.n_skipped + self.mixture.n_skipped
                       + self.moments.n_skipped + self.latency.n_skipped),
        )

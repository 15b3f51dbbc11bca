"""Service-length predictors for the predicted scheduling disciplines.

The paper assumes each query's task type — hence its thinking-token count
and service time t_k(l_k) — is known at arrival. Real schedulers see a
*prediction* (Mitzenmacher & Shahout, arXiv:2503.07545; Yang et al.,
arXiv:2407.05347). This module supplies that prediction layer for the
SPJF/SPRPT disciplines in ``queueing_sim.disciplines``:

* :class:`LengthPredictor` — a frozen point predictor (oracle identity,
  two-point classifier, or quantile bucketizer over calibration service
  times) composed with a multiplicative log-normal error model:

      predicted = point(s) * exp(sigma * Z - sigma^2 / 2),   Z ~ N(0, 1)

  The ``- sigma^2 / 2`` term makes the noise mean-one (unbiased in
  expectation), so ``sigma`` sweeps vary only the error *spread* — the
  axis of the robustness frontier in ``sweeps.prediction``. At
  ``sigma = 0`` the factor is exactly ``1.0`` and the oracle predictor
  returns the true services bitwise, which is what pins SPJF == SJF and
  SPRPT == SRPT at zero error.
* :func:`fit_two_point` / :func:`fit_quantile` — fit the classifier
  boundaries/values from calibration service-time samples.
* :func:`calibrate_from_synthetic` — derive those samples from the
  synthetic token pipeline (``data.synthetic.SyntheticTokens``): its
  per-sequence task annotations are the same task types the serving
  workload draws, so the predictor is calibrated on the data
  distribution the server will face, mapped through t_k(l_k).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LengthPredictor", "fit_two_point", "fit_quantile",
           "calibrate_from_synthetic", "lognormal_factors"]


def lognormal_factors(z, sigma: float) -> np.ndarray:
    """Mean-one multiplicative error factors ``exp(sigma * z - sigma^2/2)``.

    ``sigma = 0`` returns exact ones (the exponent is identically zero),
    preserving bitwise zero-error reductions.
    """
    z = np.asarray(z, dtype=np.float64)
    s = float(sigma)
    return np.exp(s * z - 0.5 * s * s)


@dataclasses.dataclass(frozen=True)
class LengthPredictor:
    """Point predictor + tunable log-normal error, applied to services.

    ``kind``:

    * ``"oracle"`` — point prediction is the true service time itself
      (the paper's full-information assumption); with ``sigma = 0`` this
      is the identity, the zero-error anchor of every frontier.
    * ``"two_point"`` / ``"quantile"`` — a fitted step function:
      ``boundaries`` are ascending service-time cut points and ``values``
      (one longer) the predicted service per bucket, i.e. the classifier
      "this looks like a short/long query" with per-class mean lengths.

    ``predict`` composes the point prediction with multiplicative
    log-normal noise of scale ``sigma`` (see :func:`lognormal_factors`).
    Noise is deterministic given (``seed``, shape) unless the caller
    passes its own ``rng`` or pre-drawn standard normals ``z`` (the sweep
    layers do, to keep predictions common random numbers across policy
    and lambda axes).
    """

    kind: str = "oracle"
    sigma: float = 0.0
    boundaries: tuple = ()
    values: tuple = ()
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("oracle", "two_point", "quantile"):
            raise ValueError(f"unknown predictor kind {self.kind!r}")
        if self.sigma < 0 or not np.isfinite(self.sigma):
            raise ValueError("sigma must be finite and >= 0")
        if self.kind != "oracle":
            if len(self.values) != len(self.boundaries) + 1:
                raise ValueError(
                    f"need len(values) == len(boundaries) + 1, got "
                    f"{len(self.values)} vs {len(self.boundaries)}")
            if list(self.boundaries) != sorted(self.boundaries):
                raise ValueError("boundaries must be ascending")

    def with_sigma(self, sigma: float) -> "LengthPredictor":
        """Same point predictor at a different error level (the frontier
        sweeps one fitted predictor across a sigma axis)."""
        return dataclasses.replace(self, sigma=float(sigma))

    def point(self, services) -> np.ndarray:
        """Noise-free point prediction per query."""
        s = np.asarray(services, dtype=np.float64)
        if self.kind == "oracle":
            return s
        vals = np.asarray(self.values, dtype=np.float64)
        return vals[np.digitize(s, np.asarray(self.boundaries))]

    def predict(self, services, rng=None, z=None) -> np.ndarray:
        """Predicted service per query: ``point * lognormal_factors``.

        ``z`` (pre-drawn standard normals) must match the services shape
        exactly when given — a mis-sized noise array raises rather than
        silently broadcasting one draw over many queries. With
        ``sigma == 0`` the point prediction is returned untouched (for
        the oracle kind: the input services, bitwise).
        """
        p = self.point(services)
        if self.sigma == 0.0:
            return p
        if z is None:
            z = (rng if rng is not None
                 else np.random.default_rng(self.seed)).standard_normal(
                     p.shape)
        z = np.asarray(z, dtype=np.float64)
        if z.shape != p.shape:
            raise ValueError(
                f"noise shape {z.shape} must match the services shape "
                f"{p.shape} exactly (one draw per query)")
        return p * lognormal_factors(z, self.sigma)


def fit_two_point(samples, threshold_q: float = 0.5,
                  sigma: float = 0.0, seed: int = 0) -> LengthPredictor:
    """Two-point predictor: short/long classes split at a quantile.

    The coarsest useful predictor — "is this a short or a long query" —
    with each class predicted at its calibration mean. ``threshold_q``
    places the split at that quantile of the calibration services.
    """
    s = np.asarray(samples, dtype=np.float64).ravel()
    if s.size < 2:
        raise ValueError("need at least 2 calibration samples")
    cut = float(np.quantile(s, threshold_q))
    lo, hi = s[s <= cut], s[s > cut]
    if lo.size == 0 or hi.size == 0:         # degenerate split: one class
        m = float(s.mean())
        return LengthPredictor(kind="two_point", boundaries=(cut,),
                               values=(m, m), sigma=sigma, seed=seed)
    return LengthPredictor(kind="two_point", boundaries=(cut,),
                           values=(float(lo.mean()), float(hi.mean())),
                           sigma=sigma, seed=seed)


def fit_quantile(samples, n_bins: int = 4,
                 sigma: float = 0.0, seed: int = 0) -> LengthPredictor:
    """Quantile predictor: ``n_bins`` equal-mass buckets, per-bucket means."""
    s = np.asarray(samples, dtype=np.float64).ravel()
    if s.size < n_bins:
        raise ValueError(f"need >= n_bins={n_bins} calibration samples")
    if n_bins < 2:
        raise ValueError("need n_bins >= 2 (1 bin predicts a constant)")
    qs = np.quantile(s, np.linspace(0, 1, n_bins + 1)[1:-1])
    bounds = tuple(float(q) for q in np.unique(qs))
    edges = np.concatenate([[-np.inf], bounds, [np.inf]])
    vals = []
    for i in range(len(bounds) + 1):
        sel = (s > edges[i]) & (s <= edges[i + 1])
        vals.append(float(s[sel].mean()) if sel.any() else float(s.mean()))
    return LengthPredictor(kind="quantile", boundaries=bounds,
                           values=tuple(vals), sigma=sigma, seed=seed)


def calibrate_from_synthetic(problem, lengths, n_batches: int = 8,
                             batch_size: int = 256, kind: str = "two_point",
                             n_bins: int = 4, sigma: float = 0.0,
                             seed: int = 0) -> LengthPredictor:
    """Fit a predictor from the synthetic data pipeline's task stream.

    Draws ``n_batches`` batches of task annotations from
    ``data.synthetic.SyntheticTokens`` (the same deterministic pipeline
    the training example consumes), maps each task through the latency
    model t_k(l_k) at the deployed budgets ``lengths``, and fits the
    requested step predictor on the resulting service-time sample. The
    returned predictor is a pure function of (``seed``, ``lengths``,
    config shape), like every other artifact in the pipeline.
    """
    from ..data.synthetic import DataConfig, SyntheticTokens

    lengths = np.asarray(lengths, dtype=np.float64)
    n_tasks = problem.tasks.n_tasks
    cfg = DataConfig(vocab_size=64, seq_len=1, batch_size=int(batch_size),
                     n_tasks=n_tasks, seed=int(seed))
    data = SyntheticTokens(cfg)
    types = np.concatenate([data.batch(step)["tasks"]
                            for step in range(int(n_batches))])
    t0 = np.asarray(problem.tasks.t0)
    c = np.asarray(problem.tasks.c)
    services = (t0 + c * lengths)[types]
    if kind == "two_point":
        return fit_two_point(services, sigma=sigma, seed=seed)
    if kind == "quantile":
        return fit_quantile(services, n_bins=n_bins, sigma=sigma, seed=seed)
    raise ValueError(f"unknown predictor kind {kind!r} "
                     "(expected 'two_point'|'quantile')")

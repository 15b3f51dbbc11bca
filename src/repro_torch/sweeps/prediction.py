"""Robustness frontier of predicted scheduling vs. prediction error.

The paper's discipline results assume the scheduler knows each query's
service time. ``queueing_sim.disciplines`` adds the predicted variants —
SPJF (non-preemptive, predicted job size as priority key) and SPRPT
(preemptive, predicted remaining time) — whose keys come from a
``data.predictor.LengthPredictor`` with tunable multiplicative log-normal
error. This module sweeps the *error* axis:

* :func:`sweep_prediction_error` — one policy, a lambda grid, and a sigma
  grid; returns a :class:`PredictionFrontier` holding mean-wait and
  p99-wait curves for the predicted disciplines at every (sigma, lambda)
  cell plus the sigma-independent FIFO/SJF/SRPT reference lanes, all on
  common random numbers (one stream batch per lambda, one noise draw per
  query reused across the whole sigma axis — so a curve moves only
  because the *ordering* changed, never because the workload did).
* :func:`fifo_crossover_sigma` — the headline scalar: the error level at
  which a predicted discipline stops beating size-blind FIFO. SPRPT's
  mean wait crosses FIFO at finite sigma when the service distribution
  has CV^2 < 1 (blind preemption degrades toward processor sharing,
  which *loses* to FIFO at low variability); SPJF's mean wait converges
  to FIFO from below as sigma grows (random order == FIFO in mean), so
  its crossover shows up in the p99 tail, not the mean. Use
  :func:`service_cv2` to check which regime a policy is in.

All lanes share the FIFO Lindley pass per lambda (work conservation:
the busy structure is discipline-independent), so the whole frontier
costs roughly one FIFO sweep plus one key-selection pass per sigma lane.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.params import Problem
from ..data.predictor import LengthPredictor
from ..queueing_sim.batched import _accuracy_table, _service_table, lindley_numpy
from ..queueing_sim.disciplines import (DEFAULT_WINDOW, _apply_fallback,
                                        _windowed_numpy_multi,
                                        sprpt_start_finish,
                                        srpt_start_finish)
from ..queueing_sim.stats import ci95
from ..queueing_sim.workload import generate_streams

__all__ = ["PredictionFrontier", "sweep_prediction_error",
           "fifo_crossover_sigma", "service_cv2"]


def service_cv2(problem: Problem, lengths) -> float:
    """Squared coefficient of variation of the service mixture at the
    deployed budgets: Var[S] / E[S]^2 under the type priors pi.

    The regime indicator for the SPRPT mean-wait crossover: CV^2 < 1
    (service times more regular than exponential) is where size-blind
    preemption underperforms FIFO, so the crossover sigma is finite.
    """
    s = np.asarray(problem.tasks.t0) + np.asarray(problem.tasks.c) \
        * np.asarray(lengths, dtype=np.float64)
    pi = np.asarray(problem.tasks.pi)
    m1 = float(np.sum(pi * s))
    m2 = float(np.sum(pi * s * s))
    return (m2 - m1 * m1) / (m1 * m1)


@dataclasses.dataclass(frozen=True)
class PredictionFrontier:
    """Curves from one :func:`sweep_prediction_error` run.

    ``mean_wait`` / ``p99_wait`` / ``ci_mean_wait`` map discipline name to
    a curve: shape ``[L]`` (over ``lams``) for the sigma-independent
    reference lanes ("fifo", "sjf", "srpt"), shape ``[G, L]`` (over
    ``sigmas`` x ``lams``) for the predicted lanes ("spjf", "sprpt").
    ``accuracy`` is discipline-independent (realized correctness does not
    depend on service order), shape ``[L]``. ``overflow_frac`` is the
    fraction of (seed, sigma-lane) streams that fell back to the heapq
    oracle, per discipline.
    """

    sigmas: np.ndarray
    lams: np.ndarray
    lengths: np.ndarray
    mean_wait: dict
    p99_wait: dict
    ci_mean_wait: dict
    accuracy: np.ndarray
    cv2: float
    overflow_frac: dict
    n_seeds: int
    n_queries: int
    seed: int
    predictor_kind: str

    def curve(self, discipline: str, metric: str = "mean_wait") -> np.ndarray:
        table = {"mean_wait": self.mean_wait, "p99_wait": self.p99_wait,
                 "ci_mean_wait": self.ci_mean_wait}[metric]
        return table[discipline]

    def summary(self) -> dict:
        """JSON-serializable dump (lists, not arrays) for bench artifacts."""
        as_list = lambda d: {k: np.asarray(v).tolist() for k, v in d.items()}
        return {
            "sigmas": self.sigmas.tolist(),
            "lams": self.lams.tolist(),
            "lengths": self.lengths.tolist(),
            "mean_wait": as_list(self.mean_wait),
            "p99_wait": as_list(self.p99_wait),
            "ci_mean_wait": as_list(self.ci_mean_wait),
            "accuracy": self.accuracy.tolist(),
            "cv2": self.cv2,
            "overflow_frac": as_list(self.overflow_frac),
            "n_seeds": self.n_seeds,
            "n_queries": self.n_queries,
            "seed": self.seed,
            "predictor_kind": self.predictor_kind,
        }


def _wait_stats(start, arrivals):
    """(mean over seeds of per-seed mean wait, ci95, mean per-seed p99)."""
    w = start - arrivals
    per_seed_mean = w.mean(axis=-1)
    per_seed_p99 = np.percentile(w, 99.0, axis=-1)
    return (per_seed_mean.mean(axis=-1), ci95(per_seed_mean, axis=-1),
            per_seed_p99.mean(axis=-1))


def sweep_prediction_error(problem: Problem, lengths, lams, sigmas,
                           predicted_disciplines=("spjf", "sprpt"),
                           predictor=None, n_seeds: int = 16,
                           n_queries: int = 4000, seed: int = 0,
                           window: int = DEFAULT_WINDOW,
                           prompt_len_range=(16, 128)) -> PredictionFrontier:
    """Sweep prediction error sigma for one deployed policy.

    ``lengths``: ``[N]`` per-task token budgets (one policy — the error
    axis replaces the policy axis of ``sweep_disciplines``). ``lams``:
    arrival-rate grid. ``sigmas``: log-normal error scales; include 0.0
    to anchor the curves at the full-information optimum (where SPJF and
    SPRPT are bitwise SJF and SRPT — the frontier's left edge *is* the
    pinned reference lane).

    ``predictor`` supplies the point prediction (``None`` = oracle); its
    ``sigma`` field is ignored — the grid overrides it via
    ``with_sigma``. Noise normals are drawn once per ``(predictor.seed,
    seed)`` over the ``[n_seeds, n_queries]`` query grid, matching the
    ``_predict_services`` convention in ``queueing_sim.disciplines``, and
    reused across every sigma and lambda (exponential gaps at different
    lambdas are scale factors of the same uniforms, so the entire
    frontier is common random numbers).

    All SPJF sigma lanes run through one K-lane masked-argmin call per
    lambda (the busy split is key-independent); SPRPT lanes share the
    FIFO Lindley pass. Streams overflowing ``window`` fall back to the
    exact heapq oracles.
    """
    for d in predicted_disciplines:
        if d not in ("spjf", "sprpt"):
            raise ValueError(f"unknown predicted discipline {d!r} "
                             "(expected 'spjf'|'sprpt')")
    if predictor is None:
        predictor = LengthPredictor()
    lengths = np.asarray(lengths, dtype=np.float64)
    lams = np.asarray(lams, dtype=np.float64)
    sigmas = np.asarray(sigmas, dtype=np.float64)
    Lg, G = lams.shape[0], sigmas.shape[0]

    refs = ("fifo", "sjf", "srpt")
    mean_wait = {d: np.zeros(Lg) for d in refs}
    p99_wait = {d: np.zeros(Lg) for d in refs}
    ci_mean = {d: np.zeros(Lg) for d in refs}
    ovf_frac = {d: np.zeros(Lg) for d in refs if d != "fifo"}
    for d in predicted_disciplines:
        mean_wait[d] = np.zeros((G, Lg))
        p99_wait[d] = np.zeros((G, Lg))
        ci_mean[d] = np.zeros((G, Lg))
        ovf_frac[d] = np.zeros((G, Lg))
    accuracy = np.zeros(Lg)

    t_tab = _service_table(problem, lengths[None, :])[0]     # [N]
    p_tab = _accuracy_table(problem, lengths[None, :])[0]    # [N]
    z = np.random.default_rng(
        (int(predictor.seed), int(seed))).standard_normal(
            (n_seeds, n_queries))

    for i, lam in enumerate(lams):
        batch = generate_streams(problem.tasks, float(lam), n_seeds,
                                 n_queries, seed=seed,
                                 prompt_len_range=prompt_len_range)
        svc = t_tab[batch.types]                             # [S, n]
        arr = batch.arrivals
        p_query = p_tab[batch.types]
        accuracy[i] = float((batch.correct_us < p_query).mean())

        st_f, fin_f = lindley_numpy(arr, svc)
        mean_wait["fifo"][i], ci_mean["fifo"][i], p99_wait["fifo"][i] = \
            _wait_stats(st_f, arr)

        # predicted keys for every sigma lane (one point prediction, one
        # noise draw, G deterministic rescalings)
        preds = [predictor.with_sigma(float(sg)).predict(svc, z=z)
                 for sg in sigmas]

        # non-preemptive lanes: SJF + all SPJF sigmas in one K-lane pass
        keys_list = [svc]
        if "spjf" in predicted_disciplines:
            keys_list += preds
        st_k, fin_k, o = _windowed_numpy_multi(arr, svc, keys_list, window,
                                               fifo_finish=fin_f)
        if o.any():
            for kk, keys in enumerate(keys_list):
                st_k[kk], fin_k[kk], _ = _apply_fallback(
                    arr, svc, keys, st_k[kk], fin_k[kk], o)
        mean_wait["sjf"][i], ci_mean["sjf"][i], p99_wait["sjf"][i] = \
            _wait_stats(st_k[0], arr)
        ovf_frac["sjf"][i] = float(o.mean())
        if "spjf" in predicted_disciplines:
            for g in range(G):
                (mean_wait["spjf"][g, i], ci_mean["spjf"][g, i],
                 p99_wait["spjf"][g, i]) = _wait_stats(st_k[1 + g], arr)
                ovf_frac["spjf"][g, i] = float(o.mean())

        # preemptive lanes: SRPT reference + per-sigma SPRPT
        st_r, _, o_r = srpt_start_finish(arr, svc, window, fifo_finish=fin_f)
        mean_wait["srpt"][i], ci_mean["srpt"][i], p99_wait["srpt"][i] = \
            _wait_stats(st_r, arr)
        ovf_frac["srpt"][i] = float(o_r.mean())
        if "sprpt" in predicted_disciplines:
            for g in range(G):
                st_p, _, o_p = sprpt_start_finish(arr, svc, preds[g],
                                                  window, fifo_finish=fin_f)
                (mean_wait["sprpt"][g, i], ci_mean["sprpt"][g, i],
                 p99_wait["sprpt"][g, i]) = _wait_stats(st_p, arr)
                ovf_frac["sprpt"][g, i] = float(o_p.mean())

    return PredictionFrontier(
        sigmas=sigmas, lams=lams, lengths=lengths, mean_wait=mean_wait,
        p99_wait=p99_wait, ci_mean_wait=ci_mean, accuracy=accuracy,
        cv2=service_cv2(problem, lengths), overflow_frac=ovf_frac,
        n_seeds=int(n_seeds), n_queries=int(n_queries), seed=int(seed),
        predictor_kind=predictor.kind)


def fifo_crossover_sigma(frontier: PredictionFrontier,
                         discipline: str = "sprpt",
                         metric: str = "mean_wait",
                         lam_index: int = -1) -> float:
    """Smallest sigma at which ``discipline`` stops beating FIFO.

    Scans the ``[G]`` curve at one lambda for the first sign change of
    ``curve(discipline) - curve(fifo)`` and linearly interpolates the
    crossing sigma. Returns ``sigmas[0]`` if the discipline never beats
    FIFO (already at/above it at the left edge) and ``inf`` if it still
    beats FIFO at the largest swept sigma — a *finite* value is the
    robustness budget: how much prediction error the discipline tolerates
    before size-blind FIFO is the better scheduler.
    """
    curve = np.asarray(frontier.curve(discipline, metric))[:, lam_index]
    ref = float(np.asarray(frontier.curve("fifo", metric))[lam_index])
    sig = np.asarray(frontier.sigmas, dtype=np.float64)
    diff = curve - ref
    if diff[0] >= 0:
        return float(sig[0])
    above = np.nonzero(diff >= 0)[0]
    if above.size == 0:
        return float("inf")
    g = int(above[0])
    d0, d1 = diff[g - 1], diff[g]
    # linear interpolation of the sign change within [sigmas[g-1], sigmas[g]]
    frac = float(-d0 / (d1 - d0)) if d1 != d0 else 0.0
    return float(sig[g - 1] + frac * (sig[g] - sig[g - 1]))

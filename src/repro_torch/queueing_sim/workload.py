"""Workload generation: Poisson arrivals over heterogeneous task types.

Mirrors the paper's Section IV setup: a stream of queries arrives as a
Poisson process with rate lambda; each query is type k w.p. pi_k,
independently. The same stream drives the analytical prediction (service
time = t_k(l_k)) and the serving engine (service = prefill + decode of l_k
tokens).

Two representations:

* :class:`Stream` — a tuple of :class:`Query` objects, consumed by the
  event-driven simulator (``mg1.simulate``) and the serving engine.
* :class:`StreamBatch` — ``[n_seeds, n_queries]`` arrays from a single RNG
  (:func:`generate_streams`), consumed by the batched simulators. Because
  the exponential gaps are a fixed scale factor of the underlying standard
  draws, batches generated at different arrival rates from the same seed
  are common random numbers.

Plus :class:`DriftTrace`, a flat trace with piecewise-stationary
(lambda, pi) (:func:`generate_drift_trace`). Everything here is the JAX
package's numpy code: it draws from ``default_rng`` in the same order, so
one seed gives the same streams in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.params import TaskSet


@dataclasses.dataclass(frozen=True)
class Query:
    qid: int
    task: int           # task-type index k
    arrival: float      # arrival time (s)
    prompt_len: int     # prompt tokens (used by the serving engine)
    correct_u: float    # uniform draw for Bernoulli(p_k) correctness


@dataclasses.dataclass(frozen=True)
class Stream:
    queries: tuple
    lam: float
    horizon: float

    def __len__(self):
        return len(self.queries)


def generate_stream(tasks: TaskSet, lam: float, n_queries: int,
                    seed: int = 0, prompt_len_range=(16, 128)) -> Stream:
    """Poisson(lam) arrivals, iid type draws from pi (paper Sec IV)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / lam, size=n_queries)
    arrivals = np.cumsum(gaps)
    types = rng.choice(tasks.n_tasks, size=n_queries,
                       p=np.asarray(tasks.pi.numpy(), dtype=np.float64))
    plens = rng.integers(prompt_len_range[0], prompt_len_range[1] + 1,
                         size=n_queries)
    us = rng.uniform(size=n_queries)
    queries = tuple(
        Query(qid=i, task=int(types[i]), arrival=float(arrivals[i]),
              prompt_len=int(plens[i]), correct_u=float(us[i]))
        for i in range(n_queries)
    )
    horizon = float(arrivals[-1]) if n_queries else 0.0
    return Stream(queries=queries, lam=lam, horizon=horizon)


def empirical_mixture(stream: Stream, n_tasks: int) -> np.ndarray:
    counts = np.bincount([q.task for q in stream.queries], minlength=n_tasks)
    return counts / counts.sum()


@dataclasses.dataclass(frozen=True)
class StreamBatch:
    """``[n_seeds, n_queries]`` query streams for the batched simulator."""

    arrivals: np.ndarray      # [S, n] float64, per-replicate arrival times
    types: np.ndarray         # [S, n] int, task-type index k
    prompt_lens: np.ndarray   # [S, n] int, prompt tokens
    correct_us: np.ndarray    # [S, n] float64, uniforms for Bernoulli(p_k)
    lam: float
    seed: int

    @property
    def n_seeds(self) -> int:
        return int(self.arrivals.shape[0])

    @property
    def n_queries(self) -> int:
        return int(self.arrivals.shape[1])

    @property
    def horizon(self) -> np.ndarray:
        """Last arrival time per replicate, shape ``[S]``."""
        if self.n_queries == 0:
            return np.zeros(self.n_seeds)
        return self.arrivals[:, -1]

    def stream(self, i: int) -> Stream:
        """Materialize replicate ``i`` as a legacy :class:`Stream` (for the
        heapq reference path / equivalence tests)."""
        queries = tuple(
            Query(qid=j, task=int(self.types[i, j]),
                  arrival=float(self.arrivals[i, j]),
                  prompt_len=int(self.prompt_lens[i, j]),
                  correct_u=float(self.correct_us[i, j]))
            for j in range(self.n_queries)
        )
        horizon = float(self.arrivals[i, -1]) if self.n_queries else 0.0
        return Stream(queries=queries, lam=self.lam, horizon=horizon)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One stationary piece of a piecewise-stationary workload."""

    n_queries: int
    lam: float
    pi: tuple | None = None    # mixture override; None = tasks.pi


@dataclasses.dataclass(frozen=True)
class DriftTrace:
    """A single flat query trace with piecewise-stationary (lam, pi).

    The replay harness (``serving.replay``) consumes this: the estimators
    never see ``segments`` / ``segment_ids`` — those exist only so tests
    and benchmarks can score tracking against the ground-truth schedule.
    A one-segment trace is an ordinary stationary Poisson stream.
    """

    arrivals: np.ndarray      # [n] float64, absolute arrival times
    types: np.ndarray         # [n] int, task-type index k
    prompt_lens: np.ndarray   # [n] int
    correct_us: np.ndarray    # [n] float64
    segment_ids: np.ndarray   # [n] int, which Segment each query came from
    segments: tuple           # of Segment (ground truth, not estimator input)
    seed: int

    @property
    def n(self) -> int:
        return int(self.arrivals.shape[0])

    def __len__(self) -> int:
        return self.n

    @property
    def horizon(self) -> float:
        return float(self.arrivals[-1]) if self.n else 0.0

    def to_stream(self) -> Stream:
        """Materialize as a legacy :class:`Stream` (serving-engine input)."""
        queries = tuple(
            Query(qid=j, task=int(self.types[j]),
                  arrival=float(self.arrivals[j]),
                  prompt_len=int(self.prompt_lens[j]),
                  correct_u=float(self.correct_us[j]))
            for j in range(self.n)
        )
        return Stream(queries=queries, lam=self.segments[0].lam,
                      horizon=self.horizon)


def generate_drift_trace(tasks: TaskSet, segments, seed: int = 0,
                         prompt_len_range=(16, 128)) -> DriftTrace:
    """Piecewise-stationary workload: each :class:`Segment` draws its gaps
    at its own lambda and its types from its own pi, arrivals continuing
    cumulatively across segment boundaries (the stream never resets)."""
    segments = tuple(segments)
    if not segments:
        raise ValueError("need at least one segment")
    rng = np.random.default_rng(seed)
    arr, typ, pl, us, sid = [], [], [], [], []
    t = 0.0
    for s_idx, seg in enumerate(segments):
        if seg.n_queries <= 0 or seg.lam <= 0:
            raise ValueError("segments need n_queries > 0 and lam > 0")
        gaps = rng.exponential(1.0 / seg.lam, size=seg.n_queries)
        a = t + np.cumsum(gaps)
        t = float(a[-1])
        pi = np.asarray(tasks.pi if seg.pi is None else seg.pi,
                        dtype=np.float64)
        # a mis-sized mixture override would otherwise surface as an
        # opaque rng.choice error (or a scalar would silently broadcast)
        if pi.shape != (tasks.n_tasks,):
            raise ValueError(
                f"segment {s_idx}: pi override has shape {pi.shape}, "
                f"expected ({tasks.n_tasks},) — one weight per task type")
        if not np.all(np.isfinite(pi)) or np.any(pi < 0) or pi.sum() <= 0:
            raise ValueError(
                f"segment {s_idx}: pi override must be finite, "
                "non-negative, and sum to a positive value")
        pi = pi / pi.sum()
        arr.append(a)
        typ.append(rng.choice(tasks.n_tasks, size=seg.n_queries, p=pi))
        pl.append(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1,
                               size=seg.n_queries))
        us.append(rng.uniform(size=seg.n_queries))
        sid.append(np.full(seg.n_queries, s_idx, dtype=np.int64))
    return DriftTrace(
        arrivals=np.concatenate(arr), types=np.concatenate(typ),
        prompt_lens=np.concatenate(pl), correct_us=np.concatenate(us),
        segment_ids=np.concatenate(sid), segments=segments, seed=seed)


def trace_from_stream_batch(batch: StreamBatch, i: int) -> DriftTrace:
    """Replicate ``i`` of a :class:`StreamBatch` as a one-segment
    :class:`DriftTrace` — the common-random-numbers bridge between the
    batched DES and the replay harness (identical arrivals/types/uniforms
    feed both, so their FIFO waits must agree to float round-off)."""
    seg = Segment(n_queries=batch.n_queries, lam=batch.lam)
    return DriftTrace(
        arrivals=np.array(batch.arrivals[i], dtype=np.float64),
        types=np.array(batch.types[i], dtype=np.int64),
        prompt_lens=np.array(batch.prompt_lens[i], dtype=np.int64),
        correct_us=np.array(batch.correct_us[i], dtype=np.float64),
        segment_ids=np.zeros(batch.n_queries, dtype=np.int64),
        segments=(seg,), seed=batch.seed)


def generate_streams(tasks: TaskSet, lam: float, n_seeds: int,
                     n_queries: int, seed: int = 0,
                     prompt_len_range=(16, 128)) -> StreamBatch:
    """``n_seeds`` independent replicates of the Sec IV workload, one RNG.

    All ``[n_seeds, n_queries]`` blocks are drawn in a single pass from one
    ``default_rng(seed)``, in the same field order as :func:`generate_stream`
    (gaps, types, prompt lengths, correctness uniforms), so the batch is a
    pure function of ``(seed, lam, shapes)``.
    """
    rng = np.random.default_rng(seed)
    shape = (n_seeds, n_queries)
    gaps = rng.exponential(1.0 / lam, size=shape)
    arrivals = np.cumsum(gaps, axis=1)
    types = rng.choice(tasks.n_tasks, size=shape, p=np.asarray(tasks.pi))
    plens = rng.integers(prompt_len_range[0], prompt_len_range[1] + 1,
                         size=shape)
    us = rng.uniform(size=shape)
    return StreamBatch(arrivals=arrivals, types=types, prompt_lens=plens,
                       correct_us=us, lam=lam, seed=seed)

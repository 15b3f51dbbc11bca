"""Workload generation: Poisson arrivals over heterogeneous task types.

Mirrors the paper's Section IV setup: a stream of queries arrives as a
Poisson process with rate lambda; each query is type k w.p. pi_k,
independently. The same stream drives the analytical prediction (service
time = t_k(l_k)) and the serving engine (service = prefill + decode of l_k
tokens).

This is a copy of ``repro.queueing_sim.workload.generate_stream``: it draws
from numpy's ``default_rng`` in the same order, so one seed gives the same
stream in both packages.
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

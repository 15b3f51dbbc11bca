"""The one traffic generator: a mix file's parameters and a seed -> requests.

A mix (``mixes/<name>.json``) states the task types (the paper's Table I
rows: accuracy curve ``A, b, D``, service line ``t0, c``, prior ``pi``),
the operating point whose allocation problem stamps the budgets
(``lam``, ``alpha``, ``l_max``), the prompt-length law and the answer
tokens after reasoning. A cell (``cells/<name>.json``) gives the arrival
mode and rate.

Every seed gets the same request sizes and inter-arrival gaps, in another
order only inside short blocks, so two seeds differ in fine order and in
token ids, never in the amount of work or in its coarse shape over time
(where the bursts and the long prompts fall):

* types: blocks of ``n_types`` consecutive requests hold each type once
  (equal priors only);
* prompt lengths: the law's quantiles at ``(i + 1/2) / n``;
* gaps (``poisson``): the exponential law's quantiles at the same points,
  scaled by ``1 / rate``;
* a base order of lengths and of gaps drawn from the mix's
  ``order.base_seed``, the same for every run; the run's seed then
  shuffles types, lengths and gaps, each on its own, within consecutive
  blocks of ``order.block`` requests.

The arrivals of ``repro_torch.queueing_sim.workload.generate_stream``
(Poisson gaps, types drawn from ``pi``, prompts uniform over 16-128) with
the draws replaced by stratified ones.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    task: int
    prompt: np.ndarray          # int64 token ids
    due: float                  # seconds after the loop's start
    budget: int = -1            # stamped at admission
    max_extra: int = 0
    admit_start: float = math.nan
    # the host-read time of each output token, on the loop's clock
    read_times: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def first_read(self) -> float:
        return self.read_times[0] if self.read_times else math.nan

    @property
    def last_read(self) -> float:
        return self.read_times[-1] if self.read_times else math.nan


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *salt]))


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def prompt_lengths(law: dict, n: int) -> np.ndarray:
    """The law's ``n`` stratified lengths, in increasing order."""
    u = quantiles(n)
    lo, hi = int(law["lo"]), int(law["hi"])
    if law["dist"] == "uniform":
        x = lo + u * (hi - lo + 1)
    elif law["dist"] == "loguniform":
        x = np.exp(np.log(lo) + u * (np.log(hi + 1) - np.log(lo)))
    else:
        raise ValueError(f"unknown prompt law {law['dist']!r}")
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def shuffle_blocks(x: np.ndarray, block: int,
                   rng: np.random.Generator) -> np.ndarray:
    """``x`` with each run of ``block`` consecutive entries permuted."""
    out = x.copy()
    for i in range(0, len(x), block):
        out[i:i + block] = rng.permutation(x[i:i + block])
    return out


def generate(mix: dict, n: int, seed: int, vocab: int, rate=None) -> list:
    """``n`` requests of ``mix`` from ``seed``. ``rate`` (requests/s): due
    times from the exponential gaps, the first at one gap; None: every
    request due at 0 (a backlog)."""
    pis = np.asarray(mix["tasks"]["pi"], dtype=np.float64)
    if not np.allclose(pis, pis[0]):
        raise ValueError("the stratified generator needs equal priors")
    base, block = int(mix["order"]["base_seed"]), int(mix["order"]["block"])
    types = shuffle_blocks(np.arange(n) % len(pis), block, _rng(seed, 1))
    lens = shuffle_blocks(_rng(base, 2).permutation(
        prompt_lengths(mix["prompt_len"], n)), block, _rng(seed, 2))
    if rate is None:
        due = np.zeros(n)
    else:
        gaps = _rng(base, 3).permutation(-np.log1p(-quantiles(n)))
        due = np.cumsum(shuffle_blocks(gaps, block, _rng(seed, 3))
                        / float(rate))
    ids = _rng(seed, 4)
    return [Request(rid=i, task=int(types[i]),
                    prompt=ids.integers(0, vocab, size=int(lens[i]),
                                        dtype=np.int64),
                    due=float(due[i]), max_extra=int(mix["max_extra"]))
            for i in range(n)]

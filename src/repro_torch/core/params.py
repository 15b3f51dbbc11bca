"""Problem parameters for queueing-aware reasoning-token allocation.

Implements the data model of Section II of the paper:

* per-task accuracy curve  p_k(l) = A_k (1 - exp(-b_k l)) + D_k      (eq 2)
* per-task service time    t_k(l) = t0_k + c_k l                     (eq 1)
* arrival process          Poisson(lambda), type priors pi_k
* architectural budget     0 <= l_k <= l_max

All arrays are float64 tensors of shape ``[N]`` on the host, where ``N`` is
the number of task types: the control plane is a handful of scalars, so it
stays on the CPU in double precision whatever device the model runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..compat import CONTROL_DTYPE

Tensor = torch.Tensor


def as_control(x) -> Tensor:
    """Host float64 tensor of ``x`` (the control plane's one number type)."""
    return torch.as_tensor(x, dtype=CONTROL_DTYPE, device="cpu")


@dataclasses.dataclass(frozen=True)
class TaskSet:
    """Calibrated per-task accuracy/latency parameters (eqs 1-2)."""

    names: tuple
    A: Tensor      # accuracy gain amplitude, (0, 1]
    b: Tensor      # accuracy curvature, > 0
    D: Tensor      # zero-token accuracy offset, [0, 1)
    t0: Tensor     # fixed prefill/overhead seconds
    c: Tensor      # per-reasoning-token seconds
    pi: Tensor     # type priors, sum to 1

    def __post_init__(self):
        for f in ("A", "b", "D", "t0", "c", "pi"):
            object.__setattr__(self, f, as_control(getattr(self, f)))
        n = self.A.shape[0]
        for f in ("b", "D", "t0", "c", "pi"):
            if tuple(getattr(self, f).shape) != (n,):
                raise ValueError(f"field {f} must have shape ({n},)")
        if len(self.names) != n:
            raise ValueError("names length mismatch")

    @property
    def n_tasks(self) -> int:
        return int(self.A.shape[0])

    def validate(self) -> None:
        A, D, b, c, pi = self.A, self.D, self.b, self.c, self.pi
        if not bool(torch.all((A > 0) & (A <= 1))):
            raise ValueError("A_k must lie in (0, 1]")
        if not bool(torch.all((D >= 0) & (D < 1))):
            raise ValueError("D_k must lie in [0, 1)")
        if not bool(torch.all(A + D <= 1 + 1e-9)):
            raise ValueError("A_k + D_k must be <= 1")
        if not bool(torch.all(b > 0)):
            raise ValueError("b_k must be > 0")
        if not bool(torch.all(c > 0)):
            raise ValueError("c_k must be > 0")
        if abs(float(pi.sum()) - 1.0) > 1e-8:
            raise ValueError("pi must sum to 1")

    def accuracy(self, lengths: Tensor) -> Tensor:
        """p_k(l_k), eq (2)."""
        return self.A * (1.0 - torch.exp(-self.b * lengths)) + self.D

    def service_time(self, lengths: Tensor) -> Tensor:
        """t_k(l_k), eq (1)."""
        return self.t0 + self.c * lengths


@dataclasses.dataclass(frozen=True)
class ServerParams:
    """Operating point of the M/G/1 LLM server."""

    lam: float            # Poisson arrival rate (queries / second)
    alpha: float          # accuracy weight in J (eq 7)
    l_max: float          # architectural token budget bound

    def validate(self) -> None:
        if self.lam <= 0:
            raise ValueError("lam must be > 0")
        if self.alpha <= 0:
            raise ValueError("alpha must be > 0")
        if self.l_max <= 0:
            raise ValueError("l_max must be > 0")


@dataclasses.dataclass(frozen=True)
class Problem:
    tasks: TaskSet
    server: ServerParams

    def validate(self) -> None:
        self.tasks.validate()
        self.server.validate()
        # stability must at least hold at l = 0 for the problem to be feasible
        es0 = float(torch.sum(self.tasks.pi * self.tasks.t0))
        if self.server.lam * es0 >= 1.0:
            raise ValueError(
                "infeasible: lam * E[S(0)] >= 1 -- queue unstable even with "
                "zero reasoning tokens"
            )


# ---------------------------------------------------------------------------
# The paper's calibration dataset (Table I): Qwen3-8B on six benchmarks,
# lambda = 0.1, alpha = 30, l_max = 32768, uniform mixture pi_k = 1/6.
# ---------------------------------------------------------------------------

PAPER_TASK_NAMES = ("AIME", "GSM8K", "GPQA", "CRUXEval", "BBH", "ARC-Challenge")

_TABLE1 = {
    #  name            A        b          D      t0      c
    "AIME":          (0.6808, 1.59e-4, 0.000, 0.1380, 0.0120),
    "GSM8K":         (0.7230, 3.20e-3, 0.277, 0.1459, 0.0141),
    "GPQA":          (0.3552, 4.41e-4, 0.276, 0.1674, 0.0126),
    "CRUXEval":      (0.4379, 5.63e-4, 0.000, 0.0176, 0.0124),
    "BBH":           (0.7146, 1.75e-3, 0.148, 0.2073, 0.0127),
    "ARC-Challenge": (0.3933, 1.66e-1, 0.490, 0.0581, 0.0119),
}

# Optimal continuous allocation reported in Table I (for validation).
PAPER_TABLE1_LSTAR = (0.0, 340.5, 0.0, 0.0, 345.0, 30.1)


def paper_tasks(names: Sequence[str] = PAPER_TASK_NAMES) -> TaskSet:
    rows = [_TABLE1[n] for n in names]
    A, b, D, t0, c = (as_control(col) for col in zip(*rows))
    pi = torch.full((len(names),), 1.0 / len(names), dtype=CONTROL_DTYPE)
    return TaskSet(names=tuple(names), A=A, b=b, D=D, t0=t0, c=c, pi=pi)


def paper_problem(lam: float = 0.1, alpha: float = 30.0,
                  l_max: float = 32768.0) -> Problem:
    return Problem(tasks=paper_tasks(), server=ServerParams(lam, alpha, l_max))

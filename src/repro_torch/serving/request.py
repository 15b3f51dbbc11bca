"""Typed serving requests and lifecycle records."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class Phase(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclasses.dataclass
class Request:
    rid: int
    task_index: int               # task type k (maps to the allocator)
    prompt: np.ndarray            # int32 prompt tokens
    arrival_t: float
    budget: Optional[int] = None  # reasoning-token budget (set at admission)
    max_extra_tokens: int = 16    # answer tokens after reasoning
    phase: Phase = Phase.QUEUED
    # lifecycle timestamps
    start_t: Optional[float] = None
    finish_t: Optional[float] = None
    generated: int = 0
    output_tokens: list = dataclasses.field(default_factory=list)
    correct_u: float = 0.5        # uniform for Bernoulli accuracy eval

    @property
    def wait_time(self) -> Optional[float]:
        return None if self.start_t is None else self.start_t - self.arrival_t

    @property
    def system_time(self) -> Optional[float]:
        return None if self.finish_t is None else self.finish_t - self.arrival_t


@dataclasses.dataclass
class CompletedRequest:
    rid: int
    task_index: int
    budget: int
    wait_time: float
    service_time: float
    system_time: float
    n_tokens: int
    correct: bool

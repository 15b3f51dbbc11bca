"""Admission queue with allocator-assigned budgets.

The paper's serving discipline: FIFO, one query in service at a time
(M/G/1). At admission the scheduler stamps the request with the current
optimal integer budget for its task type. SJF and priority (highest
accuracy per second first) order the queue through ``discipline_keys``,
as in ``repro.serving.scheduler``; the predicted-size and SRPT variants
are not ported yet and raise ``ValueError``.
"""
from __future__ import annotations

import collections
import heapq
from typing import Optional

import numpy as np

from ..core.allocator import TokenBudgetAllocator
from ..queueing_sim.disciplines import DISCIPLINES, discipline_keys
from .request import Phase, Request


class Scheduler:
    def __init__(self, allocator: TokenBudgetAllocator,
                 discipline: str = "fifo"):
        if discipline not in DISCIPLINES:
            raise ValueError(f"discipline {discipline!r} is not ported "
                             f"(expected one of {DISCIPLINES})")
        self.allocator = allocator
        self.discipline = discipline
        self._fifo: collections.deque = collections.deque()
        self._heap: list = []
        self._seq = 0
        self.n_admitted = 0

    def admit(self, req: Request, now: float, observe: bool = True,
              budget_cap: Optional[int] = None) -> None:
        """Stamp the allocator's budget for the request's task and enqueue.

        ``budget_cap`` (admission control's degradation ladder) bounds the
        stamped budget before any discipline key is computed, so SJF and
        priority ordering see the degraded service time."""
        if observe:
            self.allocator.observe_arrival(req.task_index, now)
        req.budget = self.allocator.budget_for(req.task_index)
        if budget_cap is not None:
            req.budget = int(min(req.budget, budget_cap))
        req.phase = Phase.QUEUED
        self.n_admitted += 1
        if self.discipline == "fifo":
            self._fifo.append(req)
            return
        tasks = self.allocator._base.tasks
        k = req.task_index
        t_service = float(tasks.t0[k] + tasks.c[k] * req.budget)
        if self.discipline == "sjf":
            key = float(discipline_keys("sjf", services=t_service))
        else:  # priority: highest accuracy-per-second first
            p = float(tasks.A[k] * (1 - np.exp(-float(tasks.b[k])
                                               * req.budget)) + tasks.D[k])
            key = float(discipline_keys("priority", services=t_service,
                                        accuracy=p))
        self._seq += 1
        heapq.heappush(self._heap, (key, self._seq, req))

    def reset(self) -> None:
        """Drop any still-queued requests (start of a fresh ``run``)."""
        self._fifo.clear()
        self._heap.clear()
        self._seq = 0

    def next_request(self) -> Optional[Request]:
        if self.discipline == "fifo":
            return self._fifo.popleft() if self._fifo else None
        if self._heap:
            return heapq.heappop(self._heap)[2]
        return None

    def __len__(self) -> int:
        return len(self._fifo) + len(self._heap)

"""LLM server: allocator + scheduler + engine, FIFO M/G/1 semantics.

Two execution modes, as in ``repro.serving.server``:

* ``virtual`` (default) — the service clock advances by the calibrated
  latency model t_k(l_k) while the engine optionally generates REAL
  tokens with strict budget enforcement.
* ``wall`` — the service clock is the wall time of the engine calls.

``batch_size > 1`` serves up to that many queued requests together (batch
service time = slowest member plus an overhead per extra member). The
real-token path takes either engine: a :class:`DecodeEngine` (one
batch-synchronous ``generate``) or a :class:`ContinuousBatchingEngine`
(batched admission and chunked decode of a rolling batch, re-admitting as
slots retire, with the KV occupancy sampled at every chunk into the
report). The tracer, metrics, admission-control and fault hooks are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..core.allocator import TokenBudgetAllocator
from ..core.params import Problem
from ..queueing_sim.workload import Stream
from .continuous import ContinuousBatchingEngine
from .engine import DecodeEngine
from .metrics import ServingReport, occupancy_summary, summarize
from .request import CompletedRequest, Phase, Request
from .scheduler import Scheduler


def timecall(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(result, seconds)`` on the
    monotonic clock."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


@dataclasses.dataclass
class ServerConfig:
    discipline: str = "fifo"
    mode: str = "virtual"          # "virtual" | "wall"
    batch_size: int = 1            # >1 = beyond-paper batched service
    batch_overhead: float = 0.05   # extra service fraction per extra member
    generate_tokens: bool = False  # run the real engine per request
    max_extra_tokens: int = 8
    online_adaptation: bool = True


class LLMServer:
    def __init__(self, problem: Problem,
                 server_cfg: Optional[ServerConfig] = None,
                 engine: Optional[DecodeEngine
                                  | ContinuousBatchingEngine] = None):
        self.problem = problem
        self.cfg = ServerConfig() if server_cfg is None else server_cfg
        if self.cfg.mode not in ("virtual", "wall"):
            raise ValueError(f"unknown mode {self.cfg.mode!r}")
        self.engine = engine
        self.allocator = TokenBudgetAllocator(problem)
        self.scheduler = Scheduler(self.allocator, self.cfg.discipline)
        self.completed: list = []
        # (tokens_in_use, pool_fill) samples from the continuous engine,
        # one per decode chunk; folded into ServingReport.occupancy
        self._occupancy_samples: list = []

    def _service_time(self, reqs) -> float:
        tasks = self.problem.tasks
        times = [float(tasks.t0[r.task_index] + tasks.c[r.task_index]
                       * r.budget) for r in reqs]
        if len(times) == 1:
            return times[0]
        return max(times) * (1.0 + self.cfg.batch_overhead * (len(times) - 1))

    def _run_continuous(self, reqs) -> None:
        """Serve one scheduler batch through the continuous engine: batched
        admission, chunked decode, re-admitting as slots retire until the
        batch drains."""
        eng = self.engine
        pending = list(reqs)
        done = {}
        while pending or eng.n_active:
            if pending:
                flags = eng.admit_many(
                    [(r.rid, r.prompt, r.budget, self.cfg.max_extra_tokens)
                     for r in pending])
                pending = [r for r, ok in zip(pending, flags) if not ok]
            self._occupancy_samples.append((eng.tokens_in_use,
                                            eng.pool_fill))
            for s in eng.step_chunk():
                done[s.rid] = s
        for r in reqs:
            s = done[r.rid]
            r.generated = len(s.tokens)
            r.output_tokens = list(s.tokens)
            # strict enforcement: exactly budget + extra tokens per slot
            # (admission always emits the prefill's first token)
            if r.generated != max(r.budget + self.cfg.max_extra_tokens, 1):
                raise RuntimeError(f"request {r.rid}: budget not enforced")

    def _engine_work(self, reqs) -> None:
        """Run the engine (or the virtual token accounting) for a batch."""
        if self.cfg.generate_tokens and isinstance(self.engine,
                                                   ContinuousBatchingEngine):
            self._run_continuous(reqs)
        elif self.cfg.generate_tokens and self.engine is not None:
            maxlen = max(len(r.prompt) for r in reqs)
            prompts = np.zeros((len(reqs), maxlen), dtype=np.int32)
            for i, r in enumerate(reqs):          # left-padded
                prompts[i, maxlen - len(r.prompt):] = r.prompt
            out = self.engine.generate(
                prompts, [r.budget for r in reqs],
                max_extra_tokens=self.cfg.max_extra_tokens)
            for i, r in enumerate(reqs):
                r.generated = int(out["n_generated"][i])
                r.output_tokens = out["tokens"][i, :r.generated].tolist()
                # strict enforcement check: exactly budget reasoning tokens
                if out["n_reasoning"][i] != min(r.budget, r.generated):
                    raise RuntimeError(f"request {r.rid}: budget not "
                                       "enforced")
        else:
            for r in reqs:
                r.generated = r.budget + self.cfg.max_extra_tokens

    def _execute(self, reqs) -> float:
        """Run the engine (optional) and return the service duration."""
        if self.cfg.mode == "wall":
            _, dur = timecall(self._engine_work, reqs)
            return dur
        self._engine_work(reqs)
        return self._service_time(reqs)

    def run(self, stream: Stream) -> ServingReport:
        """Process the whole stream under the configured discipline.

        Per-run state is reset at entry; the allocator's online estimates
        persist across runs (the online adaptation loop).
        """
        self.completed = []
        self.scheduler.reset()
        self._occupancy_samples = []
        queries = list(stream.queries)
        n = len(queries)
        i = 0
        server_free_at = 0.0
        horizon = 0.0
        pending = self.scheduler
        tasks = self.problem.tasks
        while len(self.completed) < n:
            # admit everything that arrived by the time the server frees
            while i < n and (queries[i].arrival <= server_free_at
                             or len(pending) == 0):
                q = queries[i]
                i += 1
                if q.arrival > server_free_at and len(pending) == 0:
                    server_free_at = q.arrival
                req = Request(rid=q.qid, task_index=q.task,
                              prompt=np.arange(q.prompt_len) % 97 + 1,
                              arrival_t=q.arrival, correct_u=q.correct_u)
                pending.admit(req, q.arrival,
                              observe=self.cfg.online_adaptation)
            batch = []
            while len(batch) < self.cfg.batch_size and len(pending):
                batch.append(pending.next_request())
            if not batch:
                continue
            start = server_free_at
            dur = self._execute(batch)
            finish = start + dur
            server_free_at = finish
            horizon = max(horizon, finish)
            for r in batch:
                r.start_t = start
                r.finish_t = finish
                r.phase = Phase.DONE
                k = r.task_index
                pk = float(tasks.A[k] * (1 - np.exp(-float(tasks.b[k])
                                                    * r.budget)) + tasks.D[k])
                self.completed.append(CompletedRequest(
                    rid=r.rid, task_index=k, budget=int(r.budget),
                    wait_time=r.wait_time, service_time=dur,
                    system_time=r.system_time, n_tokens=int(r.generated),
                    correct=bool(r.correct_u < pk)))
        occ = None
        if self._occupancy_samples:
            occ = occupancy_summary(self._occupancy_samples,
                                    self.engine.pool_tokens)
        return summarize(self.problem, self.completed, horizon,
                         self.allocator.n_resolves,
                         estimator_state=self.allocator.estimator_state(),
                         occupancy=occ)

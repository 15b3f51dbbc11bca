"""LLM server: allocator + scheduler + engine, FIFO M/G/1 semantics.

Two execution modes, as in ``repro.serving.server``:

* ``virtual`` (default) — the service clock advances by the calibrated
  latency model t_k(l_k) while the engine optionally generates REAL
  tokens with strict budget enforcement.
* ``wall`` — the service clock is the wall time of the engine calls
  (``obs.trace.timecall``).

``batch_size > 1`` serves up to that many queued requests together (batch
service time = slowest member plus an overhead per extra member). The
real-token path takes either engine, for every ported family: a
:class:`DecodeEngine` (one batch-synchronous ``generate``) or a
:class:`ContinuousBatchingEngine` (batched admission and chunked decode of
a rolling batch, re-admitting as slots retire, with the KV occupancy
sampled at every chunk into the report; recurrent, hybrid and windowed
rows in slot mode only).

Hooks, each ``None`` by default and guarded by one ``is not None`` check:

* ``admission`` (``serving.admission.AdmissionController``): every
  arrival updates the degradation ladder with the estimated utilisation
  rho (scored at the ladder's level-0 budgets) and the paged pool's fill,
  then is admitted with its budget capped at the level's, or shed: a shed
  request is recorded as a zero-cost ``CompletedRequest`` (no queueing,
  no service, no tokens) and never touches the engine. The report
  carries ``n_shed``, ``shed_fraction`` and ``degradation_occupancy``.
* ``faults`` (``faults.FaultInjector``): straggler multipliers stretch
  each batch's duration (the slowest member's), and a continuous engine
  without faults of its own is handed them for its decode-step hook.
* ``tracer`` (``obs.trace.Tracer``): each completed request's span tree
  on the virtual timeline (request, admit, prefill, decode, retire) and
  the queue depth at each batch start.
* ``metrics`` (``obs.metrics.MetricsRegistry``): the ``server.*``
  counters, gauges and histograms (wait, system time, batch occupancy,
  queue depth, tokens in use, pool fill, sheds).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.allocator import TokenBudgetAllocator
from ..core.params import Problem
from ..obs.trace import VIRTUAL_PID, timecall
from ..queueing_sim.workload import Stream
from .continuous import ContinuousBatchingEngine
from .engine import DecodeEngine
from .metrics import ServingReport, occupancy_summary, summarize
from .request import CompletedRequest, Phase, Request
from .scheduler import Scheduler


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
                                  | ContinuousBatchingEngine] = None,
                 allocator: Optional[TokenBudgetAllocator] = None,
                 tracer=None, metrics=None, admission=None, faults=None):
        self.problem = problem
        self.cfg = ServerConfig() if server_cfg is None else server_cfg
        if self.cfg.mode not in ("virtual", "wall"):
            raise ValueError(f"unknown mode {self.cfg.mode!r}")
        self.engine = engine
        self.allocator = allocator or TokenBudgetAllocator(problem)
        self.scheduler = Scheduler(self.allocator, self.cfg.discipline)
        self.completed: list = []
        self.shed: list = []
        self.admission = admission
        self.faults = faults
        if (faults is not None
                and isinstance(engine, ContinuousBatchingEngine)
                and engine.faults is None):
            engine.faults = faults
        self.tracer = tracer
        self.metrics = metrics
        # (tokens_in_use, pool_fill) samples from the continuous engine,
        # one per decode chunk; folded into ServingReport.occupancy
        self._occupancy_samples: list = []

    def _pool_fill(self) -> float:
        eng = self.engine
        return (float(eng.pool_fill)
                if isinstance(eng, ContinuousBatchingEngine) and eng.paged
                else 0.0)

    def _rho_signal(self) -> float:
        """Estimated utilisation at the ladder's level-0 (undegraded)
        budgets: scored at the current level, rho would drop as soon as the
        ladder engages, read as recovery, and flap the controller."""
        st = self.allocator.estimator_state()
        lam = float(st.get("lam", 0.0))
        if not np.isfinite(lam) or lam <= 0.0:
            return 0.0
        tasks = self.problem.tasks
        pi = np.asarray(st["pi"], dtype=np.float64)
        base = self.admission.ladder()[0]
        return float(lam * np.sum(pi * (tasks.t0.numpy()
                                        + tasks.c.numpy() * base)))

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
            tokens_in_use, fill = eng.tokens_in_use, eng.pool_fill
            self._occupancy_samples.append((tokens_in_use, fill))
            if self.metrics is not None:
                self.metrics.histogram("server.tokens_in_use").record(
                    tokens_in_use)
                self.metrics.gauge("server.pool_fill").set(fill)
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

        Per-run state (completed and shed lists, queued requests) is reset
        at entry; the allocator's online estimates and the admission
        controller's state persist across runs (the online adaptation
        loop).
        """
        self.completed = []
        self.shed = []
        self.scheduler.reset()
        self._occupancy_samples = []
        queries = list(stream.queries)
        n = len(queries)
        i = 0
        server_free_at = 0.0
        horizon = 0.0
        pending = self.scheduler
        tasks = self.problem.tasks
        adm = self.admission
        while len(self.completed) + len(self.shed) < n:
            # admit everything that arrived by the time the server frees
            while i < n and (queries[i].arrival <= server_free_at
                             or len(pending) == 0):
                q = queries[i]
                i += 1
                budget_cap = None
                if adm is not None:
                    adm.update(q.arrival, rho=self._rho_signal(),
                               fill=self._pool_fill())
                    dec = adm.decide(q.task)
                    if not dec.admitted:
                        # typed rejection: no queueing, no service, no
                        # tokens; the request never touches the engine
                        self.shed.append(CompletedRequest(
                            rid=q.qid, task_index=q.task, budget=0,
                            wait_time=0.0, service_time=0.0,
                            system_time=0.0, n_tokens=0, correct=False))
                        if self.metrics is not None:
                            self.metrics.counter("server.shed").inc()
                        continue
                    budget_cap = dec.budget
                if q.arrival > server_free_at and len(pending) == 0:
                    server_free_at = q.arrival
                req = Request(rid=q.qid, task_index=q.task,
                              prompt=np.arange(q.prompt_len) % 97 + 1,
                              arrival_t=q.arrival, correct_u=q.correct_u)
                pending.admit(req, q.arrival,
                              observe=self.cfg.online_adaptation,
                              budget_cap=budget_cap)
            batch = []
            while len(batch) < self.cfg.batch_size and len(pending):
                batch.append(pending.next_request())
            if not batch:
                continue
            start = server_free_at
            dur = self._execute(batch)
            if self.faults is not None:
                # a straggler in a batched decode delays every member: the
                # batch takes its slowest member's multiplier
                dur *= float(np.max(self.faults.service_multipliers(
                    [r.arrival_t for r in batch])))
            finish = start + dur
            server_free_at = finish
            horizon = max(horizon, finish)
            if self.metrics is not None:
                self.metrics.histogram("server.batch_occupancy").record(
                    len(batch))
                self.metrics.gauge("server.queue_depth").set(len(pending))
                self.metrics.counter("server.batches").inc()
            if self.tracer is not None:
                self.tracer.counter("server.queue_depth", ts_s=start,
                                    depth=len(pending))
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
                if self.metrics is not None:
                    self.metrics.histogram("server.wait").record(r.wait_time)
                    self.metrics.histogram("server.system_time").record(
                        r.system_time)
                    self.metrics.counter("server.requests").inc()
                if self.tracer is not None:
                    self._trace_request(r, start, finish, dur)
        occ = None
        if self._occupancy_samples:
            occ = occupancy_summary(self._occupancy_samples,
                                    self.engine.pool_tokens)
        rep = summarize(self.problem, self.completed, horizon,
                        self.allocator.n_resolves,
                        estimator_state=self.allocator.estimator_state(),
                        occupancy=occ)
        if adm is not None:
            rep.n_shed = len(self.shed)
            rep.shed_fraction = len(self.shed) / max(n, 1)
            rep.degradation_occupancy = {
                str(k): v for k, v in adm.snapshot()["occupancy"].items()}
        return rep

    def _trace_request(self, r, start: float, finish: float,
                       dur: float) -> None:
        """Emit one request's virtual-timeline span tree.

        request = [arrival, finish]; children tile it: admit (queueing
        wait), prefill (the latency model's fixed cost t0_k, capped at the
        batch's service time), decode (the remainder), and a retire instant
        at finish: the tree ``obs.trace.validate_request_trees`` asserts
        for every completed request.
        """
        t = self.tracer
        t0_k = float(self.problem.tasks.t0[r.task_index])
        pf = min(t0_k, dur)
        args = {"rid": r.rid}
        t.complete("request", r.arrival_t, finish - r.arrival_t,
                   pid=VIRTUAL_PID, cat="request",
                   args={"rid": r.rid, "task": int(r.task_index),
                         "budget": int(r.budget)})
        t.complete("admit", r.arrival_t, start - r.arrival_t,
                   pid=VIRTUAL_PID, cat="request", args=args)
        t.complete("prefill", start, pf, pid=VIRTUAL_PID, cat="request",
                   args=args)
        t.complete("decode", start + pf, finish - start - pf,
                   pid=VIRTUAL_PID, cat="request", args=args)
        t.instant("retire", finish, pid=VIRTUAL_PID, cat="request",
                  args=args)

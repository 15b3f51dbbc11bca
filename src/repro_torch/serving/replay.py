"""Trace-replay digital twin: the closed allocator<->engine loop.

The port of ``repro.serving.replay``. The solver stack (``core.allocator``,
``sweeps.solve_grid``) maps a *known* operating point (lambda, pi, t0, c)
to optimal token budgets; the serving stack (``serving.server``) executes
budgets against a stream. In production neither lambda nor the latency
curve is known: the controller must learn them from the stream it is
serving. The replay harness runs exactly that loop over a recorded trace:

    trace block  ->  stamp budgets (current solution + exploration jitter)
                 ->  services (virtual latency model | real engine decode)
                 ->  queueing: Lindley FIFO (exact, vectorised, with carry)
                     or any ``queueing_sim`` discipline, including the
                     predicted SPJF/SPRPT keys (``cfg.discipline``)
                 ->  fold observations into ``serving.estimators``
                 ->  re-solve token allocation via ``sweeps.solve_grid``
                 ->  next block

**Zero oracle parameters**: the controller (:class:`Controller`) is
constructed from the offline-calibrated accuracy curves (A, b, D, fit from
benchmark data, paper Table I) and the objective constants (alpha, l_max)
only. It never reads ``problem.server.lam``, ``problem.tasks.pi``,
``problem.tasks.t0`` or ``problem.tasks.c``; those live in the *plant*
(:class:`ReplayHarness`), the physics being controlled. Arrival rate and
mixture come from :class:`~.estimators.RateEstimator` /
:class:`~.estimators.MixtureEstimator`; the latency curve comes from the
:class:`~.estimators.LatencyCalibrator` (WLS of observed service on the
stamped budget), identifiable because a small fraction of budgets is
jittered (exploration).

Two service lanes:

* ``run_virtual``: services from the calibrated latency model
  t_k(l) = t0_k + c_k l. Queueing is exact against the batched DES on
  common random numbers; millions of simulated queries cost a handful of
  NumPy passes.
* ``run_engine``: services are wall-clock times of real decodes through
  :class:`~.engine.DecodeEngine` (on the card, its chunks replay the
  captured decode step and every prefill, decode attention and SwiGLU MLP
  runs in the Hopper kernels), replayed through the same Lindley
  recursion: a digital twin driven by measured latencies.

Where each part runs. The re-solve (``sweeps.solve_grid``) runs in float64
on ``device``: the card by default (``compat.resolve_device``, raising
without one), the host when the caller passes ``device="cpu"``. The
queueing passes stay NumPy on the host, as in the JAX package:
``queueing_sim.batched.lindley_numpy`` for FIFO and
``windowed_start_finish(..., backend="numpy")`` for the other disciplines,
over blocks of a few to a few hundred requests. The card's DES lanes
(``csrc/des_scan.cu``) are not used here: one lane launch per block would
cost more than the block's NumPy pass. The estimators and the drift
monitor are NumPy too, so on the same trace the port stamps, serves and
folds bitwise what the JAX package does, and deploys the same integer
budgets.

Block boundaries are the control cadence: every request in a block is
budgeted by the solution computed at the block's start, mirroring a server
that re-solves on a timer rather than per arrival.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from ..core.params import Problem, TaskSet
from ..core.queueing import mean_system_time, service_moments
from ..obs.monitor import DriftMonitor
from ..obs.trace import VIRTUAL_PID, timecall
from ..queueing_sim.batched import lindley_numpy
from ..queueing_sim.disciplines import (ALL_DISCIPLINES, discipline_keys,
                                        windowed_start_finish)
from ..queueing_sim.workload import DriftTrace
from .estimators import EstimatorState, OnlineEstimators
from .metrics import ServingReport, occupancy_summary, percentile_summary

__all__ = ["ReplayConfig", "Controller", "BlockRecord", "ReplayResult",
           "ReplayHarness"]


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Knobs of the closed replay loop."""

    block_size: int = 256          # requests per control interval
    l_init: int = 64               # uninformed initial budget (all tasks)
    # service order within each block: any queueing_sim discipline.
    # "fifo" is the paper's M/G/1 and stays byte-identical to the plain
    # Lindley pass; the others order each block's admitted work by
    # ``discipline_keys`` with exact busy carry across block boundaries
    # (a ghost job pins the server busy until the previous block's last
    # departure). Like the serving Scheduler, the replay twin never
    # cancels a decoding request, so "srpt"/"sprpt" order by (predicted)
    # total work at admission — non-preemptive within the block.
    discipline: str = "fifo"
    # predicted disciplines ("spjf"/"sprpt"): the LengthPredictor whose
    # noisy keys order the blocks (None = zero-error oracle). Its noise
    # stream is seeded apart from the exploration RNG, so attaching a
    # predictor never changes the budgets a FIFO run would stamp.
    predictor: object = None
    warmup_blocks: int = 1         # blocks before the first re-solve
    resolve_every: int = 1         # re-solve cadence, in blocks
    # re-solve trigger: "cadence" = blind block clock (above);
    # "drift" = one bootstrap resolve after warmup, then only when the
    # obs.monitor predicted-vs-measured drift alarm fires
    resolve_mode: str = "cadence"
    drift_rel_tol: float = 0.25    # mean-wait relative error per strike
    drift_patience: int = 2        # consecutive strikes before firing
    drift_min_samples: int = 64    # waits in window before checks are live
    # estimator memory
    est_mode: str = "ewma"         # "ewma" | "window"
    est_halflife: float = 2048.0   # observations (ewma mode)
    est_window: int = 8192         # observations (window mode)
    # exploration (latency-curve identifiability)
    explore_frac: float = 0.05     # fraction of budgets jittered
    explore_rel: float = 0.25      # jitter spread, relative to the budget
    explore_min_spread: int = 4    # ...but at least this many tokens
    seed: int = 0                  # exploration RNG seed
    # stability guard on the estimated operating point
    rho_cap: float = 0.95          # solve at min(lam_hat, rho_cap/E[S(0)]_hat)
    min_services: int = 32         # observations before trusting estimates


@dataclasses.dataclass(frozen=True)
class BlockRecord:
    """One control interval of the closed loop (for tracking plots/tests)."""

    index: int
    n: int
    t_start: float                 # first arrival in the block
    t_end: float                   # last arrival in the block
    budgets: np.ndarray            # [N] deployed budgets during the block
    resolved: bool                 # did a re-solve happen after this block?
    mean_wait: float
    mean_service: float
    estimator: dict                # EstimatorState.as_dict() after the block
    # predicted-vs-measured drift check after this block
    # (obs.monitor DriftReport.as_dict()); None outside drift mode
    drift: dict | None = None
    # time-averaged reasoning tokens held in service over the block's
    # service window (sum_i l_i (finish_i - start_i) / span): the replay
    # twin's analogue of the engine's tokens-in-use occupancy gauge
    mean_tokens_in_use: float = 0.0
    # admission control (when an AdmissionController is attached):
    # degradation level during the block and typed-shed count
    level: int = 0
    n_shed: int = 0


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """Per-request trajectories plus the control-loop history."""

    arrivals: np.ndarray           # [n]
    types: np.ndarray              # [n]
    budgets: np.ndarray            # [n] stamped (post-jitter) budgets
    services: np.ndarray           # [n] virtual-model or measured seconds
    waits: np.ndarray              # [n]
    system_times: np.ndarray       # [n] wait + service
    correct: np.ndarray            # [n] bool, Bernoulli(p_k(l)) via trace u
    accuracy_prob: np.ndarray      # [n] p_k(l) at the stamped budget
    blocks: tuple                  # of BlockRecord
    final_budgets: np.ndarray      # [N] the last deployed per-task solution
    n_resolves: int
    estimator_state: dict          # final EstimatorState.as_dict()
    mode: str                      # "virtual" | "engine"
    # admission control: per-request served mask (False = typed shed;
    # all-True when no AdmissionController is attached) and the
    # controller's final snapshot (None without admission)
    served: np.ndarray | None = None
    admission: dict | None = None

    @property
    def n(self) -> int:
        return int(self.arrivals.shape[0])

    def served_mask(self) -> np.ndarray:
        return (np.ones(self.n, dtype=bool) if self.served is None
                else self.served)

    def measured(self, warmup_frac: float = 0.2) -> dict:
        """Post-warmup measured operating point (the twin's observation).

        Means are over *served* requests (shed requests have no wait or
        service; they show up in ``shed_frac`` instead).
        """
        i0 = int(self.n * warmup_frac)
        sel = np.zeros(self.n, dtype=bool)
        sel[i0:] = True
        shed_frac = 1.0 - float(self.served_mask()[sel].mean())
        sel &= self.served_mask()
        syst = self.system_times[sel]
        se = float(syst.std(ddof=1) / np.sqrt(max(syst.shape[0], 2)))
        return {
            "n": int(syst.shape[0]),
            "accuracy": float(self.correct[sel].mean()),
            "accuracy_prob": float(self.accuracy_prob[sel].mean()),
            "mean_wait": float(self.waits[sel].mean()),
            "mean_service": float(self.services[sel].mean()),
            "mean_system_time": float(syst.mean()),
            "ci95_system_time": 1.96 * se,
            "shed_frac": shed_frac,
        }

    def goodput(self, deadline: float = np.inf) -> dict:
        """Correct completions per unit time (optionally SLO-deadlined).

        A request counts toward goodput when it was admitted, answered
        correctly, and (with a finite ``deadline``) finished within
        ``deadline`` seconds of arrival — the resilience bench's scoring
        of ladder-vs-naive under overload.
        """
        mask = self.served_mask() & self.correct
        if np.isfinite(deadline):
            mask &= self.system_times <= deadline
        horizon = max(float(self.arrivals[-1]), 1e-12) if self.n else 1e-12
        return {
            "n_good": int(mask.sum()),
            "goodput": float(mask.sum() / horizon),
            "shed_fraction": 1.0 - float(self.served_mask().mean()),
            "deadline": float(deadline),
        }

    def report(self, problem: Problem) -> ServingReport:
        """Summarize as a :class:`ServingReport` (array path; no per-request
        object materialization, so million-query replays stay cheap).
        Wait/service/accuracy statistics are over served requests; shed
        requests appear as ``n_shed`` / ``shed_fraction`` / ``goodput``."""
        srv = self.served_mask()
        if self.n == 0 or not srv.any():
            from .metrics import empty_report
            return empty_report(self.n_resolves, self.estimator_state)
        syst = self.system_times[srv]
        waits = self.waits[srv]
        # last departure (shed requests contribute zero service, so the
        # formula reduces to the pre-admission horizon when all served)
        horizon = max(float(self.arrivals[-1] + self.system_times[-1]
                            - self.waits[-1]), 1e-9)
        per_budget, per_sys = {}, {}
        for k in range(problem.tasks.n_tasks):
            sel = (self.types == k) & srv
            if sel.any():
                per_budget[problem.tasks.names[k]] = \
                    float(self.budgets[sel].mean())
                per_sys[problem.tasks.names[k]] = \
                    float(self.system_times[sel].mean())
        return ServingReport(
            n=self.n,
            mean_wait=float(waits.mean()),
            mean_service=float(self.services[srv].mean()),
            mean_system_time=float(syst.mean()),
            p50_system_time=float(np.percentile(syst, 50)),
            p99_system_time=float(np.percentile(syst, 99)),
            utilization=float(self.services[srv].sum() / horizon),
            accuracy=float(self.correct[srv].mean()),
            mean_accuracy_prob=float(self.accuracy_prob[srv].mean()),
            objective=float(problem.server.alpha
                            * self.accuracy_prob[srv].mean() - syst.mean()),
            per_task_budget=per_budget,
            per_task_system_time=per_sys,
            tokens_generated=int(self.budgets[srv].sum()),
            n_resolves=self.n_resolves,
            estimator_state=self.estimator_state,
            wait_percentiles=percentile_summary(waits),
            system_time_percentiles=percentile_summary(syst),
            goodput=float((srv & self.correct).sum() / horizon),
            n_shed=int(self.n - srv.sum()),
            shed_fraction=1.0 - float(srv.mean()),
            degradation_occupancy=(
                None if self.admission is None
                else {str(k): v for k, v
                      in self.admission["occupancy"].items()}),
            drift=next((b.drift for b in reversed(self.blocks)
                        if b.drift is not None), None),
            # the replay twin serves one request at a time against an
            # unbounded virtual cache, so there is no finite pool to fill:
            # pool_tokens = 0 and fill 0.0 by convention
            occupancy=occupancy_summary(
                [(b.mean_tokens_in_use, 0.0) for b in self.blocks], 0),
        )


class Controller:
    """The learning half of the loop: estimators + cadenced re-solve.

    Constructed from offline-calibrated accuracy curves and objective
    constants ONLY (A, b, D, names, alpha, l_max) — it cannot see the
    plant's lambda / pi / t0 / c even by accident. ``observe`` folds one
    control block of per-request measurements; ``resolve`` re-optimizes
    token budgets at the current estimated operating point through the
    batched grid solver on ``device`` (default the card, raising without
    one; ``"cpu"`` solves on the host). On the card a re-solve is a few
    hundred small launches per fixed-point step, so its cost is set by
    the host's dispatch, not by the arithmetic.
    """

    def __init__(self, names, A, b, D, alpha: float, l_max: float,
                 cfg: ReplayConfig, device=None):
        self.names = tuple(names)
        self.A = np.asarray(A, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.D = np.asarray(D, dtype=np.float64)
        self.alpha = float(alpha)
        self.l_max = float(l_max)
        self.cfg = cfg
        self.n_tasks = self.A.shape[0]
        self.device = resolve_device(device or DEFAULT_DEVICE)
        self.est = OnlineEstimators(self.n_tasks, halflife=cfg.est_halflife,
                                    mode=cfg.est_mode, window=cfg.est_window)
        self.budgets = np.full(self.n_tasks, int(cfg.l_init), dtype=np.int64)
        self.n_resolves = 0
        # optional serving.admission.AdmissionController: when attached
        # (ReplayHarness wires it), every re-solve also re-projects the
        # degradation ladder down the allocator's accuracy-latency curve
        self.admission = None

    @classmethod
    def from_problem(cls, problem: Problem, cfg: ReplayConfig,
                     device=None) -> "Controller":
        """Extract exactly the offline-calibrated fields (and nothing else)."""
        t = problem.tasks
        return cls(t.names, t.A, t.b, t.D, problem.server.alpha,
                   problem.server.l_max, cfg, device=device)

    def observe(self, arrivals, types, budgets, services) -> None:
        self.est.observe_block(arrivals, types, budgets, services)

    def state(self) -> EstimatorState:
        return self.est.state()

    def ready(self) -> bool:
        s = self.est
        return (s.moments.n >= self.cfg.min_services
                and s.rate.lam is not None and s.moments.es is not None)

    def resolve(self) -> bool:
        """Re-solve budgets at the estimated operating point. Returns True
        if a new solution was deployed (False while estimates are unripe or
        the estimated point is degenerate)."""
        if not self.ready():
            return False
        st = self.est.state()
        tasks_hat = TaskSet(names=self.names, A=self.A, b=self.b, D=self.D,
                            t0=st.t0, c=st.c, pi=st.pi)
        try:
            tasks_hat.validate()
        except ValueError:
            return False
        # stability guard: never hand the solver an infeasible cell — cap
        # the arrival-rate estimate below saturation of the ZERO-token
        # budget under the *estimated* latency curve
        es0_hat = float(np.sum(st.pi * st.t0))
        lam = min(st.lam, self.cfg.rho_cap / max(es0_hat, 1e-9))
        if not np.isfinite(lam) or lam <= 0:
            return False
        from ..sweeps.solver_grid import solve_grid
        sol = solve_grid(tasks_hat, lam, self.alpha, self.l_max,
                         device=self.device)
        if not bool(sol.feasible):
            return False
        self.budgets = np.asarray(sol.lengths_int, dtype=np.int64)
        self.n_resolves += 1
        if self.admission is not None:
            # re-project the degradation ladder: one batched solve over
            # the tightened caps (anchored at the fresh solution's
            # largest budget) walks the allocator's own accuracy-latency
            # curve; infeasible cells fall back to clipping the level-0
            # solution at the cap. set_ladder re-enforces monotonicity.
            caps = self.admission.ladder_l_max(float(self.budgets.max()))
            lsol = solve_grid(tasks_hat, lam, self.alpha, caps[1:],
                              device=self.device)
            lower = np.asarray(lsol.lengths_int, dtype=np.int64)
            feas = np.asarray(lsol.feasible, dtype=bool)
            clip = np.minimum(self.budgets[None, :],
                              np.floor(caps[1:]).astype(np.int64)[:, None])
            lower = np.where(feas[:, None], lower, clip)
            self.admission.set_ladder(np.vstack([self.budgets[None, :],
                                                 lower]))
        return True


def _ordered_block(arrivals, services, keys, prev_finish: float):
    """One block under a non-FIFO discipline, with exact busy carry.

    A busy server at the block boundary is represented by a *ghost job*:
    arrival at the block's first arrival, service ``prev_finish -
    arrival``, key ``-inf``. The discipline engine necessarily serves it
    first (it heads the busy period), reproducing a server that only
    frees at ``prev_finish``; its row is dropped from the result. The
    next carry is ``finish.max()`` — under any non-preemptive order the
    last departure is the maximum finish, not the last array entry.
    """
    a, s, kk = arrivals, services, np.asarray(keys, dtype=np.float64)
    ghost = 0
    if prev_finish > a[0]:
        a = np.concatenate([a[:1], a])
        s = np.concatenate([[prev_finish - a[0]], s])
        kk = np.concatenate([[-np.inf], kk])
        ghost = 1
    start, finish, _ = windowed_start_finish(a[None], s[None], kk[None],
                                             backend="numpy")
    start, finish = start[0, ghost:], finish[0, ghost:]
    return start, finish, float(finish.max())


class ReplayHarness:
    """The plant: replays a trace against the controller, virtual or real.

    ``device`` is where the controller re-solves (default the card,
    raising without one; ``"cpu"`` runs the solve on the host); the
    engine lane's decodes run on the device of the engine's parameters.
    """

    def __init__(self, problem: Problem, cfg: Optional[ReplayConfig] = None,
                 engine=None, tracer=None, metrics=None, monitor=None,
                 admission=None, faults=None, device=None):
        self.problem = problem
        self.cfg = cfg or ReplayConfig()
        if self.cfg.discipline not in ALL_DISCIPLINES:
            raise ValueError(f"unknown discipline {self.cfg.discipline!r} "
                             f"(expected one of {ALL_DISCIPLINES})")
        self.engine = engine
        self.controller = Controller.from_problem(problem, self.cfg,
                                                  device=device)
        # overload hardening: admission (serving.admission
        # .AdmissionController) gates each block through the degradation
        # ladder and is re-projected at every controller re-solve; faults
        # (faults.FaultInjector / FaultSet) perturb the replayed
        # physics and the observation stream deterministically
        self.admission = admission
        self.faults = faults
        if admission is not None:
            self.controller.admission = admission
        # predicted block ordering: default to the zero-error oracle so
        # cfg.discipline="spjf"/"sprpt" without a predictor is exactly
        # the known-size SJF / admission-time-SRPT order
        self._pred = self.cfg.predictor
        if self._pred is None and self.cfg.discipline in ("spjf", "sprpt"):
            from ..data.predictor import LengthPredictor
            self._pred = LengthPredictor()
        # observability: tracer (obs.trace.Tracer) emits per-request span
        # trees + re-solve spans; metrics (obs.metrics.MetricsRegistry)
        # folds wait/service/system-time histograms per block. Both are
        # None by default — one `is not None` check per block when off.
        self.tracer = tracer
        self.metrics = metrics
        if monitor is None and self.cfg.resolve_mode == "drift":
            monitor = DriftMonitor(rel_tol=self.cfg.drift_rel_tol,
                                   patience=self.cfg.drift_patience,
                                   min_samples=self.cfg.drift_min_samples)
        self.monitor = monitor

    # ------------------------------------------------------------- internals
    def _stamp_budgets(self, types: np.ndarray,
                       rng: np.random.Generator,
                       fixed_lengths) -> np.ndarray:
        """Per-request budgets: current solution + exploration jitter."""
        base = (np.asarray(fixed_lengths, dtype=np.int64)
                if fixed_lengths is not None else self.controller.budgets)
        l = base[types].astype(np.int64)
        if fixed_lengths is not None or self.cfg.explore_frac <= 0:
            return l
        mask = rng.random(l.shape[0]) < self.cfg.explore_frac
        spread = np.maximum(self.cfg.explore_min_spread,
                            np.round(self.cfg.explore_rel * l)).astype(np.int64)
        jitter = rng.integers(-1, 2, size=l.shape[0]) * spread
        lj = np.clip(l + np.where(mask, jitter, 0), 0,
                     int(self.problem.server.l_max))
        return lj.astype(np.int64)

    def _block_keys(self, types, budgets, services, pred_rng) -> np.ndarray:
        """Discipline keys for one block's admitted requests — the same
        ``discipline_keys`` mapping the DES engines and the Scheduler use
        (srpt/sprpt: non-preemptive admission-time keys, see ReplayConfig).
        """
        d = self.cfg.discipline
        if d in ("sjf", "srpt"):
            return discipline_keys(d, services=services)
        if d in ("spjf", "sprpt"):
            pred = self._pred.predict(services, rng=pred_rng)
            return discipline_keys(d, services=services, predicted=pred)
        t = self.problem.tasks
        p = (np.asarray(t.A)[types]
             * (1 - np.exp(-np.asarray(t.b)[types] * budgets))
             + np.asarray(t.D)[types])
        return discipline_keys("priority", services=services, accuracy=p)

    def _virtual_services(self, types, budgets) -> np.ndarray:
        t0 = np.asarray(self.problem.tasks.t0)
        c = np.asarray(self.problem.tasks.c)
        return t0[types] + c[types] * budgets

    def _engine_services(self, types, budgets, prompt_len: int,
                         max_extra_tokens: int) -> np.ndarray:
        """Wall-clock one real decode per request (B = 1, one prompt
        shape, so every budget replays the one captured decode step)."""
        prompt = (np.arange(prompt_len) % 97 + 1).astype(np.int32)[None, :]
        dev = self.engine.device

        def decode(l):
            res = self.engine.generate(prompt, [l],
                                       max_extra_tokens=max_extra_tokens)
            # generate returns host arrays, but a request with nothing to
            # decode (budget 0, no answer tokens) reads nothing back: the
            # time must cover finished device work, its prefill included
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return res

        out = np.empty(budgets.shape[0])
        for i, l in enumerate(budgets):
            # measured through the shared monotonic timing helper, as in
            # LLMServer's wall mode
            res, out[i] = timecall(decode, int(l))
            assert int(res["n_reasoning"][0]) == min(
                int(l), int(res["n_generated"][0]))
        return out

    def _resolve_traced(self, ctl: Controller, ts_virtual: float) -> bool:
        """Controller re-solve, wall-span traced + marked on the virtual
        timeline when a tracer is attached."""
        if self.tracer is None:
            return ctl.resolve()
        with self.tracer.span("controller.resolve", cat="controller"):
            resolved = ctl.resolve()
        if resolved:
            self.tracer.instant("resolve", ts_s=ts_virtual, tid=1,
                                pid=VIRTUAL_PID, cat="controller",
                                args={"budgets":
                                      [int(v) for v in ctl.budgets]})
        return resolved

    def _trace_block(self, b0: int, a, k, l, s, start, finish) -> None:
        """Emit one control block's per-request span trees.

        Virtual-timeline tree per request (rid = global trace index):
        request = [arrival, finish] with children tiling it — admit
        (queueing wait), prefill (the latency model's fixed cost t0_k,
        capped at the realized service), decode (the remainder) — and a
        retire instant at the finish. ``validate_request_trees`` asserts
        exactly this shape for every completed request.
        """
        t = self.tracer
        t0 = np.asarray(self.problem.tasks.t0)
        pf = np.minimum(t0[k], s)
        for i in range(a.shape[0]):
            rid = b0 + i
            args = {"rid": rid}
            t.complete("request", float(a[i]), float(finish[i] - a[i]),
                       pid=VIRTUAL_PID, cat="request",
                       args={"rid": rid, "task": int(k[i]),
                             "budget": int(l[i])})
            t.complete("admit", float(a[i]), float(start[i] - a[i]),
                       pid=VIRTUAL_PID, cat="request", args=args)
            t.complete("prefill", float(start[i]), float(pf[i]),
                       pid=VIRTUAL_PID, cat="request", args=args)
            t.complete("decode", float(start[i] + pf[i]),
                       float(finish[i] - start[i] - pf[i]),
                       pid=VIRTUAL_PID, cat="request", args=args)
            t.instant("retire", float(finish[i]), pid=VIRTUAL_PID,
                      cat="request", args=args)
        t.counter("replay.tokens_in_flight", ts_s=float(a[-1]),
                  pid=VIRTUAL_PID, tokens=float(np.sum(l)))

    def _accuracy(self, types, budgets, correct_us):
        t = self.problem.tasks
        p = (np.asarray(t.A)[types]
             * (1 - np.exp(-np.asarray(t.b)[types] * budgets))
             + np.asarray(t.D)[types])
        return p, correct_us < p

    def _rho_signal(self, st: EstimatorState) -> float:
        """Overload signal for the admission ladder: estimated rho at the
        *level-0* budgets. Scoring the undegraded allocation keeps the
        signal independent of the current degradation level (the naive
        ``st.rho`` drops as soon as budgets shrink, which would read as
        instant recovery and flap the ladder); falls back to ``st.rho``
        until the latency curve is identified. A task allocated zero
        budget at level 0 contributes only its intercept to the score,
        so its (unidentifiable: constant budget) slope is not required."""
        if self.admission is None:
            return st.rho
        base = self.admission.ladder()[0]
        ident = np.asarray(st.identified) | (np.asarray(base) <= 0)
        if ident.all() and np.isfinite(st.lam):
            es0 = float(np.sum(st.pi * (st.t0 + st.c * base)))
            return float(st.lam * es0)
        return st.rho

    def _run(self, trace: DriftTrace, mode: str, fixed_lengths,
             prompt_len: int, max_extra_tokens: int) -> ReplayResult:
        cfg, ctl, adm = self.cfg, self.controller, self.admission
        if self.faults is not None:
            trace = self.faults.transform_trace(trace)
        n = trace.n
        rng = np.random.default_rng(cfg.seed)
        # prediction noise draws from their own stream: a predicted run
        # stamps exactly the budgets the FIFO run would
        pred_rng = (np.random.default_rng(
            (int(getattr(self._pred, "seed", 0)), int(cfg.seed), 104729))
            if cfg.discipline in ("spjf", "sprpt") else None)
        budgets = np.zeros(n, dtype=np.int64)
        services = np.zeros(n)
        waits = np.zeros(n)
        served = np.ones(n, dtype=bool)
        blocks = []
        prev_finish = 0.0
        adaptive = fixed_lengths is None
        last_level = adm.level if adm is not None else 0
        for b0 in range(0, n, cfg.block_size):
            b1 = min(b0 + cfg.block_size, n)
            idx = slice(b0, b1)
            a = trace.arrivals[idx]
            k = trace.types[idx]
            l = self._stamp_budgets(k, rng, fixed_lengths)
            level = last_level
            admit = np.ones(b1 - b0, dtype=bool)
            if adm is not None and adaptive:
                level = adm.update(float(a[0]),
                                   rho=self._rho_signal(ctl.state()))
                admit, _, _ = adm.decide_batch(k)
                # ladder cap bounds the stamped budgets (exploration
                # jitter included); shed requests carry no budget
                l = np.minimum(l, adm.budgets()[k])
                l[~admit] = 0
            level_changed, last_level = level != last_level, level
            # --- fallible section: compute the block's physics into
            # locals only. An engine failure here propagates with NO
            # harness state mutated (no estimator folds, no Lindley
            # carry, no block record) — the exception-safety contract
            # held by tests/test_torch_replay.py's engine-failure case.
            s = np.zeros(b1 - b0)
            if admit.any():
                ka, la = k[admit], l[admit]
                if mode == "virtual":
                    s[admit] = self._virtual_services(ka, la)
                else:
                    s[admit] = self._engine_services(ka, la, prompt_len,
                                                     max_extra_tokens)
                if self.faults is not None:
                    s[admit] *= self.faults.service_multipliers(a[admit])
                if cfg.discipline == "fifo":
                    # Lindley continuation over the admitted requests:
                    # bumping the first admitted arrival to the previous
                    # block's last departure reproduces the single global
                    # pass exactly (start_i = max(a_i, finish_{i-1}))
                    a_eff = a[admit].copy()
                    a_eff[0] = max(a_eff[0], prev_finish)
                    start_a, finish_a = lindley_numpy(a_eff, s[admit])
                    next_finish = float(finish_a[-1])
                else:
                    keys = self._block_keys(k[admit], l[admit], s[admit],
                                            pred_rng)
                    start_a, finish_a, next_finish = _ordered_block(
                        a[admit], s[admit], keys, prev_finish)
            else:
                start_a = finish_a = np.zeros(0)
                next_finish = prev_finish
            # the observed copy of the services: corruption faults poison
            # what the estimators see, never the physics
            s_obs = s
            drop = None
            if self.faults is not None and admit.any():
                s_obs = s.copy()
                s_obs[admit] = self.faults.corrupt_observations(s[admit])
                drop = np.zeros(b1 - b0, dtype=bool)
                drop[admit] = self.faults.drop_mask(int(admit.sum()))
            # --- commit section: nothing below may fail mid-way (the
            # estimator folds are guarded total functions), so harness
            # state is only ever advanced by fully-served blocks.
            prev_finish = next_finish
            start = np.zeros(b1 - b0)
            finish = np.zeros(b1 - b0)
            start[admit], finish[admit] = start_a, finish_a
            budgets[idx], services[idx] = l, s
            served[idx] = admit
            waits[idx] = np.where(admit, start - a, 0.0)
            # tokens-in-use occupancy over the block's service window: one
            # request in service at a time (M/G/1), holding l_i tokens for
            # its service duration
            if admit.any():
                span = max(float(finish_a[-1] - start_a[0]), 1e-12)
                block_tokens = float(np.sum(l[admit]
                                            * (finish_a - start_a)) / span)
            else:
                block_tokens = 0.0
            if self.metrics is not None:
                self.metrics.histogram("replay.wait").record_many(
                    waits[idx][admit])
                self.metrics.histogram("replay.service").record_many(
                    s[admit])
                self.metrics.histogram("replay.system_time").record_many(
                    (finish - a)[admit])
                self.metrics.histogram("replay.tokens_in_use").record(
                    block_tokens)
                self.metrics.counter("replay.requests").inc(b1 - b0)
                if not admit.all():
                    self.metrics.counter("replay.shed").inc(
                        int((~admit).sum()))
            if self.tracer is not None and admit.all():
                self._trace_block(b0, a, k, l, s, start, finish)
            resolved = False
            drift_rec = None
            if adaptive and admit.any():
                keep = admit if drop is None else (admit & ~drop)
                if keep.any():
                    ctl.observe(a[keep], k[keep], l[keep], s_obs[keep])
                n_done = len(blocks) + 1      # blocks observed so far
                if self.monitor is not None:
                    self.monitor.observe(waits[idx][admit])
                if cfg.resolve_mode == "drift" and self.monitor is not None:
                    rep = self.monitor.check(ctl.state().as_dict())
                    drift_rec = rep.as_dict()
                    # bootstrap: the very first resolve still runs on the
                    # warmup clock (no drift exists against the uninformed
                    # l_init point), after which only the alarm re-solves.
                    # A degradation-ladder transition also forces one: the
                    # wait-drift alarm is blind to a degraded deployment
                    # (small budgets predict their own small waits), so
                    # overload onset/recovery must re-solve explicitly.
                    due = (rep.fired
                           or level_changed
                           or (ctl.n_resolves == 0
                               and n_done > cfg.warmup_blocks))
                else:
                    due = (n_done > cfg.warmup_blocks
                           and (n_done - cfg.warmup_blocks)
                           % cfg.resolve_every == 0)
                if due:
                    resolved = self._resolve_traced(ctl, float(a[-1]))
                    if resolved and self.monitor is not None:
                        self.monitor.note_resolve()
            blocks.append(BlockRecord(
                index=len(blocks), n=b1 - b0,
                t_start=float(a[0]), t_end=float(a[-1]),
                budgets=ctl.budgets.copy() if adaptive
                else np.asarray(fixed_lengths, dtype=np.int64),
                resolved=resolved,
                mean_wait=float(waits[idx][admit].mean())
                if admit.any() else 0.0,
                mean_service=float(s[admit].mean()) if admit.any() else 0.0,
                estimator=ctl.state().as_dict(),
                drift=drift_rec,
                mean_tokens_in_use=block_tokens,
                level=level,
                n_shed=int((~admit).sum())))
        p, correct = self._accuracy(trace.types, budgets, trace.correct_us)
        correct &= served               # a shed request is never "good"
        return ReplayResult(
            arrivals=trace.arrivals.copy(), types=trace.types.copy(),
            budgets=budgets, services=services, waits=waits,
            system_times=waits + services, correct=correct,
            accuracy_prob=p, blocks=tuple(blocks),
            final_budgets=(ctl.budgets.copy() if adaptive
                           else np.asarray(fixed_lengths, dtype=np.int64)),
            n_resolves=ctl.n_resolves,
            estimator_state=ctl.state().as_dict(), mode=mode,
            served=served,
            admission=None if adm is None else adm.snapshot())

    # ------------------------------------------------------------------ API
    def run_virtual(self, trace: DriftTrace,
                    fixed_lengths=None) -> ReplayResult:
        """Closed-loop replay with services from the calibrated latency
        model. ``fixed_lengths`` ([N] budgets) disables adaptation and
        pins the policy — the CRN bridge to the batched DES."""
        if trace.n == 0:
            raise ValueError("empty trace")
        return self._run(trace, "virtual", fixed_lengths, 0, 0)

    def run_engine(self, trace: DriftTrace, prompt_len: int = 8,
                   max_extra_tokens: int = 0,
                   fixed_lengths=None) -> ReplayResult:
        """Closed-loop replay with services measured from real decodes.
        Runs one warm-up decode (kernel builds, the decode step's graph
        capture) before the clock."""
        if self.engine is None:
            raise ValueError("run_engine requires a DecodeEngine")
        if trace.n == 0:
            raise ValueError("empty trace")
        prompt = (np.arange(prompt_len) % 97 + 1).astype(np.int32)[None, :]
        self.engine.generate(prompt, [int(self.cfg.l_init)],
                             max_extra_tokens=max_extra_tokens)
        return self._run(trace, "engine", fixed_lengths, prompt_len,
                         max_extra_tokens)

    def predicted(self, lam: float, lengths=None) -> dict:
        """P-K prediction (eqs 5-6) at the plant's TRUE parameters for the
        deployed budgets — what the twin *should* measure if the loop
        converged and the physics matches the model."""
        from ..core.queueing import mean_wait
        from ..obs.monitor import predicted_wait_quantile
        lengths = self.controller.budgets if lengths is None else lengths
        lengths = np.asarray(lengths, dtype=np.float64)
        t = self.problem.tasks
        m = service_moments(t, torch.as_tensor(lengths), lam)
        acc = float(torch.sum(t.pi * t.accuracy(torch.as_tensor(lengths))))
        w = float(mean_wait(m, lam))
        rho = float(m.rho)
        return {
            "lengths": [int(v) for v in lengths],
            "accuracy": acc,
            "mean_system_time": float(mean_system_time(m, lam)),
            "mean_wait": w,
            # exponential-tail wait quantiles (same approximation the
            # drift monitor scores against) — the predicted side of
            # frontier_comparison's percentile gaps
            "wait_percentiles": {
                f"p{q:g}".replace(".", "_"):
                    predicted_wait_quantile(q, w, rho)
                for q in (50.0, 90.0, 99.0, 99.9)},
            "rho": rho,
            "es": float(m.es),
            "es2": float(m.es2),
        }

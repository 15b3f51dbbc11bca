"""Admission control: a hysteresis-gated budget-degradation ladder.

The port of ``repro.serving.admission`` (NumPy only). The paper's
token-budget knob is also the natural graceful-degradation actuator: when
the queue approaches instability (estimated utilisation rho crossing a
threshold, or the paged KV pool filling up), shrinking per-task budgets
walks down the allocator's own accuracy-latency curve, trading accuracy
for service rate, before any request has to be refused. Only when the
ladder is exhausted are whole task classes shed, lowest weight first,
with typed rejections.

The ladder's contract:

* Level 0 is healthy: the allocator's own solution at the full
  ``l_max``. Level j > 0 caps the budgets at ``anchor * l_max_decay**j``,
  by the built-in monotone clip projection of a fixed base solution, or
  by per-level re-solves installed with ``set_ladder`` (caps from
  ``ladder_l_max``).
* Budgets are non-increasing in level, element-wise (``set_ladder``
  clips with a running minimum), and every budget stays in
  ``[l_min, l_max]``.
* The level moves at most one step per ``update`` call. Ascending
  requires the overload signal to have been continuously hot for
  ``dwell_up`` seconds; descending requires continuously calm for
  ``dwell_down`` seconds, against lower thresholds (``rho_low`` <
  ``rho_high``, ``fill_low`` < ``fill_high``). A signal oscillating
  inside the (low, high) band resets both clocks and holds the level.
* Shedding is a function of level only: at level j the
  ``shed_per_level[j]`` lowest-weight classes receive typed
  :class:`AdmissionDecision` rejections (reason ``"shed-class"``). By
  default nothing is shed until the top level.

The controller is a pure host-side state machine (callers pass ``now``),
deterministic given its input trajectory, so ``LLMServer`` and the parity
tests drive the identical object the JAX package's does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SHED_CLASS = "shed-class"


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Thresholds and dwell times of the degradation state machine.

    ``rho_high``/``fill_high`` — ascend when estimated utilization or
    paged-pool fill reaches either; ``rho_low``/``fill_low`` — descend
    only when *both* signals are at or below these (the hysteresis gap).
    ``dwell_up``/``dwell_down`` — seconds the hot/calm condition must
    hold before a one-level move (ascent is immediate by default,
    recovery deliberately reluctant). ``l_max_decay`` — per-level cap
    tightening factor. ``shed_per_level`` — classes shed at each level
    (length ``n_levels + 1``); default sheds one class at the top level.
    ``class_weights`` — shed order, lowest weight first (ties shed the
    higher task index); default uniform.
    """
    n_levels: int = 3
    rho_high: float = 0.9
    rho_low: float = 0.7
    fill_high: float = 0.92
    fill_low: float = 0.7
    dwell_up: float = 0.0
    dwell_down: float = 5.0
    l_max_decay: float = 0.5
    l_min: int = 0
    shed_per_level: tuple[int, ...] | None = None
    class_weights: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.n_levels < 1:
            raise ValueError("n_levels must be >= 1")
        if not 0.0 < self.rho_low < self.rho_high:
            raise ValueError("need 0 < rho_low < rho_high")
        if not 0.0 < self.fill_low < self.fill_high:
            raise ValueError("need 0 < fill_low < fill_high")
        if not 0.0 < self.l_max_decay < 1.0:
            raise ValueError("l_max_decay must be in (0, 1)")
        if self.dwell_up < 0 or self.dwell_down < 0:
            raise ValueError("dwell times must be >= 0")
        if self.l_min < 0:
            raise ValueError("l_min must be >= 0")
        if (self.shed_per_level is not None
                and len(self.shed_per_level) != self.n_levels + 1):
            raise ValueError("shed_per_level must have n_levels + 1 entries")


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Typed outcome of one admission: admit-with-budget or shed."""
    admitted: bool
    level: int
    budget: int
    reason: str | None = None     # None when admitted


class AdmissionController:
    """Degradation-ladder admission in front of the serving loop.

    Drive it with ``update(now, rho, fill)`` at every control instant
    (``LLMServer`` does so per arrival), then
    route each request through ``decide`` / ``decide_batch``. Budgets
    come from the ladder at the current level; ``set_ladder`` installs
    allocator re-solves (see module docstring for the contract).
    """

    def __init__(self, base_budgets, l_max: float,
                 config: AdmissionConfig | None = None, metrics=None):
        self.cfg = config or AdmissionConfig()
        self.metrics = metrics
        base = np.asarray(base_budgets, dtype=np.int64)
        self.n_tasks = base.shape[0]
        self.l_max = float(l_max)
        self._level = 0
        self._hot_since: float | None = None
        self._calm_since: float | None = None
        self._last_now: float | None = None
        self._level_time = np.zeros(self.cfg.n_levels + 1)
        self.n_admitted = 0
        self.n_shed = 0
        self.n_level_up = 0
        self.n_level_down = 0
        self._shed_mask = self._build_shed_mask()
        self.set_ladder(self._clip_ladder(base))

    # -- ladder construction ------------------------------------------------

    def ladder_l_max(self, anchor: float | None = None) -> np.ndarray:
        """Tightened caps per level, ``j = 0..n_levels`` (level 0 first).

        Level 0 keeps the full ``l_max``; level j > 0 caps at
        ``anchor * l_max_decay**j`` where ``anchor`` defaults to the
        global ``l_max`` but should be the *deployed solution's* largest
        budget — the allocator's optimum usually sits far below the
        global cap, and the ladder must bite near the operating point,
        not at a cap that never binds. Solve the allocation at each of
        these caps to re-project the whole ladder down the allocator's
        accuracy-latency curve, then install the per-level solutions
        with :meth:`set_ladder`.
        """
        a = self.l_max if anchor is None else float(anchor)
        a = min(max(a, float(max(self.cfg.l_min, 1))), self.l_max)
        j = np.arange(self.cfg.n_levels + 1)
        caps = np.maximum(a * self.cfg.l_max_decay ** j,
                          float(max(self.cfg.l_min, 1)))
        caps[0] = self.l_max
        return caps

    def _clip_ladder(self, base: np.ndarray) -> np.ndarray:
        """Built-in projection: clip a fixed base solution to each cap.

        The solver-free fallback (same monotone cap projection the
        allocator's delay-SLO path applies): level j is
        ``min(base, floor(cap_j))``, floored at ``l_min``, with the caps
        anchored at the base solution's largest budget.
        """
        anchor = float(base.max()) if base.size else self.l_max
        caps = np.floor(self.ladder_l_max(anchor)).astype(np.int64)
        return np.minimum(base[None, :], caps[:, None])

    def set_ladder(self, budgets) -> None:
        """Install per-level budgets ``[n_levels + 1, N]`` (level 0 first).

        Enforces the ladder contract: element-wise running minimum down
        the levels (degradation never raises a budget even if a re-solve
        at a tighter cap reallocated tokens across tasks), clipped to
        ``[l_min, l_max]``.
        """
        lad = np.asarray(budgets, dtype=np.int64)
        if lad.shape != (self.cfg.n_levels + 1, self.n_tasks):
            raise ValueError(
                f"ladder shape {lad.shape} != "
                f"{(self.cfg.n_levels + 1, self.n_tasks)}")
        lad = np.minimum.accumulate(lad, axis=0)
        self._ladder = np.clip(lad, self.cfg.l_min, int(self.l_max))

    def _build_shed_mask(self) -> np.ndarray:
        """[n_levels + 1, N] bool: class shed at level? Lowest weight first."""
        shed = self.cfg.shed_per_level
        if shed is None:
            shed = (0,) * self.cfg.n_levels + (1,)
        w = self.cfg.class_weights
        w = np.ones(self.n_tasks) if w is None else np.asarray(w, float)
        if w.shape[0] != self.n_tasks:
            raise ValueError("class_weights length != n_tasks")
        # lowest weight sheds first; ties shed the higher task index
        order = np.lexsort((-np.arange(self.n_tasks), w))
        mask = np.zeros((self.cfg.n_levels + 1, self.n_tasks), dtype=bool)
        for j, k in enumerate(shed):
            mask[j, order[:min(int(k), self.n_tasks)]] = True
        return mask

    # -- state machine ------------------------------------------------------

    @property
    def level(self) -> int:
        return self._level

    def ladder(self) -> np.ndarray:
        """Current ladder ``[n_levels + 1, N]`` (copy)."""
        return self._ladder.copy()

    def budgets(self) -> np.ndarray:
        """Per-task budgets at the current degradation level."""
        return self._ladder[self._level]

    def update(self, now: float, rho: float, fill: float = 0.0) -> int:
        """Advance the hysteresis state machine; returns the new level.

        ``rho`` is the *estimated* utilization (``EstimatorState.rho``;
        non-finite values — estimator not yet identified — are treated
        as calm), ``fill`` the paged-pool occupancy in [0, 1]. Moves at
        most one level; see the module docstring for the dwell/hysteresis
        contract.
        """
        cfg = self.cfg
        if self._last_now is not None and now > self._last_now:
            self._level_time[self._level] += now - self._last_now
        self._last_now = now
        rho = float(rho) if np.isfinite(rho) else 0.0
        fill = float(fill) if np.isfinite(fill) else 0.0
        hot = (rho >= cfg.rho_high) or (fill >= cfg.fill_high)
        calm = (rho <= cfg.rho_low) and (fill <= cfg.fill_low)
        if hot:
            self._calm_since = None
            if self._hot_since is None:
                self._hot_since = now
            if (now - self._hot_since >= cfg.dwell_up
                    and self._level < cfg.n_levels):
                self._level += 1
                self.n_level_up += 1
                self._hot_since = now     # re-arm: one step per dwell
                if self.metrics is not None:
                    self.metrics.counter("admission.level_up").inc()
        elif calm:
            self._hot_since = None
            if self._calm_since is None:
                self._calm_since = now
            if (now - self._calm_since >= cfg.dwell_down
                    and self._level > 0):
                self._level -= 1
                self.n_level_down += 1
                self._calm_since = now    # re-arm: one step per dwell
                if self.metrics is not None:
                    self.metrics.counter("admission.level_down").inc()
        else:
            # inside the hysteresis band: hold the level, reset both clocks
            self._hot_since = None
            self._calm_since = None
        if self.metrics is not None:
            self.metrics.gauge("admission.level").set(float(self._level))
        return self._level

    # -- per-request decisions ----------------------------------------------

    def decide(self, task_index: int) -> AdmissionDecision:
        """Admission decision for one request at the current level."""
        lvl = self._level
        if self._shed_mask[lvl, task_index]:
            self.n_shed += 1
            if self.metrics is not None:
                self.metrics.counter("admission.shed").inc()
            return AdmissionDecision(False, lvl, 0, SHED_CLASS)
        self.n_admitted += 1
        return AdmissionDecision(True, lvl, int(self._ladder[lvl,
                                                             task_index]))

    def decide_batch(self, types) -> tuple[np.ndarray, np.ndarray, int]:
        """Vectorized :meth:`decide` for one block of requests.

        Returns ``(admit_mask, budgets, level)``; budgets of shed
        requests are 0.
        """
        types = np.asarray(types)
        lvl = self._level
        shed = self._shed_mask[lvl][types]
        budgets = np.where(shed, 0, self._ladder[lvl][types])
        self.n_shed += int(shed.sum())
        self.n_admitted += int((~shed).sum())
        if self.metrics is not None and shed.any():
            self.metrics.counter("admission.shed").inc(int(shed.sum()))
        return ~shed, budgets, lvl

    # -- reporting ----------------------------------------------------------

    def occupancy(self) -> dict[int, float]:
        """Time-weighted fraction spent at each level (from ``update``)."""
        total = float(self._level_time.sum())
        if total <= 0.0:
            return {self._level: 1.0}
        return {j: float(t / total)
                for j, t in enumerate(self._level_time) if t > 0.0}

    def snapshot(self) -> dict:
        """Counters + level occupancy for ``ServingReport`` threading."""
        return {
            "level": self._level,
            "n_admitted": self.n_admitted,
            "n_shed": self.n_shed,
            "n_level_up": self.n_level_up,
            "n_level_down": self.n_level_down,
            "occupancy": self.occupancy(),
            "ladder": self._ladder.tolist(),
        }

"""Seeded, deterministic fault injection for chaos testing the stack.

The port of ``repro.faults`` (NumPy only). Every injector draws from its
own ``np.random.default_rng(seed)``, so a fault schedule is a pure
function of ``(seed, call sequence)``, the same schedule the JAX
package's injectors draw from the same seed. Injectors are passive
objects exposing a small set of hooks; each consumer pulls the hooks it
understands:

* ``transform_trace(trace)``: workload-level faults (arrival bursts)
  rewrite a trace (any dataclass with an ``arrivals`` array).
* ``service_multipliers(arrivals)``: straggler decode steps, per-request
  latency multipliers ``LLMServer`` applies to the service times.
* ``corrupt_observations(values)``: estimator-input faults
  (NaN/Inf/zero/negative measurements), applied to an observed copy only.
* ``drop_mask(n)``: dropped completions, observations lost before they
  fold.
* ``on_decode_step(engine)``: engine-level faults, called by
  ``ContinuousBatchingEngine`` at every step/chunk boundary (paged
  block-pool pressure stealing reservations, on the host, between
  replays of the captured decode step).

:class:`FaultSet` composes several injectors by chaining each hook.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class FaultInjector:
    """No-op base: subclasses override the hooks they implement."""

    def transform_trace(self, trace):
        return trace

    def service_multipliers(self, arrivals) -> np.ndarray:
        return np.ones(np.asarray(arrivals).shape[0])

    def corrupt_observations(self, values) -> np.ndarray:
        return np.asarray(values)

    def drop_mask(self, n: int) -> np.ndarray:
        return np.zeros(int(n), dtype=bool)

    def on_decode_step(self, engine) -> None:
        pass


class ArrivalBurst(FaultInjector):
    """Compress inter-arrival gaps by ``factor`` inside ``[t0, t1)``.

    Queries whose (original) arrival falls in the window arrive
    ``factor`` times faster; later queries shift earlier by the time
    saved, so the post-burst rate is unchanged — a transient lambda
    spike, the canonical overload fault. Type/correctness draws are
    untouched (common random numbers against the un-faulted trace).
    """

    def __init__(self, t0: float, t1: float, factor: float):
        if not (t1 > t0 and factor >= 1.0):
            raise ValueError("need t1 > t0 and factor >= 1")
        self.t0, self.t1, self.factor = float(t0), float(t1), float(factor)

    def transform_trace(self, trace):
        a = np.asarray(trace.arrivals, dtype=np.float64)
        gaps = np.diff(a, prepend=0.0)
        in_burst = (a >= self.t0) & (a < self.t1)
        gaps = np.where(in_burst, gaps / self.factor, gaps)
        return dataclasses.replace(trace, arrivals=np.cumsum(gaps))


class StragglerDecode(FaultInjector):
    """Each request straggles with probability ``rate``: service x mult."""

    def __init__(self, rate: float, multiplier: float, seed: int = 0):
        if not (0.0 <= rate <= 1.0 and multiplier >= 1.0):
            raise ValueError("need rate in [0,1] and multiplier >= 1")
        self.rate, self.multiplier = float(rate), float(multiplier)
        self._rng = np.random.default_rng(seed)

    def service_multipliers(self, arrivals) -> np.ndarray:
        n = np.asarray(arrivals).shape[0]
        hit = self._rng.random(n) < self.rate
        return np.where(hit, self.multiplier, 1.0)


class PoolPressure(FaultInjector):
    """Steal ``frac`` of the paged block pool for ``hold_steps`` steps.

    On each decode step while armed, reserves blocks straight from the
    engine's ``BlockAllocator`` (an external tenant / fragmentation
    stand-in), releasing them ``hold_steps`` later. Admission sees a
    shrunken pool; the invariant under test is that back-pressure stays
    back-pressure: no crash, no leak, reservation accounting balanced.
    """

    def __init__(self, frac: float, hold_steps: int = 8,
                 period_steps: int = 32, seed: int = 0):
        if not 0.0 < frac < 1.0:
            raise ValueError("frac must be in (0, 1)")
        self.frac = float(frac)
        self.hold_steps = int(hold_steps)
        self.period_steps = int(period_steps)
        self._rng = np.random.default_rng(seed)
        self._step = 0
        self._held = 0
        self._release_at = -1

    def on_decode_step(self, engine) -> None:
        alloc = getattr(engine, "allocator", None)
        if alloc is None:
            return
        self._step += 1
        if self._held and self._step >= self._release_at:
            alloc.release(self._held)
            self._held = 0
        if (not self._held and self._step % self.period_steps == 0
                and self._rng.random() < 0.5):
            want = int(self.frac * alloc.n_blocks)
            take = min(want, alloc.n_free - alloc.reserved)
            if take > 0 and alloc.can_reserve(take):
                alloc.reserve(take)
                self._held = take
                self._release_at = self._step + self.hold_steps

    def release_all(self, engine) -> None:
        """Return any held reservation (call before final audits)."""
        if self._held:
            engine.allocator.release(self._held)
            self._held = 0


class ObservationCorruption(FaultInjector):
    """Poison a fraction of estimator observations (NaN/Inf/zero/negative).

    ``mode`` picks the poison; applied to the observed copy only.
    """

    POISON = {"nan": np.nan, "inf": np.inf, "zero": 0.0, "negative": -1.0}

    def __init__(self, rate: float, mode: str = "nan", seed: int = 0):
        if mode not in self.POISON:
            raise ValueError(f"mode must be one of {sorted(self.POISON)}")
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        self.rate, self.mode = float(rate), mode
        self._rng = np.random.default_rng(seed)

    def corrupt_observations(self, values) -> np.ndarray:
        v = np.array(values, dtype=np.float64, copy=True)
        hit = self._rng.random(v.shape[0]) < self.rate
        v[hit] = self.POISON[self.mode]
        return v


class DroppedCompletions(FaultInjector):
    """Lose a fraction of completion observations before they fold."""

    def __init__(self, rate: float, seed: int = 0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        self.rate = float(rate)
        self._rng = np.random.default_rng(seed)

    def drop_mask(self, n: int) -> np.ndarray:
        return self._rng.random(int(n)) < self.rate


class FaultSet(FaultInjector):
    """Compose several injectors: hooks chain in construction order."""

    def __init__(self, *injectors: FaultInjector):
        self.injectors = tuple(injectors)

    def transform_trace(self, trace):
        for f in self.injectors:
            trace = f.transform_trace(trace)
        return trace

    def service_multipliers(self, arrivals) -> np.ndarray:
        m = np.ones(np.asarray(arrivals).shape[0])
        for f in self.injectors:
            m = m * f.service_multipliers(arrivals)
        return m

    def corrupt_observations(self, values) -> np.ndarray:
        for f in self.injectors:
            values = f.corrupt_observations(values)
        return values

    def drop_mask(self, n: int) -> np.ndarray:
        mask = np.zeros(int(n), dtype=bool)
        for f in self.injectors:
            mask |= f.drop_mask(n)
        return mask

    def on_decode_step(self, engine) -> None:
        for f in self.injectors:
            f.on_decode_step(engine)

    def release_all(self, engine) -> None:
        for f in self.injectors:
            if isinstance(f, (PoolPressure, FaultSet)):
                f.release_all(engine)

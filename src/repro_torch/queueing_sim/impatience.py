"""M/G/1 + M/G/c queueing with deadlines, reneging, and timeout-retries.

The paper's analysis (and the rest of ``queueing_sim``) lives strictly
inside the stability region rho < 1, where every query waits as long as
it takes. Real clients do not: they renege (abandon the queue when a
deadline passes) or time out and *resubmit* — and resubmission is the
classic metastability mechanism (a retry storm): timed-out work is still
sitting in the server's queue, the server cannot tell the client has
left, so it burns capacity on orphaned attempts while the client's retry
adds fresh load. Above a critical retry pressure the effective arrival
rate fixed point ``lam_eff = lam * E[attempts]`` crosses ``1/E[S]`` and
goodput collapses even though the *offered* load was stable.

Semantics (one model, two regimes via :class:`RetryPolicy`):

* Every customer issues attempt 0 at its arrival. An attempt that has
  not **started service** within ``patience`` seconds of its issue time
  is abandoned by the client; if retries remain, the next attempt is
  issued ``patience + backoff(k)`` after the previous issue, with capped
  exponential backoff ``backoff(k) = min(backoff0 * backoff_factor**k,
  backoff_cap)``. A customer is *served* when some attempt starts within
  its patience window; it is *lost* when all ``max_retries + 1``
  attempts time out.
* ``orphaned_service=False`` (reneging / deadline regime): an abandoned
  attempt vanishes — the server skips it, consuming nothing. This is the
  classic M/G/c+deadline model; abandonment sheds load and *stabilizes*
  any offered rho.
* ``orphaned_service=True`` (retry-storm regime, the default when
  retries are enabled): the server cannot observe abandonment, so a
  timed-out attempt still occupies a server for its full service time
  when its FIFO turn comes. Every attempt — served or orphaned —
  consumes capacity, which is what makes the effective-arrival-rate
  fixed point (``retry_fixed_point`` of the JAX package's
  ``core.queueing``) and its
  instability real.

Three lanes, mg1.py style:

* :func:`impatience_event_loop` — scalar heapq reference; the single
  source of truth for the semantics above.
* :func:`impatience_numpy` — batched event-lattice pass (leading axes =
  streams). Attempt issue times are deterministic given the policy
  (``t_k = a + k * patience + sum backoff``), so the full attempt
  lattice is precomputed, stably sorted by time once, and one
  sequential pass with vectorized cross-stream state replays exactly
  the heapq recursion. Pinned bitwise against the reference.
* :func:`impatience_torch` — the same pass as one CUDA kernel
  (``kernels/des_scan.py``, a thread a stream, per-customer state in
  device memory) in f64; it takes the place of the JAX package's vmapped
  ``lax.scan`` (``impatience_jax``). The attempt lattice and its stable
  sort stay on the host. Pinned to 1e-9.

``patience=inf`` reduces every lane to plain FIFO M/G/c — pinned against
``mg1.event_loop`` / ``event_loop_mgc`` in tests so the new lanes cannot
drift from the established reference.
"""
from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np
import torch

from ..compat import DEFAULT_DEVICE, resolve_device
from ..kernels import des_scan


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client impatience contract: deadline, retry budget, backoff.

    ``patience`` — seconds an attempt may wait for service to *start*
    before the client abandons it (time-to-first-byte deadline).
    ``max_retries`` — attempts issued beyond the first; 0 = pure
    reneging. ``orphaned_service`` — whether abandoned attempts still
    consume server capacity when their FIFO turn comes (see module
    docstring). Deterministic by construction: given a policy, attempt
    issue times are a fixed lattice over the base arrivals.
    """
    patience: float = math.inf
    max_retries: int = 0
    backoff0: float = 0.0
    backoff_factor: float = 2.0
    backoff_cap: float = math.inf
    orphaned_service: bool = True

    def __post_init__(self):
        if not self.patience >= 0.0:
            raise ValueError(f"patience must be >= 0, got {self.patience}")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff0 < 0 or self.backoff_factor < 0:
            raise ValueError("backoff parameters must be >= 0")
        if self.max_retries > 0 and not math.isfinite(self.patience):
            raise ValueError("retries require a finite patience (timeout)")

    def backoff(self, k: int) -> float:
        """Backoff inserted after the k-th timeout (k = 0, 1, ...)."""
        return min(self.backoff0 * self.backoff_factor ** k,
                   self.backoff_cap)

    def attempt_offsets(self) -> np.ndarray:
        """Issue-time offsets of attempts 0..max_retries from arrival.

        ``t_attempt_k = arrival + offsets[k]``; offset 0 is 0, offset
        k+1 = offset k + patience + backoff(k). This determinism is what
        lets the batched lanes precompute the whole attempt lattice.
        """
        off = np.zeros(self.max_retries + 1)
        for k in range(self.max_retries):
            off[k + 1] = off[k] + self.patience + self.backoff(k)
        return off


@dataclasses.dataclass(frozen=True)
class ImpatienceResult:
    """Per-customer outcome arrays; leading axes follow the input batch.

    ``served`` — some attempt started within patience. ``start`` /
    ``finish`` / ``wait`` — of the *serving* attempt (NaN where lost;
    ``wait`` is measured from that attempt's issue time, not first
    arrival). ``n_attempts`` — attempts actually issued (1..K+1).
    """
    served: np.ndarray
    start: np.ndarray
    finish: np.ndarray
    wait: np.ndarray
    n_attempts: np.ndarray

    def n_timeouts(self) -> np.ndarray:
        """Timed-out attempts per customer (orphans when orphaned_service)."""
        return self.n_attempts - self.served.astype(np.int64)


def _validated(arrivals, services) -> tuple[np.ndarray, np.ndarray]:
    a = np.asarray(arrivals, dtype=np.float64)
    s = np.asarray(services, dtype=np.float64)
    if a.shape != s.shape:
        raise ValueError(f"arrivals {a.shape} != services {s.shape}")
    return a, s


def impatience_event_loop(arrivals, services, policy: RetryPolicy,
                          c_servers: int = 1) -> ImpatienceResult:
    """Scalar heapq reference for one stream (1-D arrivals/services).

    Events are (issue time, customer, attempt) triples on a heap; a
    retry is pushed dynamically when an attempt times out. FIFO across
    the merged attempt sequence: each live attempt starts at
    ``max(issue, earliest server-free)`` exactly as ``mg1.event_loop``
    starts queries, so ``patience=inf`` replicates it bitwise.
    """
    a, s = _validated(arrivals, services)
    if a.ndim != 1:
        raise ValueError("the reference loop is scalar: 1-D streams only")
    n = a.size
    tau, kmax = policy.patience, policy.max_retries
    # issue times come from the same precomputed offset table the batched
    # lattice uses, so agreement is bitwise (incremental accumulation
    # would differ by 1 ulp in the retry chain)
    off = policy.attempt_offsets()
    free = [0.0] * int(c_servers)
    heapq.heapify(free)
    heap = [(float(a[i]), i, 0) for i in range(n)]
    heapq.heapify(heap)
    served = np.zeros(n, dtype=bool)
    start = np.full(n, np.nan)
    finish = np.full(n, np.nan)
    wait = np.full(n, np.nan)
    n_att = np.zeros(n, dtype=np.int64)
    while heap:
        t, i, k = heapq.heappop(heap)
        n_att[i] = k + 1
        st = max(t, free[0])
        if st - t <= tau:
            served[i] = True
            start[i] = st
            wait[i] = st - t
            finish[i] = st + s[i]
            heapq.heapreplace(free, finish[i])
            continue
        # timed out: the client abandons this attempt at t + tau
        if policy.orphaned_service:
            # ...but the server cannot tell, and serves the orphan anyway
            heapq.heapreplace(free, st + s[i])
        if k < kmax:
            heapq.heappush(heap, (float(a[i]) + off[k + 1], i, k + 1))
    return ImpatienceResult(served, start, finish, wait, n_att)


def impatience_numpy(arrivals, services, policy: RetryPolicy,
                     c_servers: int = 1) -> ImpatienceResult:
    """Batched event-lattice pass; leading axes are independent streams.

    Replays :func:`impatience_event_loop` with vectorized cross-stream
    state: the deterministic attempt lattice ``[S, n*(K+1)]`` is stably
    argsorted by time (flat order is (customer, attempt), matching the
    heap's tie-break), then one sequential pass over event *positions*
    updates all streams at once. Stale lattice slots (attempt never
    issued: customer already served, or an earlier attempt did not time
    out) are masked dead, which is exactly the set the heap never pushes.
    """
    a, s = _validated(arrivals, services)
    shape = a.shape
    n = shape[-1]
    a2 = a.reshape(-1, n)
    s2 = s.reshape(-1, n)
    ns = a2.shape[0]
    k1 = policy.max_retries + 1
    tau, kmax = policy.patience, policy.max_retries
    lattice = (a2[:, :, None] + policy.attempt_offsets()[None, None, :])
    times = lattice.reshape(ns, n * k1)
    cust = np.repeat(np.arange(n), k1)
    att = np.tile(np.arange(k1), n)
    # stable sort on time keeps flat (customer, attempt) order on ties,
    # matching heapq's (t, i, k) tuple comparison
    order = np.argsort(times, axis=1, kind="stable")
    rs = np.arange(ns)
    free = np.zeros((ns, int(c_servers)))
    served = np.zeros((ns, n), dtype=bool)
    nxt = np.zeros((ns, n), dtype=np.int64)
    n_att = np.zeros((ns, n), dtype=np.int64)
    start = np.full((ns, n), np.nan)
    finish = np.full((ns, n), np.nan)
    wait = np.full((ns, n), np.nan)
    for e in range(n * k1):
        oe = order[:, e]
        t_e = times[rs, oe]
        i_e = cust[oe]
        k_e = att[oe]
        live = (~served[rs, i_e]) & (nxt[rs, i_e] == k_e)
        if not live.any():
            continue
        am = free.argmin(axis=1)
        st = np.maximum(t_e, free[rs, am])
        ok = live & (st - t_e <= tau)
        timeout = live & ~ok
        n_att[rs[live], i_e[live]] = k_e[live] + 1
        if ok.any():
            ss, si = rs[ok], i_e[ok]
            fin = st[ok] + s2[ss, si]
            served[ss, si] = True
            start[ss, si] = st[ok]
            wait[ss, si] = st[ok] - t_e[ok]
            finish[ss, si] = fin
            free[ss, am[ok]] = fin
        if policy.orphaned_service and timeout.any():
            ts, ti = rs[timeout], i_e[timeout]
            free[ts, am[timeout]] = st[timeout] + s2[ts, ti]
        retry = timeout & (k_e < kmax)
        if retry.any():
            nxt[rs[retry], i_e[retry]] += 1
    return ImpatienceResult(
        served.reshape(shape), start.reshape(shape),
        finish.reshape(shape), wait.reshape(shape),
        n_att.reshape(shape))


def _sorted_events(a2: np.ndarray, policy: RetryPolicy) -> tuple:
    """The attempt lattice of ``[S, n]`` streams, stably sorted by time:
    ``(t_ev, i_ev, k_ev)``, each ``[S, n * (K + 1)]`` (flat order is
    (customer, attempt), matching the heap's tie-break)."""
    ns, n = a2.shape
    k1 = policy.max_retries + 1
    lattice = (a2[:, :, None] + policy.attempt_offsets()[None, None, :])
    times = lattice.reshape(ns, n * k1)
    cust = np.repeat(np.arange(n), k1)
    att = np.tile(np.arange(k1), n)
    order = np.argsort(times, axis=1, kind="stable")
    rs = np.arange(ns)[:, None]
    return times[rs, order], cust[order], att[order]


def impatience_torch(arrivals, services, policy: RetryPolicy,
                     c_servers: int = 1, device=None) -> ImpatienceResult:
    """Torch lane: the numpy pass as one CUDA kernel over streams (f64).

    The attempt lattice and its stable sort are prepared host-side
    (identically to :func:`impatience_numpy`), then one thread per stream
    walks its events on the card (at most ``kernels.des_scan.MAX_C``
    servers). Same arithmetic (max, add), so agreement with the reference
    is to float-op noise (pinned at 1e-9 in tests). ``device`` defaults to
    the card (raising without one); ``device="cpu"`` runs the kernel's
    plain version.
    """
    a, s = _validated(arrivals, services)
    shape = a.shape
    n = shape[-1]
    a2 = np.ascontiguousarray(a.reshape(-1, n))
    s2 = np.ascontiguousarray(s.reshape(-1, n))
    t_ev, i_ev, k_ev = _sorted_events(a2, policy)
    dev = resolve_device(device or DEFAULT_DEVICE)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = des_scan.impatience_pass(
        put(t_ev), put(i_ev.astype(np.int64)), put(k_ev.astype(np.int64)),
        put(s2), float(policy.patience), int(policy.max_retries),
        int(c_servers), bool(policy.orphaned_service))
    served, n_att, start, finish, wait = (x.cpu().numpy().reshape(shape)
                                          for x in out)
    return ImpatienceResult(served, start, finish, wait, n_att)


def summarize_impatience(res: ImpatienceResult, arrivals, services,
                         policy: RetryPolicy,
                         horizon: float | None = None,
                         c_servers: int = 1) -> dict:
    """Reduce a (possibly batched) result to goodput/loss/retry scalars.

    ``goodput`` is served customers per unit time over ``horizon``
    (default: last arrival); ``lam_eff`` is the *empirical*
    effective arrival rate — total attempts issued per unit time — the
    measured counterpart of
    :func:`~repro_torch.core.queueing.retry_fixed_point`.
    ``rho_eff`` is the offered effective load per server (service demand
    of every attempt, orphans included when the policy orphans them,
    per unit time): above 1 the queue is in the metastable overload
    regime and the backlog diverges over the horizon.
    """
    a, s = _validated(arrivals, services)
    if horizon is None:
        horizon = float(a.max()) if a.size else 0.0
    horizon = max(float(horizon), 1e-12)
    n_streams = max(a.size // a.shape[-1], 1) if a.ndim > 1 else 1
    per_stream_t = horizon * n_streams
    n_served = int(res.served.sum())
    n_total = int(res.served.size)
    n_attempts = int(res.n_attempts.sum())
    n_timeouts = int(res.n_timeouts().sum())
    busy = float(np.where(res.served, s, 0.0).sum())
    if policy.orphaned_service:
        busy += float((res.n_timeouts() * s).sum())
    waits = res.wait[res.served]
    return {
        "n": n_total,
        "n_served": n_served,
        "served_frac": n_served / max(n_total, 1),
        "loss_frac": 1.0 - n_served / max(n_total, 1),
        "goodput": n_served / per_stream_t,
        "lam_eff": n_attempts / per_stream_t,
        "timeout_frac": n_timeouts / max(n_attempts, 1),
        "mean_wait_served": float(waits.mean()) if waits.size else 0.0,
        "rho_eff": busy / (per_stream_t * c_servers),
    }

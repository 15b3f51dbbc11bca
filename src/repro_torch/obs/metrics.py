"""Counters, gauges, and log-bucketed streaming histograms.

The port of ``repro.obs.metrics`` (NumPy only, no torch): the percentile
substrate of the server's observability. A :class:`StreamingHistogram`
buckets positive float64 values by truncating the IEEE-754 bit pattern,
bucket index = ``bits(v) >> (52 - bits)``, which yields geometric buckets
of at most ``1 + 2**-bits`` relative width (default ``bits=5``: 32
sub-buckets per octave, bucket width <= 3.125%) with no transcendental
math on the hot path: one bit shift and one ``bincount`` per batch. Since
the positive-float bit pattern is monotone, bucketing is exact.

Error bound: for any ``q``, :meth:`HistogramSnapshot.percentile` returns
a value in the same bucket as the exact order statistic
``np.percentile(x, q, method="inverted_cdf")``, clipped to the observed
``[min, max]``; the relative error is therefore ``< 2**-bits``, and a
constant stream is reproduced exactly. Non-positive observations (the
wait distribution's atom at zero) are counted exactly in a dedicated zero
bucket and reported as 0.0.

Snapshots are mergeable: :meth:`HistogramSnapshot.merge` is associative
and commutative (bucket counts add), so per-lane histograms fold into one
distribution bit-identically to single-stream recording.

Disabled-path cost: producers hold ``metrics=None`` by default and guard
recording sites with one ``is not None`` check; :class:`NullRegistry` /
:class:`NullHistogram` make unconditional call sites no-ops.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StreamingHistogram", "HistogramSnapshot", "merge_snapshots",
           "histogram_per_lane", "Counter", "Gauge", "MetricsRegistry",
           "NullRegistry", "NULL_REGISTRY", "DEFAULT_PERCENTILES"]

DEFAULT_PERCENTILES = (50.0, 90.0, 99.0, 99.9)


def _bucket_low(idx: int, bits: int) -> float:
    """Lower edge of bucket ``idx``: the smallest float64 in the bucket."""
    return float(np.int64(idx << (52 - bits)).view(np.float64))


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """Frozen, mergeable histogram state.

    ``counts`` maps bucket index -> count for positive observations;
    ``zeros`` counts non-positive observations exactly (reported as 0.0).
    """

    bits: int
    counts: tuple                 # ((bucket_index, count), ...) sorted
    n: int                        # total observations (incl. zeros)
    zeros: int                    # non-positive observations
    total: float                  # sum of positive observations
    vmin: float                   # smallest positive observation (inf if none)
    vmax: float                   # largest positive observation (-inf if none)

    # ------------------------------------------------------------ reductions
    @property
    def mean(self) -> float:
        """Exact mean (non-positive observations contribute 0.0)."""
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> float:
        """Approximate ``q``-th percentile, ``q`` in [0, 100].

        Inverted-CDF semantics: locates the bucket holding the
        ``ceil(q/100 * n)``-th order statistic and returns the bucket's
        geometric midpoint clipped to the observed [min, max] — relative
        error < ``2**-bits`` vs the exact order statistic. Zero
        observations -> 0.0 (the empty-stream contract shared with
        ``mg1.empty_result``: statistics over nothing are zeros, never an
        error).
        """
        if self.n == 0:
            return 0.0
        k = max(1, int(np.ceil(q / 100.0 * self.n)))
        cum = self.zeros
        if k <= cum:
            return 0.0
        for idx, cnt in self.counts:
            cum += cnt
            if cum >= k:
                lo = _bucket_low(idx, self.bits)
                hi = _bucket_low(idx + 1, self.bits)
                rep = float(np.sqrt(lo * hi))
                return float(min(max(rep, self.vmin), self.vmax))
        return float(self.vmax)

    def percentiles(self, qs=DEFAULT_PERCENTILES) -> dict:
        """``{"p50": ..., "p90": ...}`` for the requested percentiles."""
        return {f"p{q:g}".replace(".", "_"): self.percentile(q)
                for q in qs}

    # --------------------------------------------------------------- merging
    def merge(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        """Associative, commutative fold of two snapshots (counts add)."""
        if self.bits != other.bits:
            raise ValueError(
                f"cannot merge histograms with bits {self.bits} != "
                f"{other.bits}")
        counts = dict(self.counts)
        for idx, cnt in other.counts:
            counts[idx] = counts.get(idx, 0) + cnt
        return HistogramSnapshot(
            bits=self.bits,
            counts=tuple(sorted(counts.items())),
            n=self.n + other.n,
            zeros=self.zeros + other.zeros,
            total=self.total + other.total,
            vmin=min(self.vmin, other.vmin),
            vmax=max(self.vmax, other.vmax),
        )

    def as_dict(self, qs=DEFAULT_PERCENTILES) -> dict:
        """JSON-able summary (count, mean, min/max, percentiles)."""
        d = {"n": self.n, "zeros": self.zeros, "mean": self.mean,
             "min": 0.0 if self.zeros else
             (self.vmin if self.n else 0.0),
             "max": self.vmax if np.isfinite(self.vmax) else 0.0}
        d.update(self.percentiles(qs))
        return d


def merge_snapshots(snapshots) -> HistogramSnapshot:
    """Fold an iterable of snapshots; raises on an empty iterable."""
    snapshots = list(snapshots)
    if not snapshots:
        raise ValueError("merge_snapshots needs at least one snapshot")
    out = snapshots[0]
    for s in snapshots[1:]:
        out = out.merge(s)
    return out


class StreamingHistogram:
    """Mutable log-bucketed histogram (see module docs for the bound)."""

    __slots__ = ("bits", "_shift", "_lo", "_arr", "_n", "_zeros", "_total",
                 "_vmin", "_vmax")

    def __init__(self, bits: int = 5):
        if not 0 <= int(bits) <= 12:
            raise ValueError("bits must be in [0, 12]")
        self.bits = int(bits)
        self._shift = 52 - self.bits
        # dense count window over the observed bucket-index range, grown
        # lazily (HdrHistogram-style): batch absorption is one vectorized
        # slice add, no per-bucket Python loop. Memory is 8 bytes per
        # bucket spanned by the data — latency values spanning 12 orders
        # of magnitude at bits=5 cost ~10 KB.
        self._lo = 0
        self._arr = np.zeros(0, dtype=np.int64)
        self._n = 0
        self._zeros = 0
        self._total = 0.0
        self._vmin = np.inf
        self._vmax = -np.inf

    @property
    def n(self) -> int:
        return self._n

    def _ensure(self, lo: int, hi: int) -> None:
        """Grow the dense window to cover bucket indices [lo, hi]."""
        if self._arr.size == 0:
            self._lo = lo
            self._arr = np.zeros(hi - lo + 1, dtype=np.int64)
            return
        cur_hi = self._lo + self._arr.size - 1
        if lo >= self._lo and hi <= cur_hi:
            return
        new_lo = min(lo, self._lo)
        arr = np.zeros(max(hi, cur_hi) - new_lo + 1, dtype=np.int64)
        off = self._lo - new_lo
        arr[off:off + self._arr.size] = self._arr
        self._lo, self._arr = new_lo, arr

    def record(self, value: float) -> None:
        """Record one observation (scalar fast path of ``record_many``)."""
        self._n += 1
        v = float(value)
        if v <= 0.0:
            self._zeros += 1
            return
        self._total += v
        if v < self._vmin:
            self._vmin = v
        if v > self._vmax:
            self._vmax = v
        idx = int(np.int64(np.float64(v).view(np.int64)) >> self._shift)
        self._ensure(idx, idx)
        self._arr[idx - self._lo] += 1

    def record_many(self, values) -> None:
        """Record a whole array in a few vectorized integer passes.

        Accepts any shape (ravelled); non-positive entries land in the
        zero bucket. NaNs count as zeros; infs are rejected.
        """
        v = np.ascontiguousarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        if np.isinf(v).any():
            raise ValueError("cannot record infinite values")
        self._n += v.size
        pos = v > 0.0
        vp = v[pos] if not pos.all() else v
        self._zeros += v.size - vp.size
        if vp.size == 0:
            return
        self._total += float(vp.sum())
        self._vmin = min(self._vmin, float(vp.min()))
        self._vmax = max(self._vmax, float(vp.max()))
        idx = np.ascontiguousarray(vp).view(np.int64) >> self._shift
        lo = int(idx.min())
        counts = np.bincount(idx - lo)
        self._ensure(lo, lo + counts.size - 1)
        off = lo - self._lo
        self._arr[off:off + counts.size] += counts

    def merge_from(self, snap: HistogramSnapshot) -> None:
        """Absorb a snapshot (e.g. one per-seed lane) into this histogram."""
        if snap.bits != self.bits:
            raise ValueError(
                f"cannot merge snapshot with bits {snap.bits} != {self.bits}")
        if snap.counts:
            idx = np.fromiter((i for i, _ in snap.counts), dtype=np.int64,
                              count=len(snap.counts))
            cnt = np.fromiter((c for _, c in snap.counts), dtype=np.int64,
                              count=len(snap.counts))
            self._ensure(int(idx.min()), int(idx.max()))
            np.add.at(self._arr, idx - self._lo, cnt)
        self._n += snap.n
        self._zeros += snap.zeros
        self._total += snap.total
        self._vmin = min(self._vmin, snap.vmin)
        self._vmax = max(self._vmax, snap.vmax)

    def snapshot(self) -> HistogramSnapshot:
        nz = np.nonzero(self._arr)[0]
        counts = tuple(zip((nz + self._lo).tolist(), self._arr[nz].tolist()))
        return HistogramSnapshot(
            bits=self.bits, counts=counts,
            n=self._n, zeros=self._zeros, total=self._total,
            vmin=self._vmin, vmax=self._vmax)

    # convenience pass-throughs
    def percentile(self, q: float) -> float:
        return self.snapshot().percentile(q)

    def percentiles(self, qs=DEFAULT_PERCENTILES) -> dict:
        return self.snapshot().percentiles(qs)

    @property
    def mean(self) -> float:
        return self._total / self._n if self._n else 0.0


def histogram_per_lane(values, axis: int, bits: int = 5) -> list:
    """Per-lane snapshots along ``axis`` (e.g. one histogram per seed).

    The mergeable-snapshot entry point for batched-DES lanes: fold each
    lane independently, then ``merge_snapshots`` the list — bit-identical
    to recording the whole array at once (associativity is pinned in
    tests).
    """
    v = np.asarray(values, dtype=np.float64)
    v = np.moveaxis(v, axis, 0)
    out = []
    for lane in v:
        h = StreamingHistogram(bits=bits)
        h.record_many(lane)
        out.append(h.snapshot())
    return out


# --------------------------------------------------------------------------
# Counters, gauges, registry
# --------------------------------------------------------------------------

class Counter:
    """Monotone event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value gauge."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class MetricsRegistry:
    """Named counters/gauges/histograms with a mergeable snapshot.

    ``snapshot()`` returns ``{name: value | HistogramSnapshot}``;
    ``as_dict()`` the JSON-able version with percentile summaries.
    """

    enabled = True

    def __init__(self):
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, bits: int = 5) -> StreamingHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = StreamingHistogram(bits=bits)
        return h

    def snapshot(self) -> dict:
        out: dict = {k: c.value for k, c in self._counters.items()}
        out.update({k: g.value for k, g in self._gauges.items()})
        out.update({k: h.snapshot() for k, h in self._hists.items()})
        return out

    def as_dict(self, qs=DEFAULT_PERCENTILES) -> dict:
        return {k: (v.as_dict(qs) if isinstance(v, HistogramSnapshot)
                    else v)
                for k, v in self.snapshot().items()}


class _NullCounter(Counter):
    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge(Gauge):
    def set(self, v: float) -> None:
        pass


class NullHistogram(StreamingHistogram):
    """No-op histogram for unconditional call sites."""

    def record(self, value) -> None:
        pass

    def record_many(self, values) -> None:
        pass

    def merge_from(self, snap) -> None:
        pass


class NullRegistry(MetricsRegistry):
    """No-op registry: accessors return shared no-op instruments."""

    enabled = False

    def __init__(self):
        super().__init__()
        self._c = _NullCounter()
        self._g = _NullGauge()
        self._h = NullHistogram()

    def counter(self, name: str) -> Counter:
        return self._c

    def gauge(self, name: str) -> Gauge:
        return self._g

    def histogram(self, name: str, bits: int = 5) -> StreamingHistogram:
        return self._h

    def snapshot(self) -> dict:
        return {}


NULL_REGISTRY = NullRegistry()

"""Metrics registry: counters, gauges, and fixed-bucket histograms.

Zero-dependency (stdlib only) and always live: recording a metric is a
lock + integer/float update, cheap enough that instrumented subsystems
(serving counters, resolution provenance, step-time histograms) count
unconditionally — only *span emission* is gated by the tracer's enabled
flag.  That keeps attribute-style APIs (``GanServer.samples_served``)
and CLI stats (``python -m repro_torch.program <m> --stats``) correct whether
or not a trace sink is attached.

Histograms are fixed-bucket: ``observe`` is O(log #buckets) (bisect)
and percentile extraction interpolates linearly inside the bucket that
contains the requested rank, clamped to the observed min/max — the
error is bounded by one bucket width (pinned against a numpy reference
in tests).

The :class:`Registry` keys metrics on ``(name, sorted labels)`` so
multiple instances (two servers, two planners) can share a metric name
without sharing counts.  ``snapshot()`` returns deep-copied plain data
— safe to read mid-step from another thread; ``register_collector``
attaches external stat sources (the dataflow μop cache, the autotuning
planner) that ``collect()`` snapshots on demand, replacing ad-hoc
private poking by observers like the train loop.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Iterable, Mapping, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "DEFAULT_LATENCY_BOUNDS_US", "metric_key"]


def _bounds(lo: float, hi: float, per_decade: int = 9) -> tuple:
    """Log-spaced 1-2-5 style bucket bounds covering [lo, hi]."""
    out, decade = [], lo
    steps = (1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 6.5, 8.0)[:per_decade]
    while decade <= hi:
        out.extend(decade * s for s in steps)
        decade *= 10.0
    return tuple(b for b in out if lo <= b <= hi)


# Default bounds for microsecond latencies: 1us .. 100s, ~8 buckets per
# decade — fine enough that p50/p99 land within a few percent.
DEFAULT_LATENCY_BOUNDS_US = _bounds(1.0, 1e8)


def metric_key(name: str, labels: Mapping[str, object]
               ) -> tuple[str, tuple]:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels: Mapping | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def to_json(self) -> dict:
        return {"value": self._value}


class Gauge:
    """Last-value gauge."""

    __slots__ = ("name", "labels", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels: Mapping | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def to_json(self) -> dict:
        return {"value": self._value}


class Histogram:
    """Fixed-bucket histogram with percentile extraction.

    ``bounds`` are the upper edges of the finite buckets (ascending);
    values above the last bound land in an overflow bucket whose upper
    edge is the observed max.  ``percentile(p)`` uses numpy's "linear"
    rank convention (rank = p/100 · (n-1)) and interpolates inside the
    containing bucket, so the error is at most that bucket's width.
    """

    __slots__ = ("name", "labels", "bounds", "_counts", "_count",
                 "_sum", "_min", "_max", "_lock")
    kind = "histogram"

    def __init__(self, name: str, labels: Mapping | None = None,
                 bounds: Sequence[float] | None = None):
        self.name = name
        self.labels = dict(labels or {})
        bounds = tuple(float(b) for b in
                       (bounds if bounds is not None
                        else DEFAULT_LATENCY_BOUNDS_US))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != \
                len(bounds):
            raise ValueError(f"histogram bounds must be strictly "
                             f"ascending, got {bounds}")
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else math.nan

    def percentile(self, p: float) -> float:
        """Approximate p-th percentile (numpy 'linear' rank), bounded
        by one bucket width."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        with self._lock:
            counts = list(self._counts)
            count, vmin, vmax = self._count, self._min, self._max
        if not count:
            return math.nan
        rank = (p / 100.0) * (count - 1)
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if rank < cum + c:
                lo = vmin if i == 0 else self.bounds[i - 1]
                hi = vmax if i == len(self.bounds) else self.bounds[i]
                frac = (rank - cum + 0.5) / c   # mid-rank within bucket
                v = lo + frac * (hi - lo)
                return min(max(v, vmin), vmax)
            cum += c
        return vmax

    def percentiles(self) -> dict[str, float]:
        return {"p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}

    def to_json(self) -> dict:
        with self._lock:
            d = {"count": self._count, "sum": self._sum,
                 "min": self._min if self._count else None,
                 "max": self._max if self._count else None,
                 "bounds": list(self.bounds),
                 "counts": list(self._counts)}
        if self._count:
            d.update({k: v for k, v in self.percentiles().items()})
        return d


class Registry:
    """Get-or-create store of metrics keyed on (name, labels), plus
    collector hooks for external stat sources."""

    def __init__(self):
        self._metrics: dict[tuple, object] = {}
        self._collectors: dict[str, Callable[[], Mapping | None]] = {}
        self._lock = threading.Lock()

    # -- get-or-create ------------------------------------------------------
    def _get(self, cls, name: str, labels: Mapping, **kw):
        key = metric_key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r}{dict(labels)} already "
                                f"registered as {type(m).__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Sequence[float] | None = None,
                  **labels) -> Histogram:
        h = self._get(Histogram, name, labels, bounds=bounds)
        if bounds is not None and tuple(float(b) for b in bounds) != \
                h.bounds:
            raise ValueError(f"histogram {name!r} already registered "
                             f"with different bounds")
        return h

    def metrics(self) -> Iterable:
        with self._lock:
            return list(self._metrics.values())

    # -- snapshots ----------------------------------------------------------
    def snapshot(self) -> dict[str, dict]:
        """Deep-copied plain-data view: ``{"counters": {label-qualified
        name: value}, "gauges": {...}, "histograms": {...}}`` — safe to
        hold across steps (copies, never aliases live state)."""
        out: dict[str, dict] = {"counters": {}, "gauges": {},
                                "histograms": {}}
        for m in self.metrics():
            label = ",".join(f"{k}={v}"
                             for k, v in sorted(m.labels.items()))
            qual = f"{m.name}{{{label}}}" if label else m.name
            if m.kind == "counter":
                out["counters"][qual] = m.value
            elif m.kind == "gauge":
                out["gauges"][qual] = m.value
            else:
                out["histograms"][qual] = m.to_json()
        return out

    # -- collectors ---------------------------------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], Mapping | None]) -> None:
        """Attach an external stats source (e.g. an LRU cache's info or
        a planner's counters).  ``fn`` returns a mapping or None
        (source not alive); ``collect`` copies whatever it returns."""
        with self._lock:
            self._collectors[name] = fn

    def collect(self) -> dict[str, dict]:
        """``{collector name: copied stats dict}`` for every collector
        whose source is alive right now.  Every returned dict is a fresh
        copy — mid-step readers get a consistent snapshot, never an
        alias of live mutable state."""
        with self._lock:
            collectors = dict(self._collectors)
        out = {}
        for name, fn in collectors.items():
            stats = fn()
            if stats is not None:
                out[name] = dict(stats)
        return out

    def reset(self) -> None:
        """Drop every metric (collectors survive) — test isolation."""
        with self._lock:
            self._metrics.clear()

"""Unified metric registry — counters, gauges, reservoir histograms.

One implementation for every host-side metric in the stack: the training
driver's phase accumulators (``utils/metrics.Metrics`` is now a thin
veneer over this), the serving engine's counters/latency reservoirs
(``serving/metrics.ServingMetrics``), and the runtime watchdogs
(``telemetry/watchdog.py``).  The lineage kept three separate ad-hoc
implementations (reference ``Metrics.scala`` driver accumulators, the
serving latency ring, bench-local medians); BigDL 2.0's cluster pipeline
(arXiv:2204.01715 §4) treats one metrics substrate as the foundation the
optimizer and dashboard both stand on — this is that substrate.

Port of ``bigdl_tpu/telemetry/registry.py`` (stdlib only, an owned
copy).  Everything here is host-side bookkeeping: no device work, no
syncs.  That property is what makes the telemetry subsystem provably
inert (see ``telemetry/tracer.py``).

Thread safety: metric creation is serialized by the registry lock
(get-or-create is atomic — concurrent threads asking for the same name
get the SAME metric object); each metric serializes its own updates.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonic count (requests, recompiles, stall events)."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0  # write-guarded-by: _lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-written value (queue depth, memory watermark, fractions)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v: float = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Reservoir:
    """Fixed-size ring of recent values — the sliding-window percentile
    estimator (p50/p95/p99 over the most recent ``capacity`` samples).

    A bounded ring instead of an unbounded list: an always-on endpoint
    must not grow memory with request count.  This is the one reservoir
    implementation in the tree; ``serving.metrics.LatencyReservoir`` is
    an alias of it.
    """

    def __init__(self, capacity: int = 4096):
        self._lock = threading.Lock()
        self._buf = [0.0] * capacity  # guarded-by: _lock
        # total ever recorded; write-guarded-by: _lock
        self._n = 0

    def record(self, value: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = value
            self._n += 1

    @property
    def count(self) -> int:
        """Total values ever recorded (not just the retained window)."""
        return self._n

    def window(self) -> List[float]:
        """Copy of the retained sample window (unordered) — what the
        set-level aggregation concatenates to compute cross-replica
        percentiles (``ServingMetrics.aggregate``)."""
        with self._lock:
            n = min(self._n, len(self._buf))
            return list(self._buf[:n])

    def percentiles(self, qs=(50, 95, 99)) -> Optional[Dict[str, float]]:
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return None
            window = sorted(self._buf[:n])
        out = {}
        for q in qs:
            # nearest-rank percentile over the window
            idx = min(n - 1, max(0, int(round(q / 100.0 * n)) - 1))
            out[f"p{q}"] = window[idx]
        out["mean"] = sum(window) / n
        out["max"] = window[-1]
        return out


class Histogram:
    """Exact sum/count/min/max plus a bounded reservoir for percentiles.

    The exact accumulators are what ``Metrics.summary()`` (driver phase
    accumulators) reads; the reservoir serves the p50/p95/p99 SLO view.
    """

    __slots__ = ("name", "_lock", "_res", "_sum", "_count", "_min", "_max")

    def __init__(self, name: str, capacity: int = 4096):
        self.name = name
        self._lock = threading.Lock()
        self._res = Reservoir(capacity)
        # exact accumulators: one locked writer (observe); the scalar
        # properties read lock-free (stale-but-consistent floats)
        self._sum = 0.0                       # write-guarded-by: _lock
        self._count = 0                       # write-guarded-by: _lock
        self._min: Optional[float] = None     # write-guarded-by: _lock
        self._max: Optional[float] = None     # write-guarded-by: _lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
        self._res.record(v)

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentiles(self, qs=(50, 95, 99)) -> Optional[Dict[str, float]]:
        return self._res.percentiles(qs)

    @property
    def reservoir(self) -> Reservoir:
        """The backing percentile window (``ServingMetrics`` exposes it
        as the historical ``latency`` attribute; aggregation reads
        ``.window()``)."""
        return self._res

    def snapshot(self) -> dict:
        with self._lock:
            snap = {"count": self._count, "sum": self._sum,
                    "mean": self._sum / self._count if self._count else 0.0,
                    "min": self._min, "max": self._max}
        pct = self._res.percentiles()
        if pct is not None:
            snap.update({k: pct[k] for k in ("p50", "p95", "p99")})
        return snap


class MetricRegistry:
    """Get-or-create registry of named metrics, snapshot-exportable.

    Names are flat strings; the convention is ``scope/name``
    (``driver/device_wait_fraction``, ``telemetry/recompiles``,
    ``serving/rows_dispatched``).  Asking for an existing name with a
    different metric type is a bug and raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}  # guarded-by: _lock

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str, capacity: int = 4096) -> Histogram:
        return self._get_or_create(name, Histogram, capacity)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able snapshot: ``{"counters": {name: int}, "gauges":
        {name: float}, "histograms": {name: {count, sum, mean, min,
        max, p50, p95, p99}}}``."""
        with self._lock:
            items = list(self._metrics.items())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][name] = m.snapshot()
        return out

    def gauges(self) -> Dict[str, float]:
        """Flat name → value of gauges only — cheap enough for a
        per-block poll (no histogram-reservoir sorting)."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.value for name, m in items
                if isinstance(m, Gauge)}

    def scalars(self) -> Dict[str, float]:
        """Flat name → scalar view (counters/gauges as-is, histograms as
        their mean) — what the driver mirrors into ``TrainSummary``."""
        with self._lock:
            items = list(self._metrics.items())
        out = {}
        for name, m in items:
            out[name] = m.mean if isinstance(m, Histogram) else m.value
        return out

    def discard(self, name: str) -> None:
        """Remove one metric if present (``Metrics.reset`` uses this to
        clear only the accumulators it owns on a SHARED registry)."""
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Drop every metric.  NOTE: holders of direct metric-object
        references (watchdog counters) keep updating orphaned objects
        after this — on a shared registry prefer :meth:`discard` of the
        names you own."""
        with self._lock:
            self._metrics.clear()

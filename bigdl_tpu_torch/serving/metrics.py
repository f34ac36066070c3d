"""Serving observability: per-model counters + latency percentiles.

Port of ``bigdl_tpu/serving/metrics.py`` (an owned copy).  Every
:class:`~bigdl_tpu_torch.serving.InferenceService` owns one
:class:`ServingMetrics` over a
:class:`~bigdl_tpu_torch.telemetry.registry.MetricRegistry` and surfaces
it as a plain-dict snapshot (``service.stats()``, the reference's
schema).  Latency windows are registry histograms: one global
(``serving/latency_s``) and one per row bucket
(``serving/latency_s_bucket{N}``, created as traffic reaches the bucket),
since a 1-row dispatch and a 32-row dispatch have very different service
times; ``LatencyReservoir`` is the registry's ``Reservoir`` and
``.latency`` the global histogram's backing reservoir.
``throughput_rps`` is computed over the ACTIVITY window (first submit →
last completion), not uptime, so idle time does not dilute it;
``throughput_window_s`` reports that window, and
:meth:`ServingMetrics.aggregate` computes a replica set's view over the
union of its replicas' activity windows.

Everything is host-side bookkeeping — nothing here touches the device.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from bigdl_tpu_torch.telemetry.registry import (Histogram, MetricRegistry,
                                                Reservoir)

# back-compat alias: the serving latency window IS the registry reservoir
LatencyReservoir = Reservoir


class ServingMetrics:
    """Thread-safe counters for one deployed model.

    ``mean_batch_occupancy`` is real rows / dispatched (bucket) rows —
    1.0 means every padded slot carried a real request, 1/bucket means
    the batcher is dispatching singletons (no coalescing win).
    """

    def __init__(self, registry: Optional[MetricRegistry] = None):
        self.registry = registry if registry is not None else MetricRegistry()
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        reg = self.registry
        self._submitted = reg.counter("serving/requests_submitted")
        self._completed = reg.counter("serving/requests_completed")
        self._rejected = reg.counter("serving/requests_rejected")
        self._failed = reg.counter("serving/requests_failed")
        self._cancelled = reg.counter("serving/requests_cancelled")
        self._dispatches = reg.counter("serving/dispatches")
        self._rows_real = reg.counter("serving/rows_real")
        self._rows_dispatched = reg.counter("serving/rows_dispatched")
        # global latency window: a registry histogram so /metrics
        # renders its quantiles; .latency is its backing reservoir (the
        # historical attribute surface)
        self._latency_h = reg.histogram("serving/latency_s")
        self.latency = self._latency_h.reservoir
        # per-row-bucket latency histograms, created as buckets see
        # traffic (registry get-or-create is atomic; the lock only
        # guards the local cache dict); guarded-by: _lock
        self._bucket_latency: Dict[int, Histogram] = {}
        # activity window (monotonic): first submit → last completion —
        # the unbiased throughput denominator (module docstring)
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        # weights dtype of the served model (int8 speed-path PR): the
        # gauge is PRE-created here — one fixed metric name per service
        # registry, value-coded — so the Prometheus scrape schema is
        # bounded up front instead of growing a label per dtype string.
        # Snapshot back-compat: the "weights_dtype" key appears only
        # once set (absent = "f32", the historical default).
        self._weights_dtype: Optional[str] = None
        self._weights_dtype_g = reg.gauge("serving/weights_dtype_code")

    #: fixed value coding for serving/weights_dtype_code (absent
    #: dtypes intentionally unrepresentable — bounded cardinality)
    WEIGHTS_DTYPE_CODES = {"f32": 0, "bf16": 1, "int8": 2}

    def set_weights_dtype(self, dtype: str) -> None:
        """Tag the served model's weight dtype (``"f32"`` | ``"bf16"``
        | ``"int8"``) — surfaces in :meth:`snapshot` and as the
        pre-created ``serving/weights_dtype_code`` gauge on
        ``/metrics``."""
        if dtype not in self.WEIGHTS_DTYPE_CODES:
            raise ValueError(
                f"weights_dtype must be one of "
                f"{sorted(self.WEIGHTS_DTYPE_CODES)}, got {dtype!r}")
        self._weights_dtype = dtype
        self._weights_dtype_g.set(self.WEIGHTS_DTYPE_CODES[dtype])

    @property
    def weights_dtype(self) -> Optional[str]:
        return self._weights_dtype

    # back-compat value surface (pre-registry these were plain ints)
    @property
    def submitted(self) -> int:
        return self._submitted.value

    @property
    def completed(self) -> int:
        return self._completed.value

    @property
    def rejected(self) -> int:
        return self._rejected.value

    @property
    def failed(self) -> int:
        return self._failed.value

    @property
    def cancelled(self) -> int:
        return self._cancelled.value

    @property
    def dispatches(self) -> int:
        return self._dispatches.value

    @property
    def rows_real(self) -> int:
        return self._rows_real.value

    @property
    def rows_dispatched(self) -> int:
        return self._rows_dispatched.value

    # -- recording (called from submit / batcher threads) -----------------
    def record_submit(self, rows: int) -> None:
        if self._t_first_submit is None:
            # racy-by-design single write: two first submits land
            # within microseconds of each other — either anchors fine
            self._t_first_submit = time.monotonic()
        self._submitted.inc(rows)

    def record_reject(self, rows: int = 1) -> None:
        self._rejected.inc(rows)

    def record_dispatch(self, real_rows: int, bucket_rows: int) -> None:
        self._dispatches.inc()
        self._rows_real.inc(real_rows)
        self._rows_dispatched.inc(bucket_rows)

    def record_done(self, rows: int, latency_s: float,
                    bucket: Optional[int] = None) -> None:
        self._completed.inc(rows)
        self._t_last_done = time.monotonic()
        self._latency_h.observe(latency_s)
        if bucket is not None:
            # lock-free fast-path read BY DESIGN: a GIL-atomic dict get
            # racing the locked setdefault below at worst misses and
            # falls into the locked path; record_done is per-request
            # hot — graftlint: disable=GL201
            h = self._bucket_latency.get(bucket)
            if h is None:
                with self._lock:  # lazy get-or-create, race-safe
                    h = self._bucket_latency.setdefault(
                        bucket, self.registry.histogram(
                            f"serving/latency_s_bucket{bucket}"))
            h.observe(latency_s)

    def record_failure(self, rows: int) -> None:
        self._failed.inc(rows)

    def record_cancel(self, rows: int) -> None:
        self._cancelled.inc(rows)

    # -- windows -----------------------------------------------------------
    def activity_window(self) -> Optional[tuple]:
        """(first_submit, last_done) monotonic pair, or None before any
        completion — the unbiased throughput denominator."""
        t0, t1 = self._t_first_submit, self._t_last_done
        if t0 is None or t1 is None:
            return None
        return (t0, max(t1, t0))

    # -- snapshot ----------------------------------------------------------
    @staticmethod
    def _ms(pct: Optional[dict]) -> Optional[dict]:
        if pct is None:
            return None
        return {k: round(v * 1e3, 3) for k, v in pct.items()}

    def snapshot(self, queue_depth: int = 0,
                 compile_count: int = 0) -> dict:
        """Plain-dict stats (the ``service.stats()`` schema documented in
        the README serving section).  Latencies are reported in ms."""
        uptime = max(time.monotonic() - self.started_at, 1e-9)
        window = self.activity_window()
        window_s = max(window[1] - window[0], 1e-9) if window else None
        completed = self.completed
        rows_dispatched = self.rows_dispatched
        occ = (self.rows_real / rows_dispatched
               if rows_dispatched else None)
        snap = {
            "requests_submitted": self.submitted,
            "requests_completed": completed,
            "requests_rejected": self.rejected,
            "requests_failed": self.failed,
            "requests_cancelled": self.cancelled,
            "dispatch_count": self.dispatches,
            "rows_dispatched": rows_dispatched,
            "mean_batch_occupancy":
                round(occ, 4) if occ is not None else None,
            # rate over the ACTIVITY window, not uptime (window-bias
            # audit in the module docstring); 0.0 before any completion
            "throughput_rps": (round(completed / window_s, 2)
                               if window_s is not None else 0.0),
            "throughput_window_s": (round(window_s, 3)
                                    if window_s is not None else None),
            "queue_depth": queue_depth,
            "compile_count": compile_count,
            "uptime_s": round(uptime, 3),
        }
        if self._weights_dtype is not None:
            snap["weights_dtype"] = self._weights_dtype
        snap["latency_ms"] = self._ms(self._latency_h.percentiles())
        with self._lock:
            buckets = sorted(self._bucket_latency.items())
        snap["latency_ms_by_bucket"] = (
            {b: self._ms(h.percentiles()) for b, h in buckets}
            if buckets else None)
        return snap

    # -- set-level aggregation --------------------------------------------
    @staticmethod
    def aggregate(metrics: Sequence["ServingMetrics"],
                  queue_depth: int = 0) -> dict:
        """Snapshot-shaped aggregate over N per-replica metrics (the
        ``ReplicaSet.stats()["aggregate"]`` view — satellite audit):

        - counters sum;
        - ``throughput_rps`` = total completions over the UNION of the
          replicas' activity windows (earliest first-submit → latest
          completion) — not a sum of per-replica rates, whose
          denominators differ, and not replica 0's number;
        - latency percentiles are computed over the CONCATENATED
          reservoir windows (global and per bucket), so the set p99 is
          the p99 of actual recent samples, not an average of averages.
        """
        metrics = list(metrics)  # tolerate one-shot iterables
        tot = {k: 0 for k in
               ("requests_submitted", "requests_completed",
                "requests_rejected", "requests_failed",
                "requests_cancelled", "dispatch_count",
                "rows_real", "rows_dispatched")}
        windows: List[tuple] = []
        lat_samples: List[float] = []
        bucket_samples: Dict[int, List[float]] = {}
        for m in metrics:
            tot["requests_submitted"] += m.submitted
            tot["requests_completed"] += m.completed
            tot["requests_rejected"] += m.rejected
            tot["requests_failed"] += m.failed
            tot["requests_cancelled"] += m.cancelled
            tot["dispatch_count"] += m.dispatches
            tot["rows_real"] += m.rows_real
            tot["rows_dispatched"] += m.rows_dispatched
            w = m.activity_window()
            if w is not None:
                windows.append(w)
            lat_samples.extend(m.latency.window())
            with m._lock:
                items = list(m._bucket_latency.items())
            for b, h in items:
                bucket_samples.setdefault(b, []).extend(
                    h.reservoir.window())
        window_s = (max(w[1] for w in windows)
                    - min(w[0] for w in windows)) if windows else None
        if window_s is not None:
            window_s = max(window_s, 1e-9)
        occ = (tot["rows_real"] / tot["rows_dispatched"]
               if tot["rows_dispatched"] else None)

        def pct(samples: List[float]) -> Optional[dict]:
            # same nearest-rank rule as Reservoir.percentiles, computed
            # directly over the already-materialized sample list
            n = len(samples)
            window = sorted(samples)
            out_ = {}
            for q in (50, 95, 99):
                idx = min(n - 1, max(0, int(round(q / 100.0 * n)) - 1))
                out_[f"p{q}"] = window[idx]
            out_["mean"] = sum(window) / n
            out_["max"] = window[-1]
            return ServingMetrics._ms(out_)

        out = dict(tot)
        out.pop("rows_real")
        out["n_sources"] = len(metrics)
        out["mean_batch_occupancy"] = (round(occ, 4)
                                       if occ is not None else None)
        out["throughput_rps"] = (
            round(tot["requests_completed"] / window_s, 2)
            if window_s is not None else 0.0)
        out["throughput_window_s"] = (round(window_s, 3)
                                      if window_s is not None else None)
        out["queue_depth"] = queue_depth
        out["latency_ms"] = pct(lat_samples) if lat_samples else None
        out["latency_ms_by_bucket"] = (
            {b: pct(s) for b, s in sorted(bucket_samples.items())}
            if bucket_samples else None)
        return out

"""Metrics — named training-loop phase accumulators.

Port of ``bigdl_tpu/utils/metrics.py`` (an owned copy).

Reference: ``DL/optim/Metrics.scala:31`` — named counters backed by Spark
accumulators, printed by ``summary()``; the built-in profiling of the
training loop.

Since the telemetry PR this is a thin veneer over
:class:`bigdl_tpu_torch.telemetry.registry.MetricRegistry` — the driver's
phase accumulators, the serving engine's counters, and the runtime
watchdogs share ONE metrics implementation (each named accumulator is a
registry :class:`~bigdl_tpu_torch.telemetry.registry.Histogram`, so the same
data also carries p50/p95/p99 for free).  The public surface —
``add``/``time``/``value``/``mean``/``summary``/``reset`` — and the
``summary()`` string format are unchanged (back-compat gated in
``tests/test_telemetry.py``; the port's in
``tests/test_torch_telemetry.py``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

from bigdl_tpu_torch.telemetry.registry import MetricRegistry


class Metrics:
    def __init__(self, registry: Optional[MetricRegistry] = None):
        # shared registry (the driver hands its telemetry registry in)
        # or a private one — either way the veneer below is identical
        self.registry = registry if registry is not None else MetricRegistry()
        self._owned: set = set()  # names this instance created

    def add(self, name: str, value: float) -> None:
        self._owned.add(name)
        self.registry.histogram(name).observe(value)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def _hist(self, name: str):
        m = self.registry.get(name)
        from bigdl_tpu_torch.telemetry.registry import Histogram
        return m if isinstance(m, Histogram) else None

    def value(self, name: str) -> float:
        h = self._hist(name)
        return h.sum if h is not None else 0.0

    def mean(self, name: str) -> float:
        h = self._hist(name)
        return h.mean if h is not None else 0.0

    def summary(self) -> str:
        """(reference ``Metrics.summary`` printed at
        ``DistriOptimizer.scala:393``)"""
        from bigdl_tpu_torch.telemetry.registry import Histogram
        rows = [(name, m) for name in self.registry.names()
                for m in [self.registry.get(name)]
                if isinstance(m, Histogram)]
        parts = [f"{k}: sum={h.sum:.4f} mean={h.mean:.4f} n={h.count}"
                 for k, h in rows]
        return "\n".join(parts)

    def snapshot(self) -> dict:
        """JSON-able registry snapshot (superset of ``summary()``)."""
        return self.registry.snapshot()

    def reset(self) -> None:
        """Clear THIS instance's accumulators only.  The registry may be
        shared with the telemetry watchdogs (gauges + cached counter
        objects); a blanket ``registry.reset()`` would orphan those —
        their later increments would update objects no snapshot can see
        — so only the names this Metrics created are discarded."""
        for name in self._owned:
            self.registry.discard(name)
        self._owned.clear()

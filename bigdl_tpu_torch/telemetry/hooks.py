"""DriverTelemetry — the bundle the training driver carries.

Port of ``bigdl_tpu/telemetry/hooks.py``.

One object holding the tracer, the metric registry, and the three
watchdogs, so ``Optimizer._train_driver`` stays readable: every
telemetry call site in the driver is ``tel.<thing>`` behind a single
``if tel is not None`` discipline (the driver holds ``None`` when
telemetry is off — the off path is UNTOUCHED, which is half of the
inertness proof; the other half is that the on path only reads clocks).

Round 2 (the admin-plane PR): the bundle also carries the run's
**trace context** — one ``trace_id`` minted per training run, stamped
on checkpoint commits, rollbacks, numeric-guard and preemption events
in both the tracer and the (optional) flight recorder, so a crash dump
and a trace file join into one story (``tools/obs_report.py``).
"""

from __future__ import annotations

from typing import Optional

from bigdl_tpu_torch.telemetry.context import new_trace_id
from bigdl_tpu_torch.telemetry.registry import MetricRegistry
from bigdl_tpu_torch.telemetry.tracer import Tracer
from bigdl_tpu_torch.telemetry.watchdog import (MemoryWatermark,
                                          RecompileWatchdog, StallDetector)


class DriverTelemetry:
    """Tracer + registry + watchdogs (+ run trace context) for one
    training run.

    ``registry`` defaults to a fresh :class:`MetricRegistry`; the driver
    passes its ``Metrics`` registry so phase accumulators, watchdog
    counters, and stall gauges land in ONE snapshot.  ``flight`` is the
    optional :class:`~bigdl_tpu_torch.telemetry.flight.FlightRecorder` —
    recompile events land there too (with the run's trace_id), so the
    black box records the GL106-at-runtime verdicts alongside the
    resilience story.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 trace_capacity: int = 200_000,
                 trace_path: Optional[str] = None, flight=None,
                 device=None):
        self.registry = registry if registry is not None else MetricRegistry()
        self.tracer = Tracer(enabled=True, capacity=trace_capacity)
        self.flight = flight
        self.trace_id = new_trace_id()  # the RUN's trace context
        self.recompile = RecompileWatchdog(self.registry, self.tracer,
                                           flight=flight,
                                           trace_id=self.trace_id)
        self.stalls = StallDetector(self.registry, self.tracer)
        # the run's device: its allocator feeds the memory gauges
        self.memory = MemoryWatermark(self.registry, device)
        self.trace_path = trace_path

    def snapshot(self) -> dict:
        """Registry snapshot plus watchdog verdicts — the JSON export."""
        snap = self.registry.snapshot()
        snap["trace_id"] = self.trace_id
        snap["watchdogs"] = {
            "recompile_events": [
                {"key": str(k), "from": old, "to": new}
                for k, old, new in self.recompile.events],
            "stager_starvation_events": self.stalls.starvation_count,
            "host_sync_stall_events": self.stalls.sync_stall_count,
            "blocks_observed": self.stalls.blocks_observed,
            "phase_fractions": self.stalls.fractions(),
            "memory_stats_available": self.memory.available,
        }
        snap["trace"] = {"span_count": len(self.tracer.events()),
                         "dropped_events": self.tracer.dropped_events}
        return snap

    def health_snapshot(self) -> dict:
        """The ``/healthz`` provider for a training run: watchdog
        verdicts; ``ok`` = no steady-state recompile and no host-sync
        stall observed."""
        return {
            "ok": (self.recompile.silent
                   and self.stalls.sync_stall_count == 0),
            "trace_id": self.trace_id,
            "recompiles": self.recompile.recompile_count,
            "stager_starvations": self.stalls.starvation_count,
            "host_sync_stalls": self.stalls.sync_stall_count,
            "blocks_observed": self.stalls.blocks_observed,
        }

    def finalize(self) -> Optional[str]:
        """Dump the Chrome trace if a path was configured."""
        if self.trace_path:
            return self.tracer.dump(self.trace_path)
        return None

"""bigdl_tpu_torch.telemetry — tracing, metrics and runtime watchdogs
(port of ``bigdl_tpu/telemetry``, stdlib-only modules owned as copies).

- :class:`Tracer` — step-timeline spans (block staging, dispatch, the
  one-block-behind device wait, replay, triggers) exported as
  Chrome-trace JSON; summarize with ``python -m tools.trace_report``;
- :class:`MetricRegistry` — counters, gauges, reservoir histograms with
  p50/p95/p99; ``utils/metrics.Metrics`` and
  ``serving/metrics.ServingMetrics`` are veneers over it;
- watchdogs — :class:`RecompileWatchdog` (silent on the eager driver),
  :class:`StallDetector` (stager starvation / host-sync stalls),
  :class:`MemoryWatermark` (the CUDA caching allocator's gauges);
- :class:`RequestContext` — per-request trace context minted at
  ``submit()``, fan-in flow arrows in the Chrome trace;
- :class:`AdminServer` — ``/metrics``, ``/healthz``, ``/trace``,
  ``/flight``, ``/profile?seconds=N`` on a loopback-only stdlib http
  thread (``Config.admin_port``, off by default);
- :class:`FlightRecorder` — a crash-surviving JSONL event stream
  (``Config.flight_recorder_path``), joined with traces by
  ``python -m tools.obs_report``.

Enable for training with ``Config.telemetry_enabled`` /
``BIGDL_TPU_TELEMETRY=1`` or per run with
``optimizer.set_telemetry(True, trace_path="trace.json")``.  Everything
here is host-side: turning it on adds no launch and no host-device sync,
and leaves the loss sequence bitwise unchanged
(``tests/test_torch_telemetry.py``).
"""

from bigdl_tpu_torch.telemetry.admin import AdminServer, render_prometheus
from bigdl_tpu_torch.telemetry.context import RequestContext, new_trace_id
from bigdl_tpu_torch.telemetry.flight import FlightRecorder
from bigdl_tpu_torch.telemetry.hooks import DriverTelemetry
from bigdl_tpu_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                                MetricRegistry, Reservoir)
from bigdl_tpu_torch.telemetry.tracer import NULL_SPAN, PHASE_CATS, Tracer
from bigdl_tpu_torch.telemetry.watchdog import (MemoryWatermark,
                                                RecompileWatchdog,
                                                StallDetector,
                                                jit_cache_size)

__all__ = [
    "AdminServer", "Counter", "DriverTelemetry", "FlightRecorder", "Gauge",
    "Histogram", "MemoryWatermark", "MetricRegistry", "NULL_SPAN",
    "PHASE_CATS", "RecompileWatchdog", "RequestContext", "Reservoir",
    "StallDetector", "Tracer", "jit_cache_size", "new_trace_id",
    "render_prometheus",
]

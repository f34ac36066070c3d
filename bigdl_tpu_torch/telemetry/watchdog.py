"""Runtime watchdogs — recompiles, pipeline stalls, memory watermarks.

Port of ``bigdl_tpu/telemetry/watchdog.py``.  All of them are observers:
they read cheap host-side state (span durations, allocator counters),
record findings into the :class:`~bigdl_tpu_torch.telemetry.registry.
MetricRegistry` and the tracer, and log warnings — they never touch the
computation.

- :class:`RecompileWatchdog` — compiled-signature growth per dispatched
  block.  The port's driver is eager and compiles nothing, so
  :func:`jit_cache_size` gives None for its step and the watchdog stays
  silent, as the reference's does for a function that is not jitted.
- :class:`StallDetector` — per-block host-phase accounting, with the
  reference's thresholds.  The driver reports how long each block spent
  in staging (host stacking + H2D), dispatch (enqueueing the block's
  steps), the one-block-behind device wait, and trigger replay.  Stager
  starvation = staging dominates while the device wait is ~zero (the
  device is idle waiting for input).  Host-sync stall = a dispatch that
  took more than 50 ms.  An eager driver enqueues every launch of a
  block from Python, so a long block trips it: a true reading that the
  host is the bottleneck.
- :class:`MemoryWatermark` — the caching allocator's counters
  (``torch.cuda.memory_stats``) under the reference's gauge names on a
  CUDA device; a CPU device has none, and no gauge appears.  Reading
  allocator counters is a host call, not a sync.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.telemetry.registry import MetricRegistry
from bigdl_tpu_torch.telemetry.tracer import Tracer

logger = logging.getLogger("bigdl_tpu_torch.telemetry")


def jit_cache_size(fn) -> Optional[int]:
    """Compiled-signature count of ``fn`` where it keeps one (a
    ``_cache_size()`` method, as the reference's ``jax.jit`` wrappers
    have); None for anything else — every step the port's eager driver
    hands it, so :class:`RecompileWatchdog` stays silent."""
    size = getattr(fn, "_cache_size", None)
    return None if size is None else int(size())


class RecompileWatchdog:
    """Flags jit cache growth after a key's first observation.

    ``observe(key, cache_size)`` per dispatched block (or per serving
    traffic window): the first observation of a key records its
    baseline (the planned compile); any later growth is a steady-state
    recompile — counted, traced as an instant event, and warned once
    per occurrence.  ``observe`` with ``cache_size=None`` is a no-op,
    so call sites never need to branch on backend capabilities.
    """

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None, flight=None,
                 trace_id: Optional[str] = None):
        self._seen: Dict[object, int] = {}
        self.events: List[Tuple[object, int, int]] = []  # (key, old, new)
        self._counter = (registry.counter("telemetry/recompiles")
                         if registry is not None else None)
        self._tracer = tracer
        # optional flight recorder (+ the run's trace context): a
        # steady-state recompile is exactly the kind of rare
        # state-change the black box exists to keep
        self._flight = flight
        self._trace_id = trace_id

    def observe(self, key, cache_size: Optional[int]) -> bool:
        """Returns True when this observation flagged a recompile."""
        if cache_size is None:
            return False
        prev = self._seen.get(key)
        self._seen[key] = cache_size
        if prev is None or cache_size <= prev:
            return False
        self.events.append((key, prev, cache_size))
        if self._counter is not None:
            self._counter.inc()
        if self._tracer is not None:
            self._tracer.instant("recompile", key=str(key),
                                 cache_size=cache_size)
        if self._flight is not None:
            self._flight.record("recompile", cat="driver",
                                trace_id=self._trace_id, key=str(key),
                                cache_size=cache_size)
        logger.warning(
            "recompile watchdog: jit cache for %r grew %d -> %d after "
            "warmup — a steady-state retrace (GL106 discipline; check "
            "for shape churn / per-call scalar args)", key, prev,
            cache_size)
        return True

    @property
    def recompile_count(self) -> int:
        return len(self.events)

    @property
    def silent(self) -> bool:
        """No steady-state recompile observed."""
        return not self.events


class StallDetector:
    """Per-block pipeline-phase accounting + stall/starvation flags.

    ``record_block`` takes the four host-accounted phase durations of
    one dispatched block.  Fractions are of the host-accounted total
    (stage + dispatch + wait + replay) — device compute hidden behind
    the pipeline is deliberately not in the denominator; a healthy
    pipelined run shows ``device_wait`` absorbing nearly everything.
    """

    def __init__(self, registry: MetricRegistry,
                 tracer: Optional[Tracer] = None,
                 starvation_threshold: float = 0.5,
                 wait_floor: float = 0.1,
                 dispatch_stall_ms: float = 50.0,
                 warm_blocks: int = 1):
        self._registry = registry
        self._tracer = tracer
        self.starvation_threshold = starvation_threshold
        self.wait_floor = wait_floor
        self.dispatch_stall_ms = dispatch_stall_ms
        self.warm_blocks = warm_blocks
        self._totals = {"stage": 0.0, "dispatch": 0.0,
                        "device_wait": 0.0, "replay": 0.0}
        self._blocks = 0
        self._starvations = registry.counter(
            "telemetry/stager_starvation_events")
        self._sync_stalls = registry.counter(
            "telemetry/host_sync_stall_events")

    def record_block(self, stage_s: float, dispatch_s: float,
                     wait_s: float, replay_s: float,
                     first_compile: bool = False) -> None:
        """``first_compile``: this block's dispatch traced+compiled a
        fresh jit signature — a planned one-off cost, charged to the
        fractions but exempt from the stall flags (compile time is not
        a steady-state host sync)."""
        self._blocks += 1
        t = self._totals
        t["stage"] += stage_s
        t["dispatch"] += dispatch_s
        t["device_wait"] += wait_s
        t["replay"] += replay_s
        fr = self.fractions()
        reg = self._registry
        reg.gauge("driver/host_stage_fraction").set(fr["stage"])
        reg.gauge("driver/dispatch_fraction").set(fr["dispatch"])
        reg.gauge("driver/device_wait_fraction").set(fr["device_wait"])
        reg.gauge("driver/replay_fraction").set(fr["replay"])
        if first_compile or self._blocks <= self.warm_blocks:
            # warmup blocks carry compile/allocator noise — fractions
            # recorded, verdicts withheld (the bench warmup discipline)
            return
        block_total = stage_s + dispatch_s + wait_s + replay_s
        if block_total > 0:
            if (stage_s / block_total > self.starvation_threshold
                    and wait_s / block_total < self.wait_floor):
                self._starvations.inc()
                if self._tracer is not None:
                    self._tracer.instant(
                        "stager_starvation",
                        stage_ms=round(stage_s * 1e3, 3),
                        wait_ms=round(wait_s * 1e3, 3))
        if dispatch_s * 1e3 > self.dispatch_stall_ms:
            self._sync_stalls.inc()
            if self._tracer is not None:
                self._tracer.instant(
                    "host_sync_stall",
                    dispatch_ms=round(dispatch_s * 1e3, 3))
            logger.warning(
                "stall detector: block dispatch enqueue took %.1f ms "
                "(budget %.1f ms) — a hidden host sync or a saturated "
                "device queue is blocking the driver loop",
                dispatch_s * 1e3, self.dispatch_stall_ms)

    def fractions(self) -> Dict[str, float]:
        total = sum(self._totals.values())
        if total <= 0:
            return {k: 0.0 for k in self._totals}
        return {k: v / total for k, v in self._totals.items()}

    @property
    def blocks_observed(self) -> int:
        return self._blocks

    @property
    def starvation_count(self) -> int:
        return self._starvations.value

    @property
    def sync_stall_count(self) -> int:
        return self._sync_stalls.value


class MemoryWatermark:
    """Device-memory gauges from the caching allocator.

    On a CUDA device, ``device/bytes_in_use`` and
    ``device/peak_bytes_in_use`` are ``torch.cuda.memory_stats``'
    ``allocated_bytes.all.current`` and ``.peak``, and
    ``device/bytes_limit`` the card's total memory
    (``torch.cuda.mem_get_info``); a failure to read them raises.  A CPU
    device has no allocator counters: ``observe`` returns None and no
    gauge appears.  Reading the counters never syncs the device.
    """

    _KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")

    def __init__(self, registry: MetricRegistry, device=None):
        self._registry = registry
        self.device = device
        self.available: Optional[bool] = None  # unknown until first observe

    def observe(self, device=None) -> Optional[dict]:
        import torch
        device = torch.device(device if device is not None
                              else self.device or "cpu")
        if device.type != "cuda":
            self.available = False
            return None
        raw = torch.cuda.memory_stats(device)
        stats = {"bytes_in_use": raw["allocated_bytes.all.current"],
                 "peak_bytes_in_use": raw["allocated_bytes.all.peak"],
                 "bytes_limit": torch.cuda.mem_get_info(device)[1]}
        self.available = True
        for k in self._KEYS:
            self._registry.gauge(f"device/{k}").set(stats[k])
        return stats

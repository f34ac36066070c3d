"""Per-model-version circuit breaker (port of
``bigdl_tpu/resilience/health.py``, its ``CircuitBreaker``).

The registry's latest-wins routing consults it: ``trip_after``
consecutive failures open the breaker for ``cooldown_s`` (doubling on
each re-trip, capped), during which version resolution falls back to the
previous deployed version — a poisoned deploy stops eating traffic within
``trip_after`` requests instead of burning the error budget until a human
rolls back.  After the cooldown the breaker is half-open: traffic flows
again, the first failure re-trips, a success closes it.

Host-side bookkeeping only, same contract as ``telemetry/registry.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class CircuitBreaker:
    """Consecutive-failure breaker for one deployed model version.

    ``allow()`` is the routing predicate: True while closed or once the
    cooldown has elapsed (half-open — traffic flows, the next failure
    re-trips with a doubled cooldown, a success closes and resets it).
    Overload rejections must NOT be recorded here — a full queue says
    nothing about whether the model itself is poisoned.
    """

    def __init__(self, trip_after: int = 5, cooldown_s: float = 30.0,
                 cooldown_factor: float = 2.0,
                 cooldown_max_s: float = 300.0, registry=None,
                 name: str = "", clock=time.monotonic, recorder=None):
        self.trip_after = max(1, int(trip_after))
        self._base_cooldown_s = float(cooldown_s)
        self._cooldown_s = float(cooldown_s)  # guarded-by: _lock
        self._cooldown_factor = float(cooldown_factor)
        self._cooldown_max_s = float(cooldown_max_s)
        self._registry = registry
        self._recorder = recorder  # optional telemetry.FlightRecorder
        self._name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._consecutive_failures = 0       # guarded-by: _lock
        # guarded-by: _lock
        self._opened_at: Optional[float] = None
        self.trips = 0                       # write-guarded-by: _lock

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._opened_at = None
            self._cooldown_s = self._base_cooldown_s

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            half_open = (self._opened_at is not None
                         and self._clock() >= self._opened_at
                         + self._cooldown_s)
            if half_open or (self._opened_at is None
                             and self._consecutive_failures
                             >= self.trip_after):
                if half_open:  # failed trial: back off harder
                    self._cooldown_s = min(
                        self._cooldown_s * self._cooldown_factor,
                        self._cooldown_max_s)
                self._opened_at = self._clock()
                self.trips += 1
                if self._registry is not None:
                    self._registry.counter(
                        "resilience/breaker_trips").inc()
                if self._recorder is not None:
                    self._recorder.record(
                        "breaker_trip", cat="resilience",
                        version=self._name, trips=self.trips,
                        cooldown_s=round(self._cooldown_s, 3))

    def allow(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = self._clock()
        with self._lock:
            if self._opened_at is None:
                return True
            return now >= self._opened_at + self._cooldown_s  # half-open

    @property
    def open(self) -> bool:
        return not self.allow()

    def snapshot(self) -> dict:
        with self._lock:
            return {"open": (self._opened_at is not None
                             and self._clock() < self._opened_at
                             + self._cooldown_s),
                    "trips": self.trips,
                    "consecutive_failures": self._consecutive_failures,
                    "cooldown_s": round(self._cooldown_s, 3)}

"""Per-replica health state machine + per-model-version circuit breaker
(port of ``bigdl_tpu/resilience/health.py``, an owned copy).

Reference: BigDL 2.0 Cluster Serving isolates failures per replica and
keeps routing around them (arXiv:2204.01715 §3.3); the same shape as
every production serving mesh: a replica's recent behavior decides how
much traffic it earns.

Replica state machine (``ReplicaHealth``)::

    HEALTHY ──failure×degraded_after──▶ DEGRADED
    DEGRADED ──failure×quarantine_after─▶ QUARANTINED
    DEGRADED ──success──▶ HEALTHY
    QUARANTINED ──probe ok──▶ HEALTHY        (re-admission)
    QUARANTINED ──probe fail─▶ QUARANTINED   (backoff doubles)

A quarantined replica receives **no** regular traffic; after a
probation delay (exponential backoff + deterministic seeded jitter so
re-admission storms from N replicas decorrelate *and* tests replay
exactly) it is offered exactly ONE live request as a probation probe —
success re-admits, failure doubles the backoff.  ``mark_dead`` jumps
straight to QUARANTINED (a dead batcher thread is not a statistics
question).

``CircuitBreaker`` is the model-*version* analog for the registry's
latest-wins routing: ``trip_after`` consecutive failures open the
breaker for ``cooldown_s`` (doubling on each re-trip, capped), during
which version resolution falls back to the previous deployed version —
a poisoned deploy stops eating traffic within ``trip_after`` requests
instead of burning the error budget until a human rolls back.  After
the cooldown the breaker is half-open: traffic flows again, the first
failure re-trips, a success closes it.

Everything here is host-side bookkeeping, same contract as
``telemetry/registry.py``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"

#: ``admit()`` verdicts
ADMIT = "admit"
PROBE = "probe"
REFUSE = "refuse"


@dataclasses.dataclass
class HealthPolicy:
    """Thresholds/backoff for one replica set (shared by its replicas)."""

    degraded_after: int = 1       # consecutive failures → DEGRADED
    quarantine_after: int = 3     # consecutive failures → QUARANTINED
    probe_backoff_s: float = 0.5  # first probation delay
    probe_backoff_factor: float = 2.0
    probe_backoff_max_s: float = 30.0
    probe_jitter: float = 0.25    # jitter as a fraction of the backoff
    seed: int = 0                 # jitter determinism


class ReplicaHealth:
    """Health ledger for ONE replica.  Thread-safe; ``clock`` is
    injectable so unit tests can drive probation without sleeping."""

    def __init__(self, ix: int, policy: Optional[HealthPolicy] = None,
                 registry=None, clock=time.monotonic, recorder=None):
        self.ix = ix
        self.policy = policy or HealthPolicy()
        self._registry = registry
        # optional telemetry.FlightRecorder: every state TRANSITION is
        # recorded there (events ride boundaries the machine already
        # crosses — no new work on the no-transition path)
        self._recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        # the whole ledger mutates under one lock; `state` is exposed
        # as a lock-free read (stale by at most one transition)
        self._state = HEALTHY                # write-guarded-by: _lock
        self._consecutive_failures = 0       # guarded-by: _lock
        self._probes = 0                     # guarded-by: _lock
        self._probe_inflight = False         # guarded-by: _lock
        # guarded-by: _lock
        self._backoff_s = self.policy.probe_backoff_s
        self._next_probe_at = 0.0            # guarded-by: _lock

    # ------------------------------------------------------------ events
    def _count(self, name: str) -> None:
        if self._registry is not None:
            self._registry.counter(f"resilience/{name}").inc()

    def _transition(self, frm: str, to: str) -> None:
        if self._recorder is not None:
            self._recorder.record("health_transition", cat="resilience",
                                  replica=self.ix, frm=frm, to=to)

    # guarded-by: _lock
    def _quarantine_locked(self, now: float) -> None:
        if self._state != QUARANTINED:
            self._transition(self._state, QUARANTINED)
            self._state = QUARANTINED
            self._count("quarantines")
        self._schedule_probe_locked(now)

    # guarded-by: _lock
    def _schedule_probe_locked(self, now: float) -> None:
        p = self.policy
        # deterministic jitter: pure function of (seed, replica, probe#)
        jitter = float(np.random.default_rng(
            (p.seed, self.ix, self._probes)).random()) * p.probe_jitter
        self._next_probe_at = now + self._backoff_s * (1.0 + jitter)
        self._backoff_s = min(self._backoff_s * p.probe_backoff_factor,
                              p.probe_backoff_max_s)

    # -------------------------------------------------------------- api
    @property
    def state(self) -> str:
        return self._state

    def admit(self, now: Optional[float] = None) -> str:
        """Routing verdict for one request: ``ADMIT`` (regular traffic),
        ``PROBE`` (this request is the quarantined replica's one
        probation probe — the caller must report its outcome with
        ``probe=True``, or release the untried slot via
        :meth:`cancel_probe`: a consumed slot nobody releases
        quarantines the replica forever) or ``REFUSE``.  The slot inc/dec sites are
        `# acquires:`/`# releases:`-tagged so GL303 keeps the pairing
        checkable in this file; the cross-file caller contract
        (``ReplicaSet._pick``/``_on_done``) stays prose — per-file
        models are the unit."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._state != QUARANTINED:
                return ADMIT
            if self._probe_inflight or now < self._next_probe_at:
                return REFUSE
            self._probe_inflight = True  # acquires: probe_slot
            self._probes += 1
            self._count("probes")
            return PROBE

    def cancel_probe(self) -> None:
        """Release an admitted probation probe WITHOUT recording an
        outcome — the probe never actually exercised the replica (the
        submit was refused by a full queue, or the request expired in
        line from pure congestion).  The probe window stays as
        scheduled, so the next due request simply probes instead."""
        with self._lock:
            self._probe_inflight = False  # releases: probe_slot

    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if probe:
                self._probe_inflight = False  # releases: probe_slot
            if self._state == QUARANTINED:
                if not probe:
                    return  # stale non-probe completion; wait for probe
                self._transition(QUARANTINED, HEALTHY)
                self._state = HEALTHY
                self._backoff_s = self.policy.probe_backoff_s
                self._count("readmissions")
            elif self._state == DEGRADED:
                self._transition(DEGRADED, HEALTHY)
                self._state = HEALTHY

    def record_failure(self, probe: bool = False,
                       now: Optional[float] = None) -> None:
        if now is None:
            now = self._clock()
        with self._lock:
            self._consecutive_failures += 1
            if probe:
                self._probe_inflight = False  # releases: probe_slot
            if self._state == QUARANTINED:
                if probe:
                    # failed probation: stay out, schedule the next
                    # window (the doubled backoff applies there)
                    self._schedule_probe_locked(now)
                # a STALE non-probe failure (stranded requests from the
                # incident that quarantined us, draining in) must not
                # reschedule or double anything — one wedge with 8
                # requests in flight is one piece of evidence, not 8
                return
            p = self.policy
            if self._consecutive_failures >= p.quarantine_after:
                self._quarantine_locked(now)
            elif self._consecutive_failures >= p.degraded_after:
                if self._state != DEGRADED:
                    self._transition(self._state, DEGRADED)
                    self._state = DEGRADED
                    self._count("degradations")

    def mark_dead(self, now: Optional[float] = None) -> None:
        """Hard evidence (dead batcher thread): straight to QUARANTINED,
        no threshold arithmetic."""
        if now is None:
            now = self._clock()
        with self._lock:
            self._consecutive_failures = max(
                self._consecutive_failures,
                self.policy.quarantine_after)
            self._probe_inflight = False  # releases: probe_slot
            self._quarantine_locked(now)

    def next_probe_in(self, now: Optional[float] = None) -> float:
        """Seconds until the next probation probe (0 when not
        quarantined) — the load-shedding ``retry_after_ms`` hint when
        every replica is out."""
        if now is None:
            now = self._clock()
        with self._lock:
            if self._state != QUARANTINED:
                return 0.0
            return max(0.0, self._next_probe_at - now)

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive_failures,
                    "probes": self._probes,
                    "backoff_s": round(self._backoff_s, 3)}


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
        self._recorder = recorder  # optional telemetry.FlightRecorder
        self._base_cooldown_s = float(cooldown_s)
        self._cooldown_s = float(cooldown_s)  # guarded-by: _lock
        self._cooldown_factor = float(cooldown_factor)
        self._cooldown_max_s = float(cooldown_max_s)
        self._registry = registry
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

"""ReplicaSet — self-healing replica-per-device serving.

Port of ``bigdl_tpu/resilience/replica_set.py``: one
:class:`~bigdl_tpu_torch.serving.InferenceService` (own bounded queue, own
batcher thread, own warmed buckets, own copy of the model) per device,
fronted by a router that makes replica failure a routing event instead of
an outage (reference: BigDL 2.0 Cluster Serving's per-replica failure
isolation and backpressure, arXiv:2204.01715 §3.3).

Contract:

- **Least-queue-depth dispatch.**  Each request goes to the admitted
  replica with the shallowest queue (ties break on the lowest index —
  deterministic).  On a host with N cards this is the N× fan-out of one
  model; more replicas than devices round-robin over them, so two
  replicas can share one card (each with its own batcher thread), and N
  replicas on the CPU exercise every path below in the tests.
- **Per-request deadlines, propagated.**  ``deadline_ms`` stamps each
  request with a monotonic deadline that travels WITH it through the
  replica's queue (``serving/batcher._Request.deadline``): the batcher
  refuses to dispatch expired work, and the supervisor fails requests
  stuck on a wedged/dead replica so the router can move them.
- **Bounded retry — inference is idempotent.**  A failed or timed-out
  request is retried on a different healthy replica up to
  ``max_retries`` times while its deadline allows.  An accepted request
  is therefore never silently dropped: it resolves with a result or an
  explicit error.
- **Health state machine per replica** (``resilience/health.py``):
  failures degrade → quarantine; a quarantined replica gets zero
  traffic until its probation probe (exponential backoff + seeded
  jitter) succeeds.  A replica whose batcher thread DIED is detected by
  the supervisor (liveness poll — the one place in the serving stack
  that polls, because a dead thread cannot notify), quarantined
  immediately, its stranded requests failed over, and its batcher
  **revived** (fresh thread over the same warmed model —
  ``InferenceService.revive``) so probation has something to probe.
- **Queue-pressure load shedding.**  When no admitted replica can take
  the request (all queues full, or everything quarantined), the set
  sheds with :class:`~bigdl_tpu_torch.serving.ServiceOverloaded` carrying a
  ``retry_after_ms`` hint (queue drain rate when queues are the
  problem, next probation window when health is).

All events flow into one :class:`~bigdl_tpu_torch.telemetry.registry.
MetricRegistry` (``resilience/*`` counters) and, when given, a tracer
(instant events per quarantine/readmission/failover).
"""

from __future__ import annotations

import copy
import itertools
import logging
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, List, Optional, Sequence

from bigdl_tpu_torch.resilience.faults import FaultInjector
from bigdl_tpu_torch.resilience.health import (PROBE, QUARANTINED,
                                               HealthPolicy, ReplicaHealth)
from bigdl_tpu_torch.serving.batcher import (DeadlineExceeded, ServiceClosed,
                                             ServiceOverloaded,
                                             settle_future as _settle)
from bigdl_tpu_torch.serving.service import InferenceService
from bigdl_tpu_torch.telemetry.registry import MetricRegistry

logger = logging.getLogger("bigdl_tpu_torch.resilience")


def default_devices() -> List:
    """Every CUDA device of the process; raises without CUDA (pass CPU
    devices explicitly to run the set on the CPU)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ReplicaSet places replicas on CUDA devices by default but "
            "CUDA is not available; pass devices=[torch.device('cpu')] "
            "to run on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ReplicaDeadError(RuntimeError):
    """The replica holding this request died (batcher thread gone) —
    the supervisor resolves the stranded future with this so the router
    can fail over."""


class _Route:
    """Caller-facing request state: the outer future plus the retry
    budget.  One _Route may span several replica attempts;
    ``last_exc`` remembers the most recent attempt's real failure so
    running out of replicas surfaces THAT, not a fabricated shed.
    ``ctx`` (optional RequestContext) accumulates the hop history —
    one entry per attempt, outcome stamped at completion."""

    __slots__ = ("x", "outer", "deadline", "tries_left", "tried",
                 "last_exc", "ctx")

    def __init__(self, x, outer: Future, deadline: Optional[float],
                 tries_left: int, ctx=None):
        self.x = x
        self.outer = outer
        self.deadline = deadline
        self.tries_left = tries_left
        self.tried: set = set()
        self.last_exc: Optional[BaseException] = None
        self.ctx = ctx


class ReplicaSet:
    """N replicas of one model behind least-queue-depth routing with
    health tracking, failover and load shedding.  See module docstring.

    Parameters beyond the :class:`InferenceService` knobs:

    - ``n_replicas``: replica count; default one per local device.
      More replicas than devices is legal (emulated replicas — they
      round-robin over ``devices``).
    - ``devices``: placement targets; default every CUDA device
      (``cuda:0`` .. ``cuda:N-1``), raising without CUDA.  Each replica
      serves its own copy of ``model`` moved onto its device, so its
      dispatches run there (replica-per-card routing).
    - ``params`` / ``state``: optional weights in the reference's tree
      layout (``interop.load_jax_params``), loaded into every replica's
      copy; None serves ``model``'s own weights.
    - ``deadline_ms``: per-request deadline (default
      ``Config.serving_deadline_ms``; 0 = none).
    - ``max_retries``: failover budget per request (attempts = 1 +
      max_retries).
    - ``health``: a :class:`HealthPolicy` (thresholds/probation
      backoff) shared by all replicas.
    - ``registry`` / ``tracer``: where resilience events land.  With
      ``Config.request_tracing`` on and no tracer given, the set mints
      its own so request spans/flow edges have somewhere to go.
    - ``flight``: optional :class:`~bigdl_tpu_torch.telemetry.FlightRecorder`
      (None = ``telemetry.flight.from_config()``, which is None — the
      inert state — unless ``Config.flight_recorder_path`` is set).
      Deaths, quarantines, failovers, sheds, probes and revivals are
      recorded there with the victim request's trace_id, so a crash
      dump tells the full story (``tools/obs_report.py``).
    - ``request_tracing``: mint a :class:`~bigdl_tpu_torch.telemetry.
      RequestContext` per submit (None = ``Config.request_tracing``);
      contexts carry the per-request hop history.
    - ``priority_fn``: QoS preemption hook handed to every replica's
      batcher (see :class:`InferenceService`); the frontend's
      :class:`~bigdl_tpu_torch.frontend.QosAdmission` supplies it so
      latency-class tenants preempt batch backlog per replica queue.

    **Elastic replica count** (``set_replica_count``): replicas live in
    index-stable SLOTS.  Growing warms a new replica OFF the routing
    path (every bucket's warmup forward runs before the slot is admitted);
    shrinking retires the highest active slot through the quarantine
    discipline — the retired slot gets zero new traffic while its
    accepted backlog drains to completion, then its model is released.  Retired slots keep their index (in-flight
    bookkeeping, health ledgers and fault targeting stay stable) and
    are reused by the next grow.
    """

    _SUPERVISOR_POLL_S = 0.02  # liveness/deadline sweep while inflight

    def __init__(self, model, params=None, state=None, *,
                 n_replicas: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 input_spec=None, max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None, buckets=None,
                 workload: Optional[str] = None, name: str = "model",
                 deadline_ms: Optional[float] = None,
                 max_retries: int = 2,
                 health: Optional[HealthPolicy] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 registry: Optional[MetricRegistry] = None,
                 tracer=None, start: bool = True, flight=None,
                 request_tracing: Optional[bool] = None,
                 priority_fn=None):
        from bigdl_tpu_torch.telemetry import admin as _admin
        from bigdl_tpu_torch.telemetry import flight as _flight_mod
        from bigdl_tpu_torch.utils.config import get_config

        self.name = name
        self.registry = registry if registry is not None \
            else MetricRegistry()
        if request_tracing is None:
            request_tracing = get_config().request_tracing
        self._request_tracing = bool(request_tracing)
        if tracer is None and self._request_tracing:
            from bigdl_tpu_torch.telemetry.tracer import Tracer
            tracer = Tracer(enabled=True)
        self.tracer = tracer
        self._flight = flight if flight is not None \
            else _flight_mod.from_config()
        self.max_retries = max(0, int(max_retries))
        if deadline_ms is None:
            # the same explicit > env > tuned[workload] > default chain
            # the other serving knobs resolve through
            from bigdl_tpu_torch.engine import Engine
            deadline_ms = Engine.serving_defaults(workload)["deadline_ms"]
        self.deadline_s = (float(deadline_ms) / 1e3
                           if deadline_ms and deadline_ms > 0 else None)
        if fault_injector is None:
            fault_injector = FaultInjector.from_config(
                registry=self.registry)
        else:
            fault_injector.attach_registry(self.registry)
        self._faults = fault_injector

        if devices is None:
            devices = default_devices()
        from bigdl_tpu_torch.engine import resolve_device
        devices = [resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("ReplicaSet needs at least one device")
        if n_replicas is None:
            n_replicas = len(devices)
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1: {n_replicas}")

        # construction materials retained for set_replica_count grow:
        # a later replica must be built EXACTLY like the originals
        # (same params source, same devices round-robin, same policy)
        self._model = model
        self._base_params = params
        self._base_state = state
        self._devices = list(devices)
        self._policy = policy = health or HealthPolicy()
        self._input_spec = input_spec
        self._started = bool(start)
        self._priority_fn = priority_fn
        self._service_kw = dict(
            max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms,
            queue_capacity=queue_capacity, buckets=buckets)
        self._replicas: List[InferenceService] = []
        self._health: List[ReplicaHealth] = []
        for i in range(int(n_replicas)):
            svc, h = self._build_replica(i, input_spec)
            self._replicas.append(svc)
            self._health.append(h)
            if i == 0:
                # freeze the RESOLVED knobs off replica 0 so replicas
                # grown later match the originals even if config/env
                # defaults drift between now and then
                self._service_kw = dict(
                    max_batch_size=svc.max_batch_size,
                    batch_timeout_ms=svc.batch_timeout_ms,
                    queue_capacity=svc.queue_capacity,
                    buckets=svc.buckets)

        # counters created eagerly so a zero-event run still snapshots
        # the full schema
        for c in ("failovers", "sheds", "quarantines",
                  "readmissions", "probes", "degradations",
                  "deadline_timeouts", "replica_deaths", "revivals",
                  "replicas_added", "replicas_retired"):
            self.registry.counter(f"resilience/{c}")

        # admin plane: config-driven start + source registration — the
        # set-level resilience counters, every replica's serving
        # registry, the tracer, and a health provider all scrape from
        # one endpoint (admin_port=0 → None: nothing runs).  The name
        # is minted unique so two same-named sets don't evict each
        # other; replicas minted their own unique names above.
        self._admin_name: Optional[str] = None
        _srv = _admin.maybe_start()
        if _srv is not None:
            self._admin_name = _srv.unique_source_name(self.name)
            _srv.add_registry(self._admin_name, self.registry)
            _srv.add_health(self._admin_name, self.health_snapshot)
            if self.tracer is not None:
                _srv.add_tracer(self._admin_name, self.tracer)
            if self._flight is not None:
                _srv.set_flight(self._flight)

        self._lock = threading.Lock()
        # one death handler may run per replica at a time: routing and
        # the supervisor can both spot the same dead batcher, and a
        # double-revive would double-count the death in the metrics
        self._death_locks = [threading.Lock()
                             for _ in range(len(self._replicas))]
        # retired slots (orderly scale-down, NOT deaths): excluded from
        # routing and from the supervisor's death detection while their
        # backlog drains.  Replaced wholesale (copy-on-write frozenset)
        # so the lock-free readers on the routing path always see a
        # consistent set; write-guarded-by: _lock
        self._retired: frozenset = frozenset()
        # serializes set_replica_count operations (autoscaler vs manual
        # scaling); NEVER taken on a request path
        self._scale_lock = threading.Lock()
        # token -> (route, ix, inner, probe); guarded-by: _lock
        self._inflight: dict = {}
        self._token = itertools.count()
        # lifecycle flag/thread: written under the lock, read lock-free
        # on fast paths (submit's early refusal, stop's join)
        self._stopped = False  # write-guarded-by: _lock
        # write-guarded-by: _lock
        self._supervisor: Optional[threading.Thread] = None
        self._wake = threading.Condition(self._lock)

    # ---------------------------------------------------- replica build
    def _build_replica(self, ix: int, input_spec):
        """Construct replica ``ix``: a copy of the model moved onto device
        ``ix % D`` (its dispatches run on that card) behind a fresh
        :class:`InferenceService` and a fresh health ledger.  With an
        ``input_spec`` the bucket warmup happens HERE, before the caller
        admits the slot to routing, so a grown replica never serves a
        warmup stall."""
        dev = self._devices[ix % len(self._devices)]
        model_i = copy.deepcopy(self._model)
        if self._base_params is not None or self._base_state is not None:
            from bigdl_tpu_torch.interop.jax_weights import (load_jax_params,
                                                             to_jax_params)
            load_jax_params(model_i.cpu(), self._base_params
                            if self._base_params is not None
                            else to_jax_params(self._model)[0],
                            self._base_state)
        svc = InferenceService(
            model_i, input_spec=input_spec, name=f"{self.name}/r{ix}",
            start=self._started, fault_injector=self._faults,
            tracer=self.tracer, request_tracing=self._request_tracing,
            priority_fn=self._priority_fn, device=dev, **self._service_kw)
        svc._fault_replica = ix
        health = ReplicaHealth(ix, policy=self._policy,
                               registry=self.registry,
                               recorder=self._flight)
        return svc, health

    # ------------------------------------------------------------ events
    def _instant(self, event: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.instant(event, cat="resilience", **args)

    def _flight_event(self, event: str, trace_id=None, **fields) -> None:
        if self._flight is not None:
            self._flight.record(event, cat="resilience",
                                trace_id=trace_id, model=self.name,
                                **fields)

    # ----------------------------------------------------------- routing
    def _pick(self, route: _Route):
        """(replica_ix, probe?) of the admitted replica with the
        shallowest queue, or None.  Dead replicas found here are
        quarantined + revived on the spot (routing-time liveness — the
        supervisor only watches replicas with inflight work).

        ``admit()`` on a quarantined replica CONSUMES its one probation
        probe slot, so it may only be asked once a replica is actually
        selected — asking every candidate and dispatching one would
        leak ``_probe_inflight`` on the rest and quarantine them
        forever.  Hence two passes: quarantined replicas first (a due
        probe is preferred — re-admission must make progress under
        sustained load; at most ONE admit() call, on the selected
        replica), then least-queue-depth over the healthy rest."""
        now = time.monotonic()
        eligible = []
        for i, svc in enumerate(self._replicas):
            if i in route.tried:
                continue
            if not svc.alive:
                # alive read BEFORE the retired check: retirement marks
                # the slot retired first, THEN stops the service, so a
                # reader seeing alive=False is guaranteed a current
                # retired verdict (an orderly drain is not a death)
                if i not in self._retired:
                    self._on_replica_dead(i)
                continue
            if i in self._retired:
                continue  # retiring: backlog drains, no new routes
            eligible.append((i, svc))
        for i, svc in eligible:
            if self._health[i].state == QUARANTINED:
                if self._health[i].admit(now) == PROBE:
                    return i, True
        candidates = [(svc.queue_depth(), i) for i, svc in eligible
                      if self._health[i].state != QUARANTINED]
        if not candidates:
            return None
        candidates.sort()
        return candidates[0][1], False

    def _shed(self, route: _Route, initial: bool,
              last_overload: Optional[ServiceOverloaded]) -> None:
        """No admissible replica: shed with a retry-after hint — the
        queue drain estimate when queues are the problem, the next
        probation window when health is."""
        self.registry.counter("resilience/sheds").inc()
        self._instant("shed", model=self.name)
        self._flight_event("shed", trace_id=(route.ctx.trace_id
                                             if route.ctx is not None
                                             else None))
        if last_overload is not None:
            retry_ms = last_overload.retry_after_ms
            depth, cap = last_overload.queue_depth, last_overload.capacity
        else:
            waits = [h.next_probe_in() for h in self._health
                     if h.state == "quarantined"]
            retry_ms = round(min(waits) * 1e3, 1) if waits else None
            depth = sum(s.queue_depth() for s in self._replicas)
            cap = sum(s.queue_capacity for s in self._replicas)
        exc = ServiceOverloaded(depth, cap, self.name,
                                retry_after_ms=retry_ms)
        if initial:
            raise exc
        _settle(route.outer, exc=exc)

    def _attempt(self, route: _Route, initial: bool = False) -> None:
        """Submit one attempt.  Runs on the caller thread (initial) or a
        replica batcher/supervisor thread (failover) — everything here
        is lock-cheap, no device work."""
        last_overload: Optional[ServiceOverloaded] = None
        while True:
            if route.outer.done():
                return  # caller cancelled / already settled
            picked = self._pick(route)
            if picked is None:
                if route.last_exc is not None:
                    # every replica was tried and the last one FAILED —
                    # that failure is the diagnosis, not overload: a
                    # deterministic model bug reported as a shed would
                    # send callers into a futile retry-after loop
                    _settle(route.outer, exc=route.last_exc)
                    return
                self._shed(route, initial, last_overload)
                return
            ix, probe = picked
            svc = self._replicas[ix]
            try:
                inner = svc.submit(route.x, deadline=route.deadline,
                                   ctx=route.ctx)
            except ServiceOverloaded as e:
                last_overload = e
                if probe:
                    # the probe never ran — release its slot without an
                    # outcome so the replica stays probe-able
                    self._health[ix].cancel_probe()
                route.tried.add(ix)  # full queue: look elsewhere (not a
                continue             # health failure)
            except ServiceClosed:
                if probe:
                    self._health[ix].cancel_probe()
                self._on_replica_dead(ix)
                route.tried.add(ix)
                continue
            except Exception as e:  # malformed request et al: caller bug
                if probe:
                    # the replica never saw the request — release the
                    # probe without an outcome (a caller bug must not
                    # extend someone else's quarantine)
                    self._health[ix].cancel_probe()
                if initial:
                    raise
                _settle(route.outer, exc=e)
                return
            if route.ctx is not None:
                # the request's hop history: one entry per accepted
                # attempt, outcome stamped in _on_done — a failed-over
                # request reads "r0: ReplicaDeadError → r2: ok".  The
                # flight recorder only sees the RARE path: retry
                # landings (attempt > 1).  First attempts are routine
                # traffic — recording them would put a locked
                # write+flush on every request and evict the rare
                # death/quarantine events from the bounded ring; the
                # original dispatch's replica still reaches the dump
                # on the failover event's hops field.
                route.ctx.add_hop(ix, probe=probe)
                if len(route.ctx.hops) > 1:
                    self._flight_event("request_route",
                                       trace_id=route.ctx.trace_id,
                                       replica=ix, probe=probe,
                                       attempt=len(route.ctx.hops))
            token = next(self._token)
            with self._lock:
                # every entry stored here is popped by exactly one
                # _on_done (late completion, supervisor timeout and
                # stranded-sweep all settle `inner`, which fires the
                # done callback) — the GL303-tracked pairing
                self._inflight[token] = (route, ix, inner, probe)  # acquires: rs_inflight
                self._ensure_supervisor_locked()
                self._wake.notify_all()
            inner.add_done_callback(
                lambda _f, _t=token: self._on_done(_t))
            return

    # -------------------------------------------------------- completion
    def _on_done(self, token) -> None:
        with self._lock:
            entry = self._inflight.pop(token, None)  # releases: rs_inflight
        if entry is None:
            return
        route, ix, inner, probe = entry
        health = self._health[ix]
        if inner.cancelled():
            exc: Optional[BaseException] = ServiceClosed(
                f"replica {ix} cancelled the request")
        else:
            exc = inner.exception()
        if route.ctx is not None and route.ctx.hops:
            # hops are appended one at a time and at most one attempt
            # of a route is in flight, so the last hop is this one
            route.ctx.hops[-1]["outcome"] = (
                "ok" if exc is None else type(exc).__name__)
        if exc is None:
            health.record_success(probe=probe)
            if probe:
                self._instant("readmission_probe_ok", replica=ix)
                self._flight_event("readmission_probe_ok", replica=ix)
            _settle(route.outer, result=inner.result())
            return
        # failure: classify, record, maybe fail over
        if isinstance(exc, ReplicaDeadError):
            pass  # _on_replica_dead already recorded it
        elif isinstance(exc, DeadlineExceeded):
            self.registry.counter("resilience/deadline_timeouts").inc()
            if getattr(exc, "wedged", False):
                # the SUPERVISOR resolved it: the batcher missed its
                # own deadline window — evidence against the replica
                health.record_failure(probe=probe)
            elif probe:
                # the batcher itself refused expired work: the replica
                # is alive and draining, the queue was just long —
                # congestion is not a poison signal (the breaker
                # contract, applied to replica health: a deadline storm
                # under pure overload must not cascade-quarantine the
                # set).  Release the probe without an outcome.
                health.cancel_probe()
        else:
            health.record_failure(probe=probe)
        if probe:
            self._instant("readmission_probe_failed", replica=ix)
        now = time.monotonic()
        out_of_time = route.deadline is not None and now >= route.deadline
        if route.tries_left > 0 and not out_of_time \
                and not route.outer.done():
            route.tries_left -= 1
            route.tried.add(ix)
            route.last_exc = exc  # surfaced if no replica is left
            self.registry.counter("resilience/failovers").inc()
            trace_id = route.ctx.trace_id if route.ctx is not None \
                else None
            self._instant("failover", replica=ix,
                          error=type(exc).__name__,
                          **({"trace_id": trace_id} if trace_id else {}))
            # the hop history rides the failover event, so the dump
            # shows the ORIGINAL dispatch replica without a per-request
            # route event (see _attempt)
            hops = ([f"r{h['replica']}:{h['outcome']}"
                     for h in route.ctx.hops]
                    if route.ctx is not None else None)
            self._flight_event("failover", trace_id=trace_id,
                               replica=ix, error=type(exc).__name__,
                               **({"hops": hops} if hops else {}))
            self._attempt(route)
            return
        _settle(route.outer, exc=exc)

    # -------------------------------------------------------- supervisor
    # guarded-by: _lock
    def _ensure_supervisor_locked(self) -> None:
        if self._supervisor is None or not self._supervisor.is_alive():
            self._supervisor = threading.Thread(
                target=self._supervise, name=f"{self.name}-supervisor",
                daemon=True)
            self._supervisor.start()

    def _supervise(self) -> None:
        """Liveness + stuck-request sweep.  The batcher itself honors
        deadlines for work it actually dispatches; this loop exists for
        the work a batcher can no longer dispatch — dead thread, wedged
        straggler — where only an outside observer can resolve the
        future.  Polling is unavoidable here (a dead thread cannot
        notify); the poll only runs while requests are in flight."""
        grace = self._SUPERVISOR_POLL_S
        while True:
            with self._lock:
                if self._stopped:
                    return
                if not self._inflight:
                    self._wake.wait(timeout=1.0)
                    continue
                entries = list(self._inflight.items())
            now = time.monotonic()
            dead = set()
            for token, (route, ix, inner, probe) in entries:
                if inner.done():
                    continue
                if not self._replicas[ix].alive:
                    if ix in self._retired:
                        # orderly retirement mid-drain (alive read
                        # before retired — see _pick): the stop() in
                        # _retire_replica resolves this backlog, and
                        # sweeps any remainder itself on timeout
                        continue
                    dead.add(ix)
                    _settle(inner, exc=ReplicaDeadError(
                        f"replica {ix} of {self.name!r} died with this "
                        f"request in flight"))
                elif route.deadline is not None \
                        and now >= route.deadline + grace:
                    # expired without the batcher resolving it: settle
                    # from outside.  Tagged `wedged` — evidence against
                    # the replica — ONLY when the batcher has made no
                    # dispatch progress since the deadline passed; a
                    # batcher that is actively draining just has a
                    # queue longer than the deadline (congestion, not
                    # poison — it will refuse this request itself soon,
                    # and under a pure overload storm the supervisor
                    # must not cascade-quarantine healthy replicas)
                    progress = self._replicas[ix].last_progress
                    exc = DeadlineExceeded(
                        f"request deadline exceeded on replica {ix}")
                    exc.wedged = (progress is None
                                  or progress < route.deadline)
                    _settle(inner, exc=exc)
            for ix in dead:
                self._on_replica_dead(ix)
            with self._lock:
                if self._stopped:
                    return
                self._wake.wait(timeout=self._SUPERVISOR_POLL_S)

    def _on_replica_dead(self, ix: int) -> None:
        """Quarantine + revive a replica whose batcher thread died, and
        fail over the requests stranded ON it.  Idempotent per death:
        revive() is a no-op on a running batcher.

        The stranded sweep here is load-bearing, not an optimization:
        a request mid-dispatch at the moment of death is already marked
        RUNNING, so revive's backlog cancellation cannot touch it, and
        the supervisor's liveness poll only catches it while the
        replica still reads as dead — if THIS handler revives first
        (routing-path detection racing the ~20 ms poll), ``svc.alive``
        flips back to True and the supervisor never sees the death,
        stranding the request until its deadline (forever, with none).
        Collecting the victims inside the death lock is exact: the
        replica is quarantined before revive, so no new request can be
        routed to it until its probation window opens."""
        svc = self._replicas[ix]
        stranded: list = []
        with self._death_locks[ix]:
            if svc.alive or self._stopped or ix in self._retired:
                return  # revived already / shutdown / orderly retirement
            self.registry.counter("resilience/replica_deaths").inc()
            self._health[ix].mark_dead()
            self._instant("replica_death", replica=ix)
            self._flight_event("replica_death", replica=ix)
            logger.warning("replica %d of %r died; quarantined, "
                           "reviving", ix, self.name)
            with self._lock:
                stranded = [(route, inner) for (route, ix2, inner, _p)
                            in self._inflight.values() if ix2 == ix]
            try:
                svc.revive()
                self.registry.counter("resilience/revivals").inc()
                self._flight_event("revival", replica=ix)
            except Exception:
                logger.exception("replica %d revive failed; it stays "
                                 "quarantined until the next probe", ix)
        # settle OUTSIDE the death lock: each settle runs _on_done →
        # failover → _pick on this thread, which may legally re-enter
        # this handler for another replica
        self._sweep_stranded(
            ix, f"replica {ix} of {self.name!r} died with this "
                f"request in flight", reason="death",
            stranded=stranded)

    # --------------------------------------------------------------- api
    def submit(self, x, *, timeout: Optional[float] = None,
               ctx=None) -> Future:
        """Route one request (≤ max_batch_size rows).  Returns a Future
        that ALWAYS resolves: result, explicit error, or
        ``ServiceOverloaded``/``DeadlineExceeded``.  ``timeout`` (or the
        set-level ``deadline_ms``) bounds the whole request including
        failovers.

        ``ctx``: optional :class:`~bigdl_tpu_torch.telemetry.RequestContext`
        (minted here when ``request_tracing`` is on) — it accumulates
        the request's hop history across failovers; a caller that keeps
        a reference reads the full routing story after the future
        resolves."""
        if self._stopped:
            raise ServiceClosed(f"replica set {self.name!r} is stopped")
        deadline_s = (timeout if timeout is not None else self.deadline_s)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        if ctx is None and self._request_tracing:
            from bigdl_tpu_torch.telemetry.context import RequestContext
            ctx = RequestContext(deadline=deadline)
        route = _Route(x, Future(), deadline, self.max_retries, ctx=ctx)
        self._attempt(route, initial=True)
        return route.outer

    def predict(self, x, timeout: Optional[float] = None):
        """Blocking sugar over :meth:`submit`."""
        fut = self.submit(x, timeout=timeout)
        # the route deadline already bounds the future when set; the
        # extra result() timeout is a belt against a supervisor gap.
        # Its expiry is normalized to DeadlineExceeded — on py<3.11
        # concurrent.futures.TimeoutError is NOT builtin TimeoutError,
        # and callers must not need to know which timeout fired
        wait = timeout if timeout is not None else None
        try:
            return fut.result(wait)
        except FutureTimeoutError:
            if fut.done():
                # the future RESOLVED with its own timeout-family
                # error (DeadlineExceeded is a TimeoutError, and on
                # py>=3.11 FutureTimeoutError aliases it) — propagate
                # the real diagnosis untouched
                raise
            raise DeadlineExceeded(
                f"request to {self.name!r} still unresolved after a "
                f"{wait:.3f}s result wait" if wait is not None else
                f"request to {self.name!r} never resolved") from None

    @property
    def n_replicas(self) -> int:
        """ACTIVE replica count (retired slots excluded)."""
        return len(self._replicas) - len(self._retired)

    @property
    def total_slots(self) -> int:
        """Slot count including retired ones (index-stable)."""
        return len(self._replicas)

    def active_indices(self) -> List[int]:
        retired = self._retired
        return [i for i in range(len(self._replicas))
                if i not in retired]

    @property
    def max_batch_size(self) -> int:
        """The per-replica coalescing cap (resolved off replica 0 at
        construction and frozen — the wire frontend chunks against
        this)."""
        return self._service_kw["max_batch_size"]

    def replica(self, ix: int) -> InferenceService:
        return self._replicas[ix]

    def health_states(self) -> List[str]:
        return [h.state for h in self._health]

    # ------------------------------------------------------ elasticity
    def _grow_spec(self):
        """Per-row input spec a grown replica warms against: the
        construction-time spec, else the warmed row spec of any live
        replica (deferred-spec sets that have seen traffic), else None
        (the new replica warms on its first request)."""
        if self._input_spec is not None:
            return self._input_spec
        for i in self.active_indices():
            spec = self._replicas[i].row_spec
            if spec is not None:
                return spec
        return None

    def set_replica_count(self, n: int, *,
                          timeout: Optional[float] = None) -> dict:
        """Grow or shrink to ``n`` ACTIVE replicas (the autoscaler's
        actuator; also a manual ops lever).  Serialized — concurrent
        calls queue behind ``_scale_lock``.

        Growing builds each new replica fully warmed (every bucket's
        warmup forward included) BEFORE admitting its slot to routing, so
        scale-up never serves a warmup stall; retired slots are reused
        lowest-first.  Shrinking retires the highest active slot
        through the quarantine discipline: the slot stops receiving new
        routes immediately, its accepted backlog drains to completion
        (``timeout`` bounds the wait), and its model is released.  Returns ``{"active", "added", "retired"}``."""
        n = int(n)
        if n < 1:
            raise ValueError(f"replica count must be >= 1: {n}")
        if self._stopped:
            raise ServiceClosed(
                f"replica set {self.name!r} is stopped")
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        added: List[int] = []
        retired: List[int] = []
        with self._scale_lock:
            while self.n_replicas < n:
                ix = (min(self._retired) if self._retired
                      else len(self._replicas))
                # warm OFF the routing path: nothing below touches
                # shared state until the slot is installed
                svc, h = self._build_replica(ix, self._grow_spec())
                with self._lock:
                    if ix < len(self._replicas):
                        # slot reuse: the retired flag (cleared LAST)
                        # keeps lock-free readers off the slot while
                        # both cells swap
                        self._health[ix] = h
                        self._replicas[ix] = svc
                    else:
                        # append order matters for the lock-free
                        # readers: _replicas is the DISCOVERY list
                        # (_pick enumerates it, then indexes _health /
                        # _death_locks), so the side tables must exist
                        # before the slot becomes discoverable
                        self._health.append(h)
                        self._death_locks.append(threading.Lock())
                        self._replicas.append(svc)
                    self._retired = self._retired - {ix}
                self.registry.counter("resilience/replicas_added").inc()
                self._instant("replica_added", replica=ix)
                self._flight_event("replica_added", replica=ix)
                added.append(ix)
            while self.n_replicas > n:
                ix = max(self.active_indices())
                self._retire_replica(ix, deadline)
                retired.append(ix)
        return {"active": self.n_replicas, "added": added,
                "retired": retired}

    def _retire_replica(self, ix: int,
                        deadline: Optional[float]) -> None:
        """Orderly scale-down of one slot: mark retired (no new routes
        — the same exclusion quarantine gets), drain the accepted
        backlog through the replica's own batcher, then release the
        model.  Any request a wedged batcher leaves stranded past
        the deadline is failed over like a death, so accepted work
        NEVER dangles."""
        svc = self._replicas[ix]
        with self._lock:
            self._retired = self._retired | frozenset((ix,))
        self.registry.counter("resilience/replicas_retired").inc()
        self._instant("replica_retired", replica=ix)
        self._flight_event("replica_retired", replica=ix)
        remaining = (max(0.1, deadline - time.monotonic())
                     if deadline is not None else None)
        svc.stop(drain=True, timeout=remaining)
        # normally stop(drain=True) resolved everything and _on_done
        # already emptied this slot's inflight entries; a wedged
        # batcher that outlived the join timeout leaves stragglers —
        # fail them over (settle → _on_done → retry on a live replica)
        self._sweep_stranded(
            ix, f"replica {ix} of {self.name!r} retired with this "
                f"request still in flight", reason="retired")
        svc.release()

    def _sweep_stranded(self, ix: int, message: str, reason: str,
                        stranded=None) -> None:
        """Fail over every in-flight request still pinned to replica
        ``ix`` — the ONE implementation shared by the death handler and
        the retirement path (each settle runs _on_done → failover on
        this thread).  The death handler passes its own ``stranded``
        list, collected inside the death lock where quarantine blocks
        new routes (the exactness argument in _on_replica_dead); the
        retirement path collects here, after its drain.  Every victim
        lands in the flight recorder as a ``stranded_failover`` so the
        retry is explicable post-mortem."""
        if stranded is None:
            with self._lock:
                stranded = [(route, inner)
                            for (route, ix2, inner, _p)
                            in self._inflight.values() if ix2 == ix]
        for route, inner in stranded:
            if not inner.done():
                if _settle(inner, exc=ReplicaDeadError(message)):
                    trace_id = (route.ctx.trace_id
                                if route.ctx is not None else None)
                    self._flight_event("stranded_failover",
                                       trace_id=trace_id, replica=ix,
                                       reason=reason)

    def health_snapshot(self) -> dict:
        """The ``/healthz`` provider: per-replica liveness + health
        states, ``ok`` iff every ACTIVE replica is alive and
        un-quarantined (retired slots are an orderly state, not an
        incident).  ``active`` is computed FIRST: a concurrent grow
        appending slot N must not make a health probe index past the
        lists it snapshotted (an autoscale event is not a 500)."""
        active = self.active_indices()
        replicas = []
        for i in active:
            svc = self._replicas[i]
            replicas.append({"ix": i, "alive": svc.alive,
                             "state": self._health[i].state,
                             "queue_depth": svc.queue_depth()})
        return {
            "ok": all(r["alive"] and r["state"] != QUARANTINED
                      for r in replicas),
            "model": self.name,
            "replicas": replicas,
            "retired_slots": sorted(self._retired),
        }

    def start(self) -> None:
        self._started = True
        retired = self._retired
        for i, svc in enumerate(self._replicas):
            if i not in retired:
                svc.start()

    def stats(self) -> dict:
        """Set-level snapshot: per-replica service stats + health, the
        resilience counters, and the ``aggregate`` view — summed
        counters, set-level throughput over the UNION of the replicas'
        activity windows, and latency percentiles over the
        concatenated reservoir windows (``ServingMetrics.aggregate``;
        the window-bias audit — NOT replica 0's numbers and NOT a sum
        of per-replica rates with mismatched denominators)."""
        from bigdl_tpu_torch.serving.metrics import ServingMetrics
        active = self.active_indices()
        return {
            "model": self.name,
            "replicas": [
                {"ix": i, "alive": self._replicas[i].alive,
                 "health": self._health[i].snapshot(),
                 **self._replicas[i].stats()}
                for i in active],
            "retired_slots": sorted(self._retired),
            "aggregate": ServingMetrics.aggregate(
                [self._replicas[i].metrics for i in active],
                queue_depth=sum(self._replicas[i].queue_depth()
                                for i in active)),
            "resilience": self.registry.snapshot()["counters"],
        }

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._wake.notify_all()
        for svc in self._replicas:
            svc.stop(drain=drain, timeout=timeout)
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        # deregister from the admin plane: a retired set left behind
        # would report its parked replicas as a permanent /healthz 503
        if self._admin_name is not None:
            from bigdl_tpu_torch.telemetry import admin as _admin
            _srv = _admin.current()
            if _srv is not None:
                _srv.remove_source(self._admin_name)

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)

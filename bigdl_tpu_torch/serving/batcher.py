"""Bounded request queue + coalescing batcher thread.

Port of ``bigdl_tpu/serving/batcher.py`` (stdlib only, an owned copy).
Reference: BigDL 2.0 Cluster Serving's Flink pipeline pops *batches* of
queued requests off Redis streams so one forward serves many callers
(arXiv:2204.01715 §3.2); TensorFlow-Serving calls the same idea dynamic
batching.  Here a single batcher thread owns the device dispatch,
coalescing whatever concurrent callers have enqueued — up to
``max_batch_size`` rows, waiting at most ``batch_timeout_ms`` after the
first request — into ONE bucket-padded forward.

Design rules:

- **Bounded queue = explicit backpressure.**  ``put`` never blocks and
  never grows unboundedly: a full queue raises
  :class:`ServiceOverloaded` (carrying the observed depth) so the edge
  can shed load / retry with jitter instead of silently queueing into
  timeout territory.
- **Event-driven.**  One ``Condition`` covers producers and the batcher;
  there are no polling sleeps anywhere (tests rely on this — they pause
  and resume the batcher deterministically).
- **Drain-then-stop shutdown.**  ``close(drain=True)`` refuses new work
  but the batcher keeps dispatching until the queue is empty, so every
  accepted future resolves; ``drain=False`` cancels what is still
  queued.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence


class ServiceOverloaded(RuntimeError):
    """Bounded request queue is full — shed load upstream.

    Carries ``queue_depth`` / ``capacity`` so callers (and error pages)
    can report how far behind the service is, and ``retry_after_ms`` —
    an estimate (from the batcher's observed queue drain rate) of when
    the queue will have room again, so shed callers can back off a
    useful amount instead of guessing.  ``None`` when the batcher has
    not dispatched anything yet.
    """

    def __init__(self, queue_depth: int, capacity: int, model: str = "",
                 retry_after_ms: Optional[float] = None):
        self.queue_depth = queue_depth
        self.capacity = capacity
        self.model = model
        self.retry_after_ms = retry_after_ms
        tag = f" model={model!r}" if model else ""
        hint = (f"; retry_after_ms={retry_after_ms:.1f}"
                if retry_after_ms is not None else "")
        super().__init__(
            f"serving queue full{tag}: depth={queue_depth} "
            f"capacity={capacity}{hint} — backpressure; retry with "
            f"backoff or raise queue_capacity")


class ServiceClosed(RuntimeError):
    """submit() after close() — the service no longer accepts work."""


class RequestSpecError(ValueError):
    """The REQUEST's shape is wrong: it does not conform to the
    deployed ``input_spec`` (tree structure / trailing-shape mismatch)
    or exceeds ``max_batch_size``.  Raised synchronously by ``submit``
    so a malformed request fails alone instead of poisoning the batch
    it would have coalesced into.  Subclasses ``ValueError`` for
    backward compatibility; the distinct type lets callers (the wire
    frontend's 400 mapping) tell caller-fault validation apart from an
    internal ``ValueError``, which stays a server-side bug."""


def settle_future(fut: Future, *, result=None,
                  exc: Optional[BaseException] = None) -> bool:
    """Resolve a request future, tolerating the race where someone
    else got there first (a late batcher completion vs. the ReplicaSet
    supervisor timing out or failing over the same request).  Returns
    whether THIS call settled it — callers gate their per-request
    accounting on that, so a request served after being failed over is
    not double-counted.  The ONE such helper; service.py and
    resilience/replica_set.py both use it."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except Exception:  # InvalidStateError: already resolved — benign
        return False


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before (or while) it could be
    served.  Set on the request's future by the dispatch path (expired
    work is refused before the device call) or by an outside supervisor
    (work stuck on a dead/wedged replica).  Inference is idempotent, so
    a router may retry the same request elsewhere."""


class _Request:
    """One enqueued inference request: a pytree of np arrays with a
    shared leading row dim ``n_rows`` (≤ max_batch_size, enforced by the
    service) plus the future the caller is waiting on.  ``deadline``
    (monotonic seconds, or None) travels WITH the request through the
    queue — the dispatch path refuses expired work.  ``ctx`` is the
    optional :class:`~bigdl_tpu_torch.telemetry.context.RequestContext`
    (trace_id / tenant / hop history) riding the same journey — None
    (the default) is the provably-inert state."""

    __slots__ = ("x", "n_rows", "future", "t_enqueue", "deadline", "ctx")

    def __init__(self, x, n_rows: int, deadline: Optional[float] = None,
                 ctx=None):
        self.x = x
        self.n_rows = n_rows
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        self.deadline = deadline
        self.ctx = ctx


class RequestBatcher:
    """The queue and the thread that drains it.

    ``dispatch_fn(requests)`` — supplied by
    :class:`~bigdl_tpu_torch.serving.InferenceService` — performs the coalesced
    device call and resolves each request's future.  The batcher
    guarantees: each accepted request is handed to ``dispatch_fn``
    exactly once (or cancelled on non-drain shutdown), coalesced groups
    never exceed ``max_batch_size`` total rows, and after the first
    request of a group arrives the group waits at most
    ``batch_timeout_ms`` before dispatch.

    ``batch_timeout_ms=0`` is *adaptive* batching: a group is whatever
    is ALREADY queued when the batcher comes around (the previous
    dispatch's latency is the natural coalescing window) — lone
    sequential callers dispatch immediately instead of eating the
    timeout, while concurrent load still coalesces.  The
    ``PredictionService`` shim runs in this mode to preserve its
    historical immediate-dispatch latency.

    ``priority_fn`` is the QoS preemption hook (the frontend's
    per-tenant admission layer supplies it): a callable mapping an
    enqueued :class:`_Request` to an int rank (lower dispatches
    first).  It engages ONLY under pressure — when the queued rows
    exceed what one ``max_batch_size`` dispatch can carry — because
    under light load every queued request rides the same coalesced
    group anyway and FIFO order costs nothing.  Under pressure the
    collect loop picks the best-(effective rank, arrival) request
    that still fits, so latency-class tenants preempt batch-class
    backlog; equal ranks stay FIFO.  Starvation is BOUNDED by aging:
    a queued request's effective rank improves by one class per
    ``priority_aging_ms`` waited, so sustained latency-class
    saturation delays batch work by at most ~one aging period per
    class gap instead of indefinitely.  ``None`` (the default) is
    byte-identical to the pre-hook batcher.
    """

    def __init__(self, dispatch_fn: Callable[[List[_Request]], None],
                 *, max_batch_size: int, batch_timeout_ms: float,
                 queue_capacity: int, name: str = "serving",
                 priority_fn: Optional[Callable[["_Request"], int]] = None,
                 priority_aging_ms: float = 500.0):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1: {queue_capacity}")
        self._dispatch_fn = dispatch_fn
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self._name = name
        self._priority_fn = priority_fn
        self._priority_aging_s = max(1e-3, priority_aging_ms / 1e3)

        self._cond = threading.Condition()
        self._q: deque[_Request] = deque()  # guarded-by: _cond
        # running total of queued ROWS — kept in lockstep with _q so
        # the QoS pressure test is O(1) per pop instead of re-summing
        # the deque (O(queue_len) per pop is quadratic per dispatch
        # exactly when the queue is full); guarded-by: _cond.  Every
        # inc/dec is `# acquires:`/`# releases:`-tagged so GL303 keeps
        # the pairing checkable (a pop path that forgets the decrement
        # desynchronizes the QoS pressure signal forever).
        self._q_rows = 0
        self._closed = False                # guarded-by: _cond
        self._drain = True                  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self.cancelled_rows = 0
        # EWMA of seconds-per-request through dispatch, written only by
        # the batcher thread (reads are racy-by-design: a hint, not an
        # invariant) — feeds ServiceOverloaded.retry_after_ms
        self._spr_ewma: Optional[float] = None
        # monotonic time of the last completed dispatch (or start()) —
        # the liveness signal an outside supervisor uses to tell a
        # WEDGED batcher (no progress) from a congested one (draining,
        # just slower than the deadline).  Racy-by-design single write.
        self.last_progress: Optional[float] = None

    # -- producer side -----------------------------------------------------
    def retry_after_ms(self, depth: Optional[int] = None) -> Optional[float]:
        """How long (ms) until the current backlog should have drained,
        from the observed dispatch rate.  None before the first
        dispatch (no rate to estimate from)."""
        spr = self._spr_ewma
        if spr is None:
            return None
        if depth is None:
            # racy-by-design depth sample: a retry hint, not an
            # invariant (put() passes the locked depth in)
            depth = len(self._q)  # graftlint: disable=GL201
        return round(min(max(depth * spr * 1e3, 1.0), 10_000.0), 1)

    def _note_dispatch(self, n_requests: int, elapsed_s: float) -> None:
        spr = elapsed_s / max(1, n_requests)
        prev = self._spr_ewma
        self._spr_ewma = spr if prev is None else 0.7 * prev + 0.3 * spr
        self.last_progress = time.monotonic()

    def put(self, req: _Request) -> None:
        with self._cond:
            if self._closed:
                raise ServiceClosed(
                    f"serving endpoint {self._name!r} is stopped")
            if len(self._q) >= self.queue_capacity:
                depth = len(self._q)
                raise ServiceOverloaded(
                    depth, self.queue_capacity, self._name,
                    retry_after_ms=self.retry_after_ms(depth))
            self._q.append(req)
            self._q_rows += req.n_rows  # acquires: queue_rows
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Idempotent; tests construct services with ``start=False`` to
        stage a queue deterministically before the first dispatch.
        Concurrent callers must hold the service lifecycle lock (they
        do: InferenceService.start/revive)."""
        if self._thread is None:
            # pre-start write: Thread.start() is the happens-before
            # edge, so the batcher thread observes it without a lock
            self.last_progress = time.monotonic()  # graftlint: disable=GL201
            thread = threading.Thread(
                target=self._run, name=f"{self._name}-batcher", daemon=True)
            thread.start()
            # published only AFTER start(): a created-but-unstarted
            # thread reads as is_alive()=False, and an outside liveness
            # poll (the ReplicaSet supervisor) hitting that microsecond
            # window would misread a healthy parked replica as DEAD and
            # fail over its whole queue (caught by the elasticity tests
            # staging parked sets under a live supervisor)
            self._thread = thread

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def dead(self) -> bool:
        """The batcher thread was started and has DIED without
        ``close()`` — a crashed dispatch (or an injected
        ``ReplicaDeathFault``) took it down, so queued work can no
        longer dispatch.  Distinct from ``running=False`` before
        ``start()`` (a parked batcher can still be started) and from a
        closed batcher (an orderly stop is not a death).  This is the
        liveness the ``ReplicaSet`` supervisor polls."""
        # lock-free liveness sample BY DESIGN: the supervisor polls this
        # from outside; a stale read just delays detection one poll
        return (self._thread is not None
                and not self._thread.is_alive()
                and not self._closed)  # graftlint: disable=GL201

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> int:
        """Refuse new work; drain (default) or cancel the backlog; join
        the batcher thread.  Safe to call twice, and safe to call on a
        never-started batcher (the backlog is then resolved inline).
        Returns the number of ROWS cancelled (0 when draining)."""
        with self._cond:
            was_dead = self.dead
            self._closed = True
            self._drain = drain
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if was_dead or not self._thread.is_alive():
                # a CRASHED batcher can neither drain nor cancel its
                # own backlog, and inline-dispatching on the caller's
                # thread could re-raise whatever killed it — cancel the
                # remainder so no accepted future is left dangling
                # (no-op after an orderly drain: the queue is empty)
                self._cancel_backlog()
            return self.cancelled_rows
        # batcher never ran: resolve the backlog on the caller's
        # thread so no accepted future is left dangling
        if drain:
            self._drain_inline()
            return 0
        return self._cancel_backlog()

    def _cancel_backlog(self) -> int:
        rows = 0
        while True:
            with self._cond:
                if not self._q:
                    self.cancelled_rows += rows
                    return rows
                req = self._q.popleft()
                self._q_rows -= req.n_rows  # releases: queue_rows
            if req.future.cancel():
                rows += req.n_rows

    def _drain_inline(self) -> None:
        while True:
            batch = self._collect(block=False)
            if not batch:
                return
            self._dispatch_fn(batch)

    def _dispatch_timed(self, batch: List[_Request]) -> None:
        t0 = time.monotonic()
        try:
            self._dispatch_fn(batch)
        finally:
            self._note_dispatch(len(batch), time.monotonic() - t0)

    # -- batcher thread ----------------------------------------------------
    def _run(self) -> None:
        drain = True
        while True:
            batch = self._collect(block=True)
            if batch:
                self._dispatch_timed(batch)
                continue
            # empty collect while blocking only happens when closed
            with self._cond:
                if self._closed and (not self._drain or not self._q):
                    drain = self._drain  # captured under the lock
                    break
        if not drain:
            self._cancel_backlog()

    # guarded-by: _cond
    def _rank_locked(self, req: _Request, now: float) -> int:
        """Effective QoS rank of one queued request: the declared rank
        minus one class per aging period waited (the starvation bound
        — a batch-class request that has queued ``priority_aging_ms``
        competes as latency class).  A broken priority_fn ranks as 0
        (most urgent) instead of killing the batcher thread."""
        try:
            rank = int(self._priority_fn(req))
        except Exception:
            return 0
        return rank - int((now - req.t_enqueue)
                          / self._priority_aging_s)

    # guarded-by: _cond
    def _pop_next_locked(self, rows: int) -> Optional[_Request]:
        """Pop the next request for the current group, or None when the
        candidate doesn't fit under ``max_batch_size``.  FIFO
        (head-or-nothing — the historical contract) except under QoS
        pressure: with a ``priority_fn`` set AND more rows queued than
        one dispatch can carry, the best-(rank, arrival) request that
        still fits is taken instead, so latency-class tenants preempt
        batch backlog exactly when ordering starts to matter."""
        if not self._q:
            return None
        pressure = (self._priority_fn is not None and len(self._q) > 1
                    and rows + self._q_rows > self.max_batch_size)
        if not pressure:
            if self._q[0].n_rows + rows > self.max_batch_size:
                return None
            req = self._q.popleft()
            self._q_rows -= req.n_rows  # releases: queue_rows
            return req
        best_i, best_key = -1, None
        now = time.monotonic()
        for i, r in enumerate(self._q):
            if r.n_rows + rows > self.max_batch_size:
                continue
            # arrival ix = FIFO tie-break within an effective rank
            key = (self._rank_locked(r, now), i)
            if best_key is None or key < best_key:
                best_key, best_i = key, i
        if best_i < 0:
            return None  # nothing queued fits in the remaining rows
        req = self._q[best_i]
        del self._q[best_i]
        self._q_rows -= req.n_rows  # releases: queue_rows
        return req

    def _collect(self, block: bool) -> List[_Request]:
        """Pop one coalescible group: wait (if ``block``) for the first
        request, then keep taking requests that fit under
        ``max_batch_size`` rows until the timeout since the first pop
        expires or the next candidate doesn't fit."""
        batch: List[_Request] = []
        rows = 0
        with self._cond:
            while block and not self._q and not self._closed:
                self._cond.wait()
            if self._closed and not self._drain:
                return batch  # backlog is _run's to CANCEL, not pop
            first = self._pop_next_locked(0)
            if first is None:
                return batch
            batch.append(first)
            rows = first.n_rows
            deadline = time.monotonic() + self.batch_timeout_s
            while rows < self.max_batch_size:
                nxt = self._pop_next_locked(rows)
                if nxt is not None:
                    batch.append(nxt)
                    rows += nxt.n_rows
                    continue
                if self._q:
                    break  # queued work doesn't fit this group
                if self._closed:
                    break  # draining: don't wait for traffic that won't come
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
        return batch

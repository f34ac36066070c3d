"""Bounded request queue + coalescing batcher thread.

Port of ``bigdl_tpu/serving/batcher.py`` (stdlib only, an owned copy cut
to what this slice's service uses: FIFO coalescing; the QoS priority hook
and per-request deadlines come back with the front end and the replica
set).  Reference: BigDL 2.0 Cluster Serving's Flink pipeline pops
*batches* of queued requests off Redis streams so one forward serves many
callers (arXiv:2204.01715 §3.2); TensorFlow-Serving calls the same idea
dynamic batching.  Here a single batcher thread owns the device dispatch,
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
from typing import Callable, List, Optional


class ServiceOverloaded(RuntimeError):
    """Bounded request queue is full — shed load upstream.

    Carries ``queue_depth`` / ``capacity`` so callers (and error pages)
    can report how far behind the service is, and ``retry_after_ms`` —
    an estimate (from the batcher's observed queue drain rate) of when
    the queue will have room again.  ``None`` when the batcher has not
    dispatched anything yet.
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
    """The REQUEST's shape is wrong: it does not conform to the deployed
    ``input_spec`` (tree structure / trailing-shape mismatch) or exceeds
    ``max_batch_size``.  Raised synchronously by ``submit`` so a malformed
    request fails alone instead of poisoning the batch it would have
    coalesced into."""


def settle_future(fut: Future, *, result=None,
                  exc: Optional[BaseException] = None) -> bool:
    """Resolve a request future, tolerating the race where someone else
    got there first.  Returns whether THIS call settled it — callers gate
    their per-request accounting on that."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except Exception:  # InvalidStateError: already resolved — benign
        return False


class _Request:
    """One enqueued inference request: a pytree of np arrays with a
    shared leading row dim ``n_rows`` (≤ max_batch_size, enforced by the
    service) plus the future the caller is waiting on."""

    __slots__ = ("x", "n_rows", "future", "t_enqueue", "ctx")

    def __init__(self, x, n_rows: int, ctx=None):
        self.x = x
        self.n_rows = n_rows
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()
        # optional telemetry.RequestContext (None unless request tracing
        # is on or the caller passed one)
        self.ctx = ctx


class RequestBatcher:
    """The queue and the thread that drains it.

    ``dispatch_fn(requests)`` — supplied by
    :class:`~bigdl_tpu_torch.serving.InferenceService` — performs the
    coalesced device call and resolves each request's future.  The
    batcher guarantees: each accepted request is handed to
    ``dispatch_fn`` exactly once (or cancelled on non-drain shutdown),
    coalesced groups never exceed ``max_batch_size`` total rows, and
    after the first request of a group arrives the group waits at most
    ``batch_timeout_ms`` before dispatch.

    ``batch_timeout_ms=0`` is *adaptive* batching: a group is whatever
    is ALREADY queued when the batcher comes around (the previous
    dispatch's latency is the natural coalescing window) — lone
    sequential callers dispatch immediately instead of eating the
    timeout, while concurrent load still coalesces.
    """

    def __init__(self, dispatch_fn: Callable[[List[_Request]], None],
                 *, max_batch_size: int, batch_timeout_ms: float,
                 queue_capacity: int, name: str = "serving"):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
        if queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1: {queue_capacity}")
        self._dispatch_fn = dispatch_fn
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.queue_capacity = int(queue_capacity)
        self._name = name

        self._cond = threading.Condition()
        self._q: deque[_Request] = deque()  # guarded-by: _cond
        self._closed = False                # guarded-by: _cond
        self._drain = True                  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        self.cancelled_rows = 0
        # EWMA of seconds-per-request through dispatch, written only by
        # the batcher thread (reads are racy-by-design: a hint, not an
        # invariant) — feeds ServiceOverloaded.retry_after_ms
        self._spr_ewma: Optional[float] = None

    # -- producer side -----------------------------------------------------
    def retry_after_ms(self, depth: int) -> Optional[float]:
        """How long (ms) until a backlog of ``depth`` requests should have
        drained, from the observed dispatch rate.  None before the first
        dispatch (no rate to estimate from)."""
        spr = self._spr_ewma
        if spr is None:
            return None
        return round(min(max(depth * spr * 1e3, 1.0), 10_000.0), 1)

    def _note_dispatch(self, n_requests: int, elapsed_s: float) -> None:
        spr = elapsed_s / max(1, n_requests)
        prev = self._spr_ewma
        self._spr_ewma = spr if prev is None else 0.7 * prev + 0.3 * spr

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
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Idempotent; tests construct services with ``start=False`` to
        stage a queue deterministically before the first dispatch.
        Concurrent callers must hold the service lifecycle lock."""
        if self._thread is None:
            thread = threading.Thread(
                target=self._run, name=f"{self._name}-batcher", daemon=True)
            thread.start()
            # published only AFTER start(): a created-but-unstarted thread
            # reads as is_alive()=False and would look dead
            self._thread = thread

    @property
    def dead(self) -> bool:
        """The batcher thread was started and has DIED without
        ``close()`` — a crashed dispatch took it down, so queued work can
        no longer dispatch.  Distinct from a parked (never started) or a
        closed batcher."""
        # lock-free liveness sample BY DESIGN: a stale read just delays
        # detection one poll
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
                # a CRASHED batcher can neither drain nor cancel its own
                # backlog — cancel the remainder so no accepted future is
                # left dangling (no-op after an orderly drain)
                self._cancel_backlog()
            return self.cancelled_rows
        # batcher never ran: resolve the backlog on the caller's thread
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

    def _collect(self, block: bool) -> List[_Request]:
        """Pop one coalescible group, FIFO: wait (if ``block``) for the
        first request, then keep taking the head while it fits under
        ``max_batch_size`` rows, until the timeout since the first pop
        expires."""
        batch: List[_Request] = []
        with self._cond:
            while block and not self._q and not self._closed:
                self._cond.wait()
            if self._closed and not self._drain:
                return batch  # backlog is _run's to CANCEL, not pop
            if not self._q:
                return batch
            batch.append(self._q.popleft())
            rows = batch[0].n_rows
            deadline = time.monotonic() + self.batch_timeout_s
            while rows < self.max_batch_size:
                if self._q:
                    if self._q[0].n_rows + rows > self.max_batch_size:
                        break  # queued work doesn't fit this group
                    nxt = self._q.popleft()
                    batch.append(nxt)
                    rows += nxt.n_rows
                    continue
                if self._closed:
                    break  # draining: don't wait for traffic that won't come
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
        return batch

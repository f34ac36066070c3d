"""InferenceService — dynamic batching over one model on one device.

Port of ``bigdl_tpu/serving/service.py``.  The serving contract:

- **Warm every row bucket at deploy time.**  Coalesced batches are padded
  up to the nearest power-of-two row bucket, and one forward per bucket
  runs on zeros before traffic is taken (on the card this also builds the
  kernels and sizes the caching allocator).  ``compile_count`` counts
  those warmup forwards and never moves afterwards.  The same warmup
  checks that output rows follow input rows (probes at 1 and 2 rows), so
  per-request slicing cannot return another caller's rows.
- **Zero padding, sliced off.**  Padded rows are zeros: in eval mode the
  forward is row-independent (BatchNorm uses running stats), so pad rows
  cannot leak into real ones.
- **Futures in, backpressure out.**  ``submit`` returns a
  ``concurrent.futures.Future``; a full bounded queue raises
  ``ServiceOverloaded``.  ``predict`` is the blocking sugar and chunks
  oversized inputs.

Inputs and outputs are numpy arrays, or tuples/lists/dicts of them.  The
model runs on ``device`` ("cuda" by default; "cpu" only when asked).

Observability and chaos, as in the reference, each inert when off: a
``tracer`` with ``request_tracing`` records a submit span per request and
one dispatch span per coalesced batch, with a flow arrow from each
request into its dispatch; a ``fault_injector`` is consulted once per
dispatch (an injected error fails that batch's requests, a replica death
kills the batcher thread, which :meth:`InferenceService.revive` brings
back); the admin plane (``Config.admin_port``) serves the metrics.  A
lone service's fault clauses see ``replica=None``; a
:class:`~bigdl_tpu_torch.resilience.ReplicaSet` stamps each replica's
index.  ``submit(deadline=)`` carries a monotonic deadline with the
request: the dispatch refuses expired work with ``DeadlineExceeded``
before the device call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.engine import resolve_device
from bigdl_tpu_torch.serving.batcher import (
    DeadlineExceeded, RequestBatcher, RequestSpecError, ServiceClosed,
    ServiceOverloaded, _Request, settle_future,
)
from bigdl_tpu_torch.serving.metrics import ServingMetrics


# -- pytrees of arrays (tuple / list / dict containers, anything else a leaf)
def _flatten(x, is_leaf=None):
    if is_leaf is not None and is_leaf(x):
        return [x], None
    if isinstance(x, (tuple, list)):
        leaves, defs = [], []
        for e in x:
            sub, d = _flatten(e, is_leaf)
            leaves += sub
            defs.append(d)
        return leaves, (type(x), tuple(defs))
    if isinstance(x, dict):
        keys = sorted(x)
        leaves, defs = [], []
        for k in keys:
            sub, d = _flatten(x[k], is_leaf)
            leaves += sub
            defs.append(d)
        return leaves, (dict, tuple(keys), tuple(defs))
    return [x], None


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        if d[0] is dict:
            return {k: build(s) for k, s in zip(d[1], d[2])}
        return d[0](build(s) for s in d[1])

    return build(treedef)


def _tree_map(fn, *trees, is_leaf=None):
    flat = [_flatten(t, is_leaf) for t in trees]
    return _unflatten(flat[0][1],
                      [fn(*ls) for ls in zip(*(f[0] for f in flat))])


@dataclasses.dataclass(frozen=True)
class RowSpec:
    """Shape (no batch dim) and numpy dtype of one leaf of a request row."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def row_buckets(max_batch_size: int, floor: int = 1) -> Tuple[int, ...]:
    """Power-of-two row buckets up to ``max_batch_size`` (inclusive — a
    non-power-of-two max becomes the top bucket so a full coalesced batch
    never spills into two dispatches), starting at ``floor``."""
    bs = []
    b = max(1, int(floor))
    while b < max_batch_size:
        bs.append(b)
        b *= 2
    bs.append(max_batch_size)
    return tuple(bs)


def parse_row_buckets(spec: str, max_batch_size: int) -> Tuple[int, ...]:
    """Parse a ``Config.serving_row_buckets`` bucket-set spec:

    - ``""`` / ``"pow2"`` — :func:`row_buckets` power-of-two auto (the
      default);
    - ``"top"`` — one bucket at ``max_batch_size``;
    - ``"pow2@16"`` — power-of-two ladder floored at 16;
    - ``"8,16,32"`` — explicit ascending positive ints whose top must
      cover ``max_batch_size``.
    """
    s = (spec or "").strip()
    if s in ("", "pow2"):
        return row_buckets(max_batch_size)
    if s == "top":
        return (max_batch_size,)
    if s.startswith("pow2@"):
        try:
            floor = int(s[5:])
        except ValueError:
            raise ValueError(
                f"bucket spec {spec!r}: pow2@<floor> needs an int "
                f"floor") from None
        if floor < 1:
            raise ValueError(f"bucket floor must be >= 1: {floor}")
        return row_buckets(max_batch_size, floor)
    try:
        buckets = tuple(int(tok) for tok in s.split(","))
    except ValueError:
        raise ValueError(
            f"row-bucket spec {spec!r} must be '', 'pow2', 'top' or a "
            f"comma-separated int list") from None
    if (not buckets or any(b < 1 for b in buckets)
            or list(buckets) != sorted(set(buckets))):
        raise ValueError(
            f"row buckets {buckets} must be ascending unique positive "
            f"ints")
    if buckets[-1] < max_batch_size:
        raise ValueError(
            f"top row bucket {buckets[-1]} < max_batch_size "
            f"{max_batch_size} — a full coalesced batch would have no "
            f"bucket to pad into")
    return buckets


def leading_rows(x) -> int:
    """The shared leading (row) dim of every leaf of ``x``; raises
    :class:`RequestSpecError` (the request's fault) otherwise."""
    leaves, _ = _flatten(x)
    if not leaves:
        raise RequestSpecError("empty input pytree")
    n = leaves[0].shape[0] if leaves[0].ndim else None
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != n:
            raise RequestSpecError(
                "all input leaves must share one leading batch dim; got "
                f"shapes {[leaf.shape for leaf in leaves]}")
    return n


def pad_rows(x, target: int):
    """Zero-pad every leaf's leading dim up to ``target`` rows."""

    def pad(leaf):
        n = leaf.shape[0]
        if n == target:
            return leaf
        widths = [(0, target - n)] + [(0, 0)] * (leaf.ndim - 1)
        return np.pad(leaf, widths)

    return _tree_map(pad, x)


def device_scope(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op: the
    current device of the calling thread (batcher, supervisor and decode
    threads alike) becomes the service's."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _weights_dtype(model: torch.nn.Module) -> str:
    from bigdl_tpu_torch.nn.quantized import is_quantized
    if is_quantized(model):
        return "int8"
    if any(p.dtype == torch.bfloat16 for p in model.parameters()):
        return "bf16"
    return "f32"


class InferenceService:
    """Always-on inference endpoint for one model.

    Parameters
    ----------
    model:
        A ``torch.nn.Module`` (including the ``nn.quantized`` int8 twins).
        It is moved to ``device`` and switched to eval mode in place; a
        model placed on a model device group (``parallel.shard_module``)
        stays where it lies, ``device`` being the group's home.
    input_spec:
        Pytree of per-ROW ``(shape, dtype)`` pairs (no batch dim) — or
        numpy arrays — describing one request row.  When given, every
        bucket is warmed at construction; when ``None``, the spec is
        captured from the first request and warmup happens then.
    max_batch_size / batch_timeout_ms / queue_capacity / buckets:
        Coalescing and backpressure knobs; ``None`` resolves from
        ``Engine.serving_defaults()``.  ``buckets`` is an explicit
        ascending int tuple or a :func:`parse_row_buckets` spec string.
    start:
        ``start=False`` parks the batcher — requests queue (bounded) until
        :meth:`start`.  Used by tests to stage deterministic coalescing.
    device:
        Where the model runs: ``"cuda"`` (the default) or ``"cpu"``.
    fault_injector:
        Optional :class:`~bigdl_tpu_torch.resilience.faults.FaultInjector`
        consulted once per coalesced dispatch, keyed by this service's own
        dispatch counter.  ``None`` (the default): the dispatch path never
        touches it.
    tracer / request_tracing:
        An optional :class:`~bigdl_tpu_torch.telemetry.Tracer` for the
        submit and dispatch spans; ``request_tracing`` (None =
        ``Config.request_tracing``) mints a ``RequestContext`` per submit
        when none is passed.  Off, no context is ever allocated.
    priority_fn:
        Optional QoS preemption hook handed to the batcher: maps a queued
        request (it carries ``.ctx`` with the tenant tag) to an int rank,
        lower dispatching first, engaged only when the queue holds more
        rows than one dispatch carries.  The front end's
        :class:`~bigdl_tpu_torch.frontend.QosAdmission` supplies it.
    """

    def __init__(self, model: torch.nn.Module, *, input_spec=None,
                 max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 queue_capacity: Optional[int] = None, buckets=None,
                 name: str = "model", start: bool = True, device="cuda",
                 fault_injector=None, tracer=None,
                 request_tracing: Optional[bool] = None,
                 priority_fn=None):
        from bigdl_tpu_torch.engine import Engine
        defaults = Engine.serving_defaults()
        from bigdl_tpu_torch.parallel.tensor_parallel import placed_devices
        self.device = resolve_device(device)
        if placed_devices(model) is None:
            model = model.to(self.device)
        self.model = model.eval()
        self.name = name
        # `is not None` throughout: an explicit 0 must reach the
        # batcher's >= 1 validation, not silently become the default
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else defaults["max_batch_size"])
        self.batch_timeout_ms = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else defaults["batch_timeout_ms"])
        self.queue_capacity = int(
            queue_capacity if queue_capacity is not None
            else defaults["queue_capacity"])
        if buckets is None:
            buckets = defaults["row_buckets"]
        if not isinstance(buckets, str):
            # an explicit tuple takes the same validation path
            buckets = ",".join(str(int(b)) for b in buckets)
        self.buckets = parse_row_buckets(buckets, self.max_batch_size)

        self._warm_forwards = 0
        self._warm_lock = threading.Lock()
        # warmup state: written only under _warm_lock; hot-path reads are
        # lock-free and gated on _warmed flipping LAST
        self._warmed = False                 # write-guarded-by: _warm_lock
        self._row_spec = None                # write-guarded-by: _warm_lock
        self._out_spec = None                # write-guarded-by: _warm_lock
        # serializes start() against stop()
        self._lifecycle_lock = threading.Lock()
        self._stopped = False  # write-guarded-by: _lifecycle_lock
        self.metrics = ServingMetrics()
        self.weights_dtype = _weights_dtype(self.model)
        self.metrics.set_weights_dtype(self.weights_dtype)
        # fault injection: consulted per dispatch; _fault_replica is the
        # replica a set would stamp (None for a lone service)
        self._faults = fault_injector
        self._fault_replica: Optional[int] = None
        self._dispatch_index = 0
        self._priority_fn = priority_fn
        # request-scoped observability, resolved once here: the hot
        # paths only test these attributes
        self.tracer = tracer
        if request_tracing is None:
            from bigdl_tpu_torch.utils.config import get_config
            request_tracing = get_config().request_tracing
        self._request_tracing = bool(request_tracing)
        # admin plane: started per Config.admin_port (0: none), this
        # service's registry (and tracer) under a name minted unique
        from bigdl_tpu_torch.telemetry import admin as _admin
        self._admin_name: Optional[str] = None
        srv = _admin.maybe_start()
        if srv is not None:
            self._admin_name = srv.unique_source_name(self.name)
            srv.add_registry(self._admin_name, self.metrics.registry)
            if self.tracer is not None:
                srv.add_tracer(self._admin_name, self.tracer)
        # the batcher and its finalizer are swapped by revive() and
        # retired by stop(), both under the lifecycle lock
        self._batcher = self._make_batcher()  # write-guarded-by: _lifecycle_lock
        # a dropped service must not strand its batcher thread
        # write-guarded-by: _lifecycle_lock
        self._finalizer = weakref.finalize(
            self, RequestBatcher.close, self._batcher, True, 5.0)
        if input_spec is not None:
            self.warmup(input_spec)
        if start:
            self._batcher.start()

    def _make_batcher(self) -> RequestBatcher:
        # the RUNNING thread must not pin the service, or the finalizer
        # could never fire: it gets a WeakMethod shim instead of the bound
        # `self._dispatch`
        weak_dispatch = weakref.WeakMethod(self._dispatch)

        def dispatch(requests):
            fn = weak_dispatch()
            if fn is None:  # service collected: nothing can resolve these
                for r in requests:
                    r.future.cancel()
                return
            fn(requests)

        return RequestBatcher(
            dispatch, max_batch_size=self.max_batch_size,
            batch_timeout_ms=self.batch_timeout_ms,
            queue_capacity=self.queue_capacity, name=self.name,
            priority_fn=self._priority_fn)

    # -- forward -----------------------------------------------------------
    def _forward(self, x):
        """One forward of a padded batch (pytree of numpy arrays) on the
        device; returns numpy outputs (the copy back synchronizes).  The
        device is named on this thread too, so every launch from a
        batcher thread lands on the service's card."""
        with torch.inference_mode(), device_scope(self.device):
            xt = _tree_map(lambda a: torch.tensor(a, device=self.device), x)
            out = self.model(xt)
            return _tree_map(lambda t: t.cpu().numpy(), out)

    # -- warmup ------------------------------------------------------------
    @staticmethod
    def _normalize_row_spec(input_spec):
        # a (shape, dtype) pair is a LEAF only when shape is a flat
        # tuple/list of ints
        def is_pair(x):
            return (isinstance(x, tuple) and len(x) == 2
                    and isinstance(x[0], (tuple, list))
                    and all(isinstance(d, (int, np.integer))
                            for d in x[0]))

        def norm(leaf):
            if isinstance(leaf, RowSpec):
                return leaf
            if is_pair(leaf):
                return RowSpec(tuple(int(d) for d in leaf[0]),
                               _np_dtype(leaf[1]))
            arr = np.asarray(leaf)
            return RowSpec(arr.shape, arr.dtype)

        return _tree_map(norm, input_spec, is_leaf=is_pair)

    def warmup(self, input_spec) -> dict:
        """Run one forward per row bucket on zeros (idempotent), after
        probing 1 and 2 rows for row tracking.  Returns ``{rows:
        seconds}``."""
        with self._warm_lock:
            if self._warmed:
                return {}
            row = self._normalize_row_spec(input_spec)
            timings = {}
            out = None
            # ascending, so the 1- and 2-row probes come first: a model
            # whose output rows do not follow its input rows is refused
            # before the larger buckets run
            for b in sorted(set(self.buckets) | {1, 2}):
                x = _tree_map(lambda s: np.zeros((b,) + s.shape, s.dtype),
                              row)
                t0 = time.monotonic()
                out = self._forward(x)
                timings[b] = round(time.monotonic() - t0, 4)
                self._warm_forwards += 1
                bad = [o.shape for o in _flatten(out)[0]
                       if o.shape[:1] != (b,)]
                if bad:
                    raise ValueError(
                        f"model {self.name!r} is not servable by the "
                        f"coalescing engine: output leading dims {bad} do "
                        f"not track the input batch dim ({b} rows in) — "
                        "per-request output slicing would return garbage")
            self._row_spec = row
            self._out_spec = _tree_map(
                lambda o: RowSpec(tuple(o.shape[1:]), o.dtype), out)
            self._warmed = True
            return timings

    @property
    def compile_count(self) -> int:
        """Forwards run by warmup (one per bucket, plus the 1- and 2-row
        probes when they are not buckets).  Frozen after warmup."""
        return self._warm_forwards

    @property
    def warmed_up(self) -> bool:
        return self._warmed

    @property
    def row_spec(self):
        """The warmed per-row input spec (pytree of :class:`RowSpec`), or
        None before warmup: reusable as another service's
        ``input_spec`` (a replica set's grow and a hot cutover warm new
        services off it)."""
        return self._row_spec

    @property
    def drain_ewma_s(self) -> Optional[float]:
        """The batcher's observed seconds-per-request EWMA (None before
        its first dispatch): the drain-rate signal of ``retry_after_ms``
        and the front end's autoscaler.  A racy single read of a
        single-writer float, by design."""
        return self._batcher._spr_ewma

    # -- request path ------------------------------------------------------
    def _normalize_input(self, x):
        xs = _tree_map(np.asarray, x)
        return xs, leading_rows(xs)

    def _conform_request(self, xs):
        """Validate a request against the warmed row spec BEFORE it can
        join a coalesced group (a malformed request fails alone); a
        dtype mismatch is coerced to the spec dtype."""
        spec_leaves, spec_def = _flatten(self._row_spec)
        req_leaves, req_def = _flatten(xs)
        if spec_def != req_def or any(
                leaf.shape[1:] != s.shape
                for leaf, s in zip(req_leaves, spec_leaves)):
            raise RequestSpecError(
                f"request does not match the deployed input_spec of "
                f"{self.name!r}: expected per-row "
                f"{[(s.shape, str(s.dtype)) for s in spec_leaves]}"
                f", got {[leaf.shape[1:] for leaf in req_leaves]}")
        try:
            conformed = [leaf if leaf.dtype == s.dtype
                         else np.asarray(leaf, dtype=s.dtype)
                         for leaf, s in zip(req_leaves, spec_leaves)]
        except (ValueError, TypeError) as e:
            raise RequestSpecError(
                f"request data does not coerce to the deployed "
                f"input_spec dtypes of {self.name!r}: {e}") from None
        return _unflatten(req_def, conformed)

    def submit(self, x, *, deadline: Optional[float] = None,
               ctx=None) -> Future:
        """Enqueue one request (pytree of arrays, shared leading batch dim
        ``1 <= n <= max_batch_size``) and return the Future of its
        outputs.  Raises :class:`ServiceOverloaded` when the bounded queue
        is full and :class:`ServiceClosed` after :meth:`stop`.
        ``deadline`` (absolute ``time.monotonic()`` seconds, or None)
        travels with the request: the dispatch refuses expired work with
        :class:`DeadlineExceeded` instead of spending device time on a
        caller that has given up.  ``ctx``: an optional
        ``RequestContext`` (minted here when request tracing is on),
        which rides the queue with the request."""
        xs, n = self._normalize_input(x)
        if n == 0:
            f: Future = Future()
            f.set_result(self._empty_output())
            return f
        if n > self.max_batch_size:
            raise RequestSpecError(
                f"request of {n} rows exceeds max_batch_size="
                f"{self.max_batch_size}; use predict() which chunks")
        if deadline is not None and time.monotonic() >= deadline:
            # already expired: resolve without touching the queue
            f = Future()
            f.set_exception(DeadlineExceeded(
                f"request deadline passed before submit to "
                f"{self.name!r}"))
            return f
        if not self._warmed:
            # deferred-spec path: capture the row spec from live traffic
            self.warmup(_tree_map(
                lambda a: RowSpec(a.shape[1:], a.dtype), xs))
        xs = self._conform_request(xs)
        if ctx is None and self._request_tracing:
            from bigdl_tpu_torch.telemetry.context import RequestContext
            ctx = RequestContext(deadline=deadline)
        req = _Request(xs, n, deadline=deadline, ctx=ctx)
        tracer = self.tracer
        if ctx is not None and tracer is not None and tracer.enabled:
            # the request's submit span, with the outbound half of the
            # flow arrow its dispatch span closes
            with tracer.span("request_submit", cat="serving",
                             trace_id=ctx.trace_id, model=self.name,
                             rows=n, tenant=ctx.tenant):
                tracer.flow_start("req", ctx.flow_id, cat="serving")
                self._put_counted(req, n)
        else:
            self._put_counted(req, n)
        return req.future

    def _put_counted(self, req: _Request, n: int) -> None:
        try:
            self._batcher.put(req)
        except ServiceOverloaded:
            self.metrics.record_reject(n)
            raise
        self.metrics.record_submit(n)

    def predict(self, x, timeout: Optional[float] = None):
        """Blocking sugar over :meth:`submit`; chunks inputs larger than
        ``max_batch_size`` through a bounded in-flight window (at most
        half the queue).  ``timeout`` bounds the whole call."""
        xs, n = self._normalize_input(x)
        if n == 0:
            return self._empty_output()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)

        def remaining() -> Optional[float]:
            if deadline is None:
                return None
            return max(0.0, deadline - time.monotonic())

        if n <= self.max_batch_size:
            return self.submit(xs).result(remaining())
        window = max(1, self.queue_capacity // 2)
        parts: List[Any] = []
        inflight: List[Future] = []
        for off in range(0, n, self.max_batch_size):
            lo, hi = off, off + self.max_batch_size
            chunk = _tree_map(lambda a: a[lo:hi], xs)
            if len(inflight) >= window:
                parts.append(inflight.pop(0).result(remaining()))
            while True:
                try:
                    inflight.append(self.submit(chunk))
                    break
                except ServiceOverloaded:
                    if not inflight:  # foreign traffic owns the queue
                        raise
                    parts.append(inflight.pop(0).result(remaining()))
        parts.extend(f.result(remaining()) for f in inflight)
        return _tree_map(lambda *ps: np.concatenate(ps, axis=0), *parts)

    def _empty_output(self):
        if self._out_spec is None:
            return np.empty((0,))
        return _tree_map(
            lambda s: np.empty((0,) + s.shape, dtype=s.dtype),
            self._out_spec)

    # -- batcher callback --------------------------------------------------
    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _dispatch(self, requests: List[_Request]) -> None:
        """Runs on the batcher thread: coalesce → pad to bucket → one
        forward → slice per-request outputs → resolve futures."""
        live = []
        for r in requests:
            try:
                if r.future.set_running_or_notify_cancel():
                    live.append(r)
            except Exception:
                # already settled from outside the batcher (a replica
                # set's supervisor timing out or failing over a stuck
                # request): nothing left to serve here
                pass
        if not live:
            return
        now = time.monotonic()
        expired = [r for r in live
                   if r.deadline is not None and now >= r.deadline]
        if expired:
            # refuse expired work BEFORE the device call: inference is
            # idempotent, so a router may already have retried it
            for r in expired:
                if settle_future(r.future, exc=DeadlineExceeded(
                        f"request expired in {self.name!r} queue after "
                        f"{(now - r.t_enqueue) * 1e3:.1f} ms")):
                    self.metrics.record_failure(r.n_rows)
            live = [r for r in live
                    if r.deadline is None or now < r.deadline]
            if not live:
                return
        rows = sum(r.n_rows for r in live)
        tracer = self.tracer
        ctxs = ([r.ctx for r in live if r.ctx is not None]
                if tracer is not None and tracer.enabled else [])
        if ctxs:
            # one dispatch span fanning in the coalesced requests' flows
            with tracer.span("dispatch", cat="serving", model=self.name,
                             n_requests=len(live), rows=rows,
                             trace_ids=[c.trace_id for c in ctxs]):
                for c in ctxs:
                    tracer.flow_end("req", c.flow_id, cat="serving")
                self._dispatch_forward(live, rows)
        else:
            self._dispatch_forward(live, rows)

    def _dispatch_forward(self, live: List[_Request], rows: int) -> None:
        try:
            if self._faults is not None:
                # the fault site, inside the handler: an injected error
                # fails the group like a real one; ReplicaDeathFault is a
                # BaseException and escapes, killing the batcher thread
                # with the group stranded, as a real crash does
                ix = self._dispatch_index
                self._dispatch_index += 1
                self._faults.serving_dispatch(ix, self._fault_replica)
            if len(live) == 1:
                x = live[0].x
            else:
                x = _tree_map(lambda *ls: np.concatenate(ls, axis=0),
                              *[r.x for r in live])
            bucket = self._bucket_for(rows)
            out = self._forward(pad_rows(x, bucket))
            bad = [o.shape for o in _flatten(out)[0]
                   if o.shape[:1] != (bucket,)]
            if bad:
                raise RuntimeError(
                    f"output leading dims {bad} != bucket {bucket}; "
                    "refusing to slice per-request results")
            self.metrics.record_dispatch(rows, bucket)
            now = time.monotonic()
            off = 0
            for r in live:
                lo, hi = off, off + r.n_rows
                if settle_future(r.future, result=_tree_map(
                        lambda o: o[lo:hi], out)):
                    self.metrics.record_done(r.n_rows, now - r.t_enqueue,
                                             bucket=bucket)
                off = hi
        except Exception as e:  # resolve, never strand, the waiters
            for r in live:
                if not r.future.done() and settle_future(r.future, exc=e):
                    self.metrics.record_failure(r.n_rows)

    # -- stats / lifecycle -------------------------------------------------
    @property
    def alive(self) -> bool:
        """False once stopped or once the batcher thread died."""
        return not self._stopped and not self._batcher.dead

    def revive(self) -> bool:
        """Replace a DEAD batcher thread with a fresh one over the same
        warmed model: no rewarm, the service keeps its name and metrics.
        The dead batcher's stranded backlog is cancelled first.  False
        (no-op) while the batcher is healthy; ``ServiceClosed`` after
        :meth:`stop`."""
        with self._lifecycle_lock:
            if self._stopped:
                raise ServiceClosed(
                    f"cannot revive stopped service {self.name!r}")
            if not self._batcher.dead:
                return False
            cancelled = self._batcher.close(drain=False, timeout=1.0)
            if cancelled:
                self.metrics.record_cancel(cancelled)
            self._finalizer.detach()
            self._batcher = self._make_batcher()
            self._finalizer = weakref.finalize(
                self, RequestBatcher.close, self._batcher, True, 5.0)
            self._batcher.start()
            return True

    @property
    def last_progress(self) -> Optional[float]:
        """Monotonic time of the batcher's last completed dispatch (or its
        start; None before either): how a replica set's supervisor tells
        a WEDGED replica from a congested one."""
        return self._batcher.last_progress

    def queue_depth(self) -> int:
        return self._batcher.depth()

    def stats(self) -> dict:
        """Snapshot dict — the reference's ``stats()`` schema."""
        snap = self.metrics.snapshot(queue_depth=self._batcher.depth(),
                                     compile_count=self._warm_forwards)
        snap["model"] = self.name
        snap["max_batch_size"] = self.max_batch_size
        snap["buckets"] = list(self.buckets)
        return snap

    def start(self) -> None:
        with self._lifecycle_lock:
            self._batcher.start()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Graceful shutdown: refuse new submits, drain (default) or
        cancel the backlog, join the batcher.  Idempotent."""
        with self._lifecycle_lock:
            if self._stopped:
                return
            self._stopped = True
            self._finalizer.detach()
            cancelled_rows = self._batcher.close(drain=drain,
                                                 timeout=timeout)
        if cancelled_rows:
            self.metrics.record_cancel(cancelled_rows)
        # a stopped service leaves the admin plane
        if self._admin_name is not None:
            from bigdl_tpu_torch.telemetry import admin as _admin
            srv = _admin.current()
            if srv is not None:
                srv.remove_source(self._admin_name)

    def release(self) -> None:
        """Drop the model of a STOPPED service, so a retired slot stops
        holding device memory.  Refused on a live service: its batcher
        still dispatches through it."""
        if not self._stopped:
            raise RuntimeError(
                f"release() on live service {self.name!r}; stop() first")
        self.model = None
        with self._warm_lock:
            self._warmed = False
            self._row_spec = None

    def __enter__(self) -> "InferenceService":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=True)


__all__ = ["DeadlineExceeded", "InferenceService", "RowSpec",
           "ServiceClosed",
           "ServiceOverloaded", "RequestSpecError", "leading_rows",
           "pad_rows", "parse_row_buckets", "row_buckets", "resolve_device"]

"""FrontendServer — the wire-level serving front end (HTTP/1.1).

Port of ``bigdl_tpu/frontend/server.py`` (an owned copy).  Everything
below this module is in-process (the coalescing ``InferenceService``,
the self-healing ``ReplicaSet``, the decode engine, the admin plane);
this module puts them behind a socket.  This is the Cluster-Serving shape of the lineage paper (BigDL 2.0,
arXiv:2204.01715 §3: a network front end turns the library into a
service), built with the same stdlib-only discipline as
``telemetry/admin.py`` (threaded ``http.server``, no grpc/flask):

- ``POST /v1/models/<name>[:<version>]/predict`` — JSON bodies
  (``{"inputs": <nested lists | {leaf: nested lists}>}``) or raw
  ``.npy`` bytes (``Content-Type: application/x-npy``) for bulk.  The
  response echoes the trace id and returns ``outputs`` as nested
  lists; with ``Accept: application/x-npy`` a single-array output
  comes back as raw npy bytes.
- **Chunked streaming for multi-chunk predicts**: inputs larger than
  the backend's ``max_batch_size`` stream back as
  ``application/x-ndjson`` over HTTP chunked transfer encoding — one
  JSON line per coalescible chunk as it completes (bounded in-flight
  submission window, results in input order), closed by a
  ``{"done": true}`` trailer line.  The resolved backend/version is
  PINNED for the whole exchange, so a hot cutover never splits one
  streaming request across versions.
- **Backpressure maps to HTTP**: a queue overload or a tenant
  rate-limit shed (:class:`~bigdl_tpu_torch.frontend.qos.TenantRateLimited`)
  returns 429 with ``Retry-After`` (seconds, ceiling) and
  ``X-Retry-After-Ms`` (exact) from ``ServiceOverloaded.
  retry_after_ms``; a missed deadline returns 504; an unknown model
  404; a malformed request 400; strict-mode undeclared (or missing)
  tenants 403.
- **Deadlines ride a header**: ``X-Deadline-Ms: 250`` becomes the
  monotonic deadline propagated into the existing
  ``serving/batcher._Request.deadline`` path — expired work is refused
  before the device call, exactly like in-process submits.
- **Trace ids span the wire hop**: ``X-Trace-Id`` (or a freshly minted
  id) seeds the :class:`~bigdl_tpu_torch.telemetry.RequestContext` the
  request travels with, is echoed back in the response, and — when a
  tracer is attached — the whole exchange lands as a ``wire_request``
  span carrying tenant/model/status, so ``tools/obs_report.py``
  stories start at the socket.

Inertness contract (house discipline): nothing in this package runs
unless a ``FrontendServer`` is explicitly constructed — no socket, no
thread, no import-time side effects (the zero-extra-threads gate in
``tests/test_torch_frontend.py``).  Everything here is host-side:
inputs/outputs are numpy pytrees, and the device work happens in the
backends.

Security posture: binds ``127.0.0.1`` only by default, where the
historical no-auth behavior is unchanged.  A NON-loopback bind is
refused unless a bearer token is configured
(``Config.frontend_auth_token`` / ``BIGDL_TPU_FRONTEND_AUTH_TOKEN`` or
the ``auth_token=`` constructor arg); with a token configured, every
request must carry ``Authorization: Bearer <token>`` (constant-time
compared) or is refused 401 before the body is read.  ``X-Tenant``
stays a declared QoS tag, never a credential.
"""

from __future__ import annotations

import hmac
import json
import logging
import re
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from io import BytesIO
from typing import Dict, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.frontend.qos import (QosAdmission, TenantRateLimited,
                                          UnknownTenantError)
from concurrent.futures import TimeoutError as FutureTimeoutError

from bigdl_tpu_torch.serving.batcher import (DeadlineExceeded,
                                             RequestSpecError, ServiceClosed,
                                             ServiceOverloaded)
from bigdl_tpu_torch.telemetry.context import RequestContext
from bigdl_tpu_torch.telemetry.registry import MetricRegistry

logger = logging.getLogger("bigdl_tpu_torch.frontend")

_PREDICT_RE = re.compile(
    r"^/v1/models/(?P<name>[^/:]+)(?::(?P<version>\d+))?/predict$")
_GENERATE_RE = re.compile(
    r"^/v1/models/(?P<name>[^/:]+)(?::(?P<version>\d+))?/generate$")
_NPY = "application/x-npy"
_NDJSON = "application/x-ndjson"
_MAX_BODY = 256 << 20  # refuse absurd Content-Length up front


class _WireInflight:
    """Per-(model, version) count of wire requests currently being
    served — the thing hot cutover drains.  A streaming predict counts
    as ONE wire request for its whole exchange (it pinned the
    version)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._counts: Dict[Tuple[str, int], int] = {}  # guarded-by: _cond

    def enter(self, key: Tuple[str, int]) -> None:  # acquires: wire_inflight
        with self._cond:
            self._counts[key] = self._counts.get(key, 0) + 1  # acquires: wire_inflight

    def exit(self, key: Tuple[str, int]) -> None:  # releases: wire_inflight
        with self._cond:
            n = self._counts.get(key, 0) - 1
            if n <= 0:
                self._counts.pop(key, None)  # releases: wire_inflight
            else:
                self._counts[key] = n  # releases: wire_inflight
            self._cond.notify_all()

    def count(self, key: Tuple[str, int]) -> int:
        with self._cond:
            return self._counts.get(key, 0)

    def wait_idle(self, key: Tuple[str, int],
                  timeout: Optional[float]) -> bool:
        """Block until no wire request holds ``key`` (True) or the
        timeout passes with some still in flight (False)."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._cond:
            while self._counts.get(key, 0) > 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining
                                if remaining is not None else 1.0)
            return True


class _ConnLedger:
    """Open-connection accounting + the hard cap, shared by BOTH
    connection cores (threaded and event-loop): ``try_admit`` is the
    one cheap gate every fresh accept passes, ``release`` the one exit.
    Mirrors into the server's MetricRegistry (``frontend/
    open_connections`` gauge + accepted/closed/reaped/refused
    counters) so a zero-traffic scrape already shows the schema."""

    def __init__(self, metrics: MetricRegistry, max_connections: int):
        self._lock = threading.Lock()
        self._open = 0  # guarded-by: _lock
        self.max_connections = max(0, int(max_connections))  # 0 = uncapped
        self._gauge = metrics.gauge("frontend/open_connections")
        self._accepted = metrics.counter("frontend/conns_accepted")
        self._closed = metrics.counter("frontend/conns_closed")
        self._reaped = metrics.counter("frontend/conns_reaped")
        self._refused = metrics.counter("frontend/conns_refused")

    def try_admit(self) -> bool:
        """One accept's verdict.  False → the caller just closes the
        socket (counted refused) — no parser, no thread, no state."""
        with self._lock:
            if self.max_connections \
                    and self._open >= self.max_connections:
                admitted = False
            else:
                self._open += 1
                self._gauge.set(self._open)
                admitted = True
        if admitted:
            self._accepted.inc()
        else:
            self._refused.inc()
        return admitted

    def release(self, reaped: bool = False) -> None:
        with self._lock:
            self._open = max(0, self._open - 1)
            self._gauge.set(self._open)
        self._closed.inc()
        if reaped:
            self._reaped.inc()

    @property
    def open(self) -> int:
        with self._lock:
            return self._open


class _HTTPError(Exception):
    """Internal: carries an HTTP status + JSON body to the handler."""

    def __init__(self, status: int, message: str, **fields):
        super().__init__(message)
        self.status = status
        self.body = {"error": message, **fields}
        self.headers: Dict[str, str] = {}


def _jsonify(out):
    """Numpy output pytree → JSON-able (dict/list containers kept,
    arrays → nested lists)."""
    if isinstance(out, dict):
        return {k: _jsonify(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return [_jsonify(v) for v in out]
    return np.asarray(out).tolist()


def _parse_inputs(obj):
    """JSON request value → numpy input pytree.  A JSON list is always
    ONE array; a dict maps leaf names to arrays (the only multi-leaf
    container JSON can express unambiguously)."""
    if isinstance(obj, dict):
        return {k: np.asarray(v) for k, v in obj.items()}
    return np.asarray(obj)


def _shed_error(e: ServiceOverloaded) -> _HTTPError:
    err = _HTTPError(429, str(e),
                     retry_after_ms=e.retry_after_ms,
                     queue_depth=e.queue_depth,
                     capacity=e.capacity)
    if e.retry_after_ms is not None:
        # HTTP Retry-After is whole seconds — ceil so a client that
        # honors it never retries early; the exact hint rides a
        # custom header
        err.headers["Retry-After"] = str(
            max(1, int(-(-e.retry_after_ms // 1000))))
        err.headers["X-Retry-After-Ms"] = f"{e.retry_after_ms:.1f}"
    return err


class FrontendServer:
    """One wire endpoint over a :class:`~bigdl_tpu_torch.serving.
    ModelRegistry` and/or directly-attached backends.

    Parameters
    ----------
    registry:
        Optional :class:`~bigdl_tpu_torch.serving.ModelRegistry`.  Requests
        resolve through latest-wins + breaker-fallback routing
        (``registry.route``), the resolved version is pinned for the
        exchange, and the outcome feeds that version's breaker.
    backends:
        ``{name: ReplicaSet | InferenceService}`` served directly (a
        ReplicaSet is the self-healing multi-replica path; version is
        reported as 0).  ``add_backend`` attaches more after start.
    qos:
        Optional :class:`~bigdl_tpu_torch.frontend.qos.QosAdmission`.  Every
        request passes ``qos.admit(tenant)`` first; its per-tenant
        counters share this server's metric registry when it was built
        without one.
    port / host:
        ``port=0`` binds an ephemeral port (tests); ``port=None``
        resolves ``Config.frontend_port`` (0 = refuse to start — the
        frontend is opt-in).  Loopback-only by default.
    tracer:
        Optional :class:`~bigdl_tpu_torch.telemetry.Tracer`: each exchange
        records a ``wire_request`` span (trace_id, tenant, model,
        rows, status).
    name:
        Admin-plane source name (metrics/tracer registered under it
        when the admin plane is up).
    auth_token:
        Bearer token every request must present
        (``Authorization: Bearer <token>``, constant-time compared;
        401 otherwise).  ``None`` resolves
        ``Config.frontend_auth_token`` / ``BIGDL_TPU_FRONTEND_AUTH_
        TOKEN``; empty keeps the historical open behavior — but a
        NON-loopback ``host`` is refused at construction without a
        token.
    """

    def __init__(self, registry=None, *, backends: Optional[dict] = None,
                 qos: Optional[QosAdmission] = None,
                 port: Optional[int] = 0, host: str = "127.0.0.1",
                 tracer=None, name: str = "frontend",
                 stream_window: int = 4,
                 auth_token: Optional[str] = None,
                 core: Optional[str] = None,
                 shards: Optional[int] = None,
                 max_connections: Optional[int] = None,
                 idle_timeout_s: Optional[float] = None,
                 reuse_port: bool = False,
                 pin_cpus: Optional[bool] = None):
        if port is None:
            from bigdl_tpu_torch.utils.config import get_config
            port = int(getattr(get_config(), "frontend_port", 0) or 0)
            if port <= 0:
                raise ValueError(
                    "FrontendServer(port=None) with Config.frontend_port "
                    "unset — the wire frontend is opt-in; pass a port or "
                    "set BIGDL_TPU_FRONTEND_PORT")
        self.name = name
        self.host = host
        self.requested_port = int(port)
        self.port: Optional[int] = None
        self.registry = registry
        self.metrics = MetricRegistry()
        self.qos = qos if qos is not None \
            else QosAdmission(registry=self.metrics)
        if qos is not None and qos.registry is not self.metrics:
            # one /metrics page: fold the wire counters into the qos
            # registry rather than running two half-pages
            self.metrics = qos.registry
        self.tracer = tracer
        # auth/host validation FIRST — pure checks, before anything
        # with an external side effect (the admin-plane registration
        # below reserves a source name that only stop() releases; a
        # constructor that registers then raises would leak it)
        if auth_token is None:
            from bigdl_tpu_torch.utils.config import get_config
            auth_token = getattr(get_config(), "frontend_auth_token",
                                 "") or ""
        self._auth_token = str(auth_token)
        if host not in ("127.0.0.1", "localhost", "::1"):
            if not self._auth_token:
                # X-Tenant is a QoS
                # tag, not a credential — an open non-loopback bind
                # would hand the serving plane to the network.  Refuse
                # at construction, before any socket exists.
                raise ValueError(
                    f"refusing to bind non-loopback host {host!r} "
                    "without an auth token — set "
                    "Config.frontend_auth_token / "
                    "BIGDL_TPU_FRONTEND_AUTH_TOKEN (requests then "
                    "need `Authorization: Bearer <token>`) or bind "
                    "127.0.0.1")
            logger.warning(
                "wire frontend binding non-loopback host %r with "
                "bearer-token auth; X-Tenant remains a QoS tag, not a "
                "credential", host)
        self._stream_window = max(1, int(stream_window))
        # connection-core knobs: unset values resolve
        # Config — env-tunable without touching call sites
        from bigdl_tpu_torch.utils.config import get_config
        _cfg = get_config()
        if core is None:
            core = getattr(_cfg, "frontend_core", "eventloop") \
                or "eventloop"
        if core not in ("eventloop", "threaded"):
            raise ValueError(f"unknown frontend core {core!r} — "
                             f"expected 'eventloop' or 'threaded'")
        self.core = core
        if shards is None:
            shards = int(getattr(_cfg, "frontend_shards", 1) or 1)
        self._shards = max(1, int(shards))
        if max_connections is None:
            max_connections = int(getattr(
                _cfg, "frontend_max_connections", 0) or 0)
        if idle_timeout_s is None:
            idle_timeout_s = float(getattr(
                _cfg, "frontend_idle_timeout_s", 0.0) or 0.0)
        self._idle_timeout_s = max(0.0, float(idle_timeout_s))
        self._reuse_port = bool(reuse_port)
        if pin_cpus is None:
            pin_cpus = bool(getattr(_cfg, "frontend_pin_cpus", False))
        self._pin_cpus = bool(pin_cpus)
        self._lock = threading.Lock()
        self._backends: Dict[str, object] = dict(backends or {})  # guarded-by: _lock
        self.inflight = _WireInflight()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._elc = None  # EventLoopCore when core="eventloop" is live
        # counters pre-created so a zero-traffic scrape shows the schema
        for c in ("requests", "responses_2xx", "responses_4xx",
                  "responses_5xx", "sheds", "deadline_504",
                  "stream_chunks", "generate_tokens",
                  "client_disconnects"):
            self.metrics.counter(f"frontend/{c}")
        self._latency_h = self.metrics.histogram("frontend/wire_latency_s")
        # connection-plane schema (gauge + counters) pre-created too
        self._conns = _ConnLedger(self.metrics, max_connections)
        # admin plane: the wire+tenant registry and the tracer scrape
        # from the same endpoint as everything else
        from bigdl_tpu_torch.telemetry import admin as _admin
        self._admin_name: Optional[str] = None
        _srv = _admin.maybe_start()
        if _srv is not None:
            self._admin_name = _srv.unique_source_name(self.name)
            _srv.add_registry(self._admin_name, self.metrics)
            if self.tracer is not None:
                _srv.add_tracer(self._admin_name, self.tracer)

    # -- backends ----------------------------------------------------------
    def add_backend(self, name: str, backend) -> "FrontendServer":
        """Serve ``backend`` (ReplicaSet / InferenceService) as
        ``name`` alongside the registry's models.  Direct backends
        shadow same-named registry entries."""
        with self._lock:
            self._backends[name] = backend
        return self

    def remove_backend(self, name: str) -> None:
        with self._lock:
            self._backends.pop(name, None)

    def _resolve(self, name: str, version: Optional[int]):
        """(key, submit_target, breaker) for one wire exchange.  Direct
        backends pin version 0; registry names resolve through
        latest-wins + breaker fallback and pin the resolved version."""
        with self._lock:
            backend = self._backends.get(name)
            attached = sorted(self._backends)
        if backend is not None:
            return (name, 0), backend, None
        if self.registry is None:
            raise _HTTPError(404, f"no model {name!r} attached",
                             models=attached)
        try:
            v, svc, brk = self.registry.route(name, version)
        except KeyError as e:
            raise _HTTPError(404, str(e)) from None
        return (name, v), svc, brk

    # acquires: wire_inflight
    def _resolve_pinned(self, name: str, version: Optional[int]):
        """Resolve AND pin (wire-inflight enter) atomically enough for
        cutover: between ``route()`` and ``inflight.enter()`` a hot
        cutover could observe a zero count, drain, and undeploy the
        resolved version — so after entering, re-check the version is
        still deployed and re-resolve if not.  The caller owns the
        matching ``inflight.exit(key)``."""
        while True:
            key, backend, brk = self._resolve(name, version)
            self.inflight.enter(key)
            if brk is None:
                return key, backend, brk  # direct backend: no cutover
            try:
                self.registry.get(name, key[1])
                return key, backend, brk
            except KeyError:
                # undeployed in the race window: un-pin and re-resolve
                # (latest-wins now points at the successor)
                self.inflight.exit(key)
                if version is not None:
                    raise _HTTPError(
                        404, f"model {name!r} version {version} was "
                             f"undeployed") from None

    def models(self) -> dict:
        with self._lock:
            direct = {n: [0] for n in sorted(self._backends)}
        if self.registry is not None:
            for n, vs in self.registry.list_models().items():
                direct.setdefault(n, vs)
        return direct

    # -- cutover support ---------------------------------------------------
    def drain_version(self, name: str, version: int,
                      timeout: Optional[float] = None) -> bool:
        """Block until no wire request is pinned to
        ``name``:``version`` — the connection-draining half of hot
        cutover (:class:`~bigdl_tpu_torch.frontend.cutover.HotCutover` calls
        this AFTER routing flipped to the new version, BEFORE the old
        one is undeployed).  True when drained, False on timeout."""
        return self.inflight.wait_idle((name, int(version)), timeout)

    # -- request plumbing (runs on handler threads) ------------------------
    @staticmethod
    def _submit(backend, x, deadline: Optional[float], ctx):
        """Uniform submit over the two backend shapes.  Returns a
        Future.  :class:`RequestSpecError` is the backend refusing the
        request's SHAPE (``_conform_request`` spec validation) — that
        is the client's fault, so it wraps to 400 here; any OTHER
        synchronous error (e.g. a deferred-spec warmup compile
        failure) and anything the future later resolves with stay
        server-side stories (500)."""
        from bigdl_tpu_torch.resilience.replica_set import ReplicaSet
        try:
            if isinstance(backend, ReplicaSet):
                timeout = (None if deadline is None
                           else max(0.0, deadline - time.monotonic()))
                return backend.submit(x, timeout=timeout, ctx=ctx)
            return backend.submit(x, deadline=deadline, ctx=ctx)
        except RequestSpecError as e:
            raise _HTTPError(400, str(e)) from None

    @staticmethod
    def _backend_max_batch(backend) -> int:
        return int(backend.max_batch_size)

    def _predict_once(self, backend, x, deadline, ctx, brk):
        """One submit → result, with the breaker fed the outcome (the
        same contract ``ModelRegistry.submit`` keeps in-process)."""
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        try:
            fut = self._submit(backend, x, deadline, ctx)
        except ServiceOverloaded:
            raise  # never a breaker outcome (documented contract)
        try:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            out = self._result_or_504(fut, remaining)
        except BaseException as e:
            if not fut.cancelled():
                ModelRegistry.record_outcome(brk, e)
            raise
        ModelRegistry.record_outcome(brk, None)
        return out

    @staticmethod
    def _result_or_504(fut, timeout: Optional[float]):
        """``fut.result`` with the deadline-family normalization the
        ReplicaSet also does: an UNRESOLVED wait expiry (the request is
        still queued past its wire deadline) becomes
        :class:`DeadlineExceeded` (→ 504); a future that RESOLVED with
        its own timeout-family error propagates untouched (on py>=3.11
        ``FutureTimeoutError`` aliases ``TimeoutError``, so the two
        cases share an except clause)."""
        try:
            return fut.result(timeout)
        except FutureTimeoutError:
            if fut.done():
                raise  # the future's own DeadlineExceeded — real story
            fut.cancel()  # refuse late service; batcher honors cancel
            raise DeadlineExceeded(
                "wire deadline expired while the request was "
                "queued") from None

    @staticmethod
    def _parse_body(body: bytes, ctype: str):
        """Request body → ``(input_pytree, rows)`` — the one 400
        taxonomy both connection cores share."""
        if ctype == _NPY:
            try:
                x = np.load(BytesIO(body), allow_pickle=False)
            except (ValueError, OSError, EOFError,
                    zipfile.BadZipFile) as e:
                # the SPECIFIC malformed-bytes family np.load raises —
                # a blanket except here would 400 internal bugs too
                # (the GL302 taxonomy contract).  BadZipFile: a body
                # starting with zip magic routes np.load through
                # zipfile before any numpy validation
                raise _HTTPError(
                    400, f"unreadable npy body: {e}") from None
        else:
            try:
                payload = json.loads(body.decode("utf-8"))
            except ValueError as e:
                # JSONDecodeError and UnicodeDecodeError both subclass
                # ValueError — the whole malformed-body family
                raise _HTTPError(
                    400, f"unreadable JSON body: {e}") from None
            if not isinstance(payload, dict) or "inputs" not in payload:
                raise _HTTPError(
                    400, 'JSON body must be {"inputs": ...}')
            try:
                x = _parse_inputs(payload["inputs"])
            except (ValueError, TypeError) as e:
                # e.g. ragged nested lists np.asarray refuses
                raise _HTTPError(
                    400, f"unparseable inputs: {e}") from None
        try:
            leaves = ([x] if not isinstance(x, dict)
                      else list(x.values()))
            rows = int(leaves[0].shape[0])
        except (AttributeError, IndexError):
            raise _HTTPError(400, "inputs must have a leading batch "
                                  "dim") from None
        return x, rows

    @staticmethod
    def _parse_generate_body(body: bytes, ctype: str):
        """Generate request body → ``(prompt 1-D int array, max_new or
        None)``.  JSON only: ``{"prompt": [ints],
        "max_new_tokens": n?}`` — token streams have no npy bulk
        form."""
        if ctype == _NPY:
            raise _HTTPError(400, "generate takes a JSON body "
                                  '({"prompt": [...]}), not npy')
        try:
            payload = json.loads(body.decode("utf-8"))
        except ValueError as e:
            raise _HTTPError(
                400, f"unreadable JSON body: {e}") from None
        if not isinstance(payload, dict) or "prompt" not in payload:
            raise _HTTPError(400, 'JSON body must be {"prompt": ...}')
        try:
            prompt = np.asarray(payload["prompt"], dtype=np.int64)
        except (ValueError, TypeError) as e:
            raise _HTTPError(
                400, f"unparseable prompt: {e}") from None
        if prompt.ndim != 1 or prompt.size < 1:
            raise _HTTPError(400, "prompt must be a non-empty 1-D "
                                  "token list")
        max_new = payload.get("max_new_tokens")
        if max_new is not None:
            if not isinstance(max_new, int) or max_new < 1:
                raise _HTTPError(
                    400, f"max_new_tokens must be a positive int, got "
                         f"{max_new!r}")
        return prompt, max_new

    def _run_generate(self, handler, name, version, body, ctype,
                      tenant, deadline_ms, trace_id) -> None:
        """The whole exchange for one POST .../generate — the decode
        twin of :meth:`_run_predict` (same QoS admission, pinning,
        cutover-retry and accounting shape)."""
        t0 = time.monotonic()
        self.metrics.counter("frontend/requests").inc()
        self.qos.admit(tenant)
        deadline = (t0 + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        ctx = RequestContext(trace_id=trace_id, tenant=tenant,
                             deadline=deadline)
        self._resolve(name, version)  # 404 precedence
        prompt, max_new = self._parse_generate_body(body, ctype)
        ok = False
        try:
            for attempt in range(3):
                key, backend, brk = self._resolve_pinned(name, version)
                try:  # pin held: EVERY exit path below must unpin
                    if not getattr(backend, "is_decode_backend",
                                   False):
                        raise _HTTPError(
                            400, f"model {name!r} is not a decode "
                                 f"backend — use /predict")
                    ok = self._respond_generate(
                        handler, key, backend, prompt, max_new,
                        deadline, ctx, brk)
                    break
                except ServiceClosed:
                    # cutover closed the pinned version before any
                    # token was streamed — re-resolve the successor
                    # (same idempotency argument as _run_predict)
                    if attempt == 2 or version is not None:
                        raise
                finally:
                    self.inflight.exit(key)
        finally:
            self.qos.record_result(tenant, time.monotonic() - t0, ok)
            self._latency_h.observe(time.monotonic() - t0)

    def _respond_generate(self, handler, key, backend, prompt,
                          max_new, deadline, ctx, brk) -> bool:
        """Token streaming for one decode request: ndjson over chunked
        transfer, one ``{"index", "token"}`` line per generated token
        IN ORDER, closed by a ``{"done": true, "tokens": [...]}``
        trailer carrying the full sequence.  The 200 chunked header is
        committed only at the FIRST token, so pre-stream failures
        (shed, deadline, cutover close) still get their real status.
        The decode scheduler thread hands tokens to this handler
        thread through a Queue — ``on_token`` never blocks the
        scheduler on a slow reader."""
        import queue as _queue

        from bigdl_tpu_torch.serving.registry import ModelRegistry
        _name, version = key
        started = [False]

        def ensure_started():
            if not started[0]:
                handler.start_chunked(
                    200, _NDJSON,
                    {"X-Trace-Id": ctx.trace_id,
                     "X-Model-Version": str(version)})
                started[0] = True

        tokens_q: "_queue.Queue" = _queue.Queue()

        def on_token(index: int, token: int) -> None:
            tokens_q.put((index, int(token)))

        try:
            fut = backend.submit(prompt, max_new_tokens=max_new,
                                 deadline=deadline, ctx=ctx,
                                 on_token=on_token)
        except RequestSpecError as e:
            raise _HTTPError(400, str(e)) from None
        # ServiceOverloaded propagates untouched (never a breaker
        # outcome — same contract as _predict_once)
        sent = 0

        def stream_line(index: int, token: int) -> None:
            ensure_started()
            handler.send_chunk(json.dumps(
                {"index": index, "token": token}).encode() + b"\n")

        try:
            while not fut.done():
                try:
                    idx, tok = tokens_q.get(timeout=0.05)
                except _queue.Empty:
                    if deadline is not None \
                            and time.monotonic() >= deadline \
                            and fut.cancel():
                        # still queued past the wire deadline: refuse
                        # late service (a running sequence is failed
                        # by the scheduler's own deadline check)
                        raise DeadlineExceeded(
                            "wire deadline expired while the prompt "
                            "was queued")
                    continue
                stream_line(idx, tok)
                sent += 1
            # every token is enqueued before the future settles, so a
            # final non-blocking drain empties the stream
            while True:
                try:
                    idx, tok = tokens_q.get_nowait()
                except _queue.Empty:
                    break
                stream_line(idx, tok)
                sent += 1
            try:
                res = self._result_or_504(fut, 0)  # done: no block
            except BaseException as e:
                if not fut.cancelled():
                    ModelRegistry.record_outcome(brk, e)
                raise
            ModelRegistry.record_outcome(brk, None)
            ensure_started()
            handler.send_chunk(json.dumps(
                {"done": True,
                 "tokens": [int(t) for t in res.tokens],
                 "n": len(res.tokens),
                 "finish_reason": res.finish_reason,
                 "trace_id": ctx.trace_id}).encode() + b"\n")
            self._count_status(200)
            self.metrics.counter("frontend/generate_tokens").inc(sent)
            return True
        except BaseException as e:
            fut.cancel()
            if not started[0]:
                raise  # real status (and the cutover retry) upstream
            if isinstance(e, ConnectionError):
                self.metrics.counter(
                    "frontend/client_disconnects").inc()
                return False
            status, body_, _hdrs = self._classify(e)
            if status >= 500 and status != 504 \
                    and not isinstance(e, _HTTPError):
                logger.exception(
                    "frontend mid-generate 5xx after %d tokens", sent)
            self._count_status(status)
            try:
                handler.send_chunk(json.dumps(
                    {"error": body_["error"], "status": status,
                     "tokens_streamed": sent}).encode() + b"\n")
            except ConnectionError:
                pass
            return False
        finally:
            if started[0]:
                try:
                    handler.end_chunked()
                except ConnectionError:
                    pass

    def _run_predict(self, handler, name, version, body, ctype,
                     accept, tenant, deadline_ms, trace_id) -> None:
        """The whole exchange for one POST .../predict."""
        t0 = time.monotonic()
        self.metrics.counter("frontend/requests").inc()
        self.qos.admit(tenant)  # raises 429/403 before any queue touch
        deadline = (t0 + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        ctx = RequestContext(trace_id=trace_id, tenant=tenant,
                             deadline=deadline)
        key, backend, brk = self._resolve(name, version)
        x, rows = self._parse_body(body, ctype)
        ok = False
        try:
            for attempt in range(3):
                key, backend, brk = self._resolve_pinned(name, version)
                try:  # pin held: EVERY exit path below must unpin
                    max_batch = self._backend_max_batch(backend)
                    if rows <= max_batch:
                        out = self._predict_once(backend, x, deadline,
                                                 ctx, brk)
                        self._respond_single(handler, key, ctx, out,
                                             accept)
                        ok = True
                    else:
                        ok = self._respond_stream(
                            handler, key, backend, x, rows, max_batch,
                            deadline, ctx, brk)
                    break
                except ServiceClosed:
                    # the pinned version closed under us — only a
                    # cutover racing the pin can do that, and nothing
                    # was served yet (an accepted request drains before
                    # close): re-resolve onto the successor.  Inference
                    # is idempotent, so the retry is safe.
                    if attempt == 2 or version is not None:
                        raise
                finally:
                    self.inflight.exit(key)
        finally:
            self.qos.record_result(tenant, time.monotonic() - t0, ok)
            self._latency_h.observe(time.monotonic() - t0)

    def _respond_single(self, handler, key, ctx, out, accept) -> None:
        name, version = key
        headers = {"X-Trace-Id": ctx.trace_id,
                   "X-Model-Version": str(version)}
        if accept == _NPY and isinstance(out, np.ndarray):
            buf = BytesIO()
            np.save(buf, out, allow_pickle=False)
            handler.send_body(200, buf.getvalue(), _NPY, headers)
            return
        body = json.dumps({
            "model": name, "version": version,
            "trace_id": ctx.trace_id,
            "outputs": _jsonify(out)}).encode("utf-8")
        handler.send_body(200, body, "application/json", headers)

    def _respond_stream(self, handler, key, backend, x, rows,
                        max_batch, deadline, ctx, brk) -> bool:
        """Chunked ndjson for a multi-chunk predict: bounded in-flight
        submission window, one line per chunk in input order.  The 200
        chunked header is committed only when the FIRST chunk result
        is ready — a failure before that (expired deadline, sustained
        overload, a cutover closing the pinned version) propagates to
        the caller and gets its REAL status code (504/429/503 with
        Retry-After et al.) instead of a 200 wrapping an error line;
        after commitment, a mid-stream failure terminates the stream
        with an ``error`` line (the client sees exactly which offset
        failed).  Returns whether the whole stream completed.  Exactly
        ONE response status is counted, here."""
        name, version = key
        started = [False]

        def ensure_started():
            if not started[0]:
                handler.start_chunked(
                    200, _NDJSON,
                    {"X-Trace-Id": ctx.trace_id,
                     "X-Model-Version": str(version)})
                started[0] = True

        def leaf_slice(lo, hi):
            if isinstance(x, dict):
                return {k: v[lo:hi] for k, v in x.items()}
            return x[lo:hi]

        def remaining():
            if deadline is None:
                return None
            return max(0.0, deadline - time.monotonic())

        inflight = []  # [(offset, n, future)]
        sent = 0
        stalls = 0
        try:
            for off in range(0, rows, max_batch):
                hi = min(off + max_batch, rows)
                chunk = leaf_slice(off, hi)
                while True:
                    if deadline is not None \
                            and time.monotonic() >= deadline:
                        raise DeadlineExceeded(
                            f"deadline passed after {sent} of {rows} "
                            f"rows streamed")
                    try:
                        fut = self._submit(backend, chunk, deadline,
                                           ctx)
                        inflight.append((off, hi - off, fut))
                        stalls = 0
                        break
                    except ServiceOverloaded as e:
                        if inflight:
                            sent += self._flush_one(handler, inflight,
                                                    remaining(), brk,
                                                    ensure_started)
                            continue
                        # foreign traffic owns the queue: honor the
                        # drain hint briefly instead of hot-spinning,
                        # but give up eventually on a deadline-less
                        # stream rather than parking a server thread
                        # forever
                        stalls += 1
                        if deadline is None and stalls > 200:
                            raise
                        time.sleep(min(0.05, (e.retry_after_ms or 10.0)
                                       / 1e3))
                while len(inflight) >= self._stream_window:
                    sent += self._flush_one(handler, inflight,
                                            remaining(), brk,
                                            ensure_started)
            while inflight:
                sent += self._flush_one(handler, inflight, remaining(),
                                        brk, ensure_started)
            ensure_started()  # unreachable-empty guard: rows >= 2 chunks
            handler.send_chunk(json.dumps(
                {"done": True, "rows": sent,
                 "trace_id": ctx.trace_id}).encode() + b"\n")
            self._count_status(200)
            return True
        except BaseException as e:
            # cancel FIRST: the commonest mid-stream failure is the
            # client hanging up, in which case the error-line write
            # below raises too — the backlog must not keep occupying
            # backend queue slots for a request nobody is reading
            for _off, _n, fut in inflight:
                fut.cancel()
            if not started[0]:
                # nothing sent yet: the caller can still answer with
                # the REAL status code (and _run_predict's cutover
                # retry on ServiceClosed still applies)
                raise
            if isinstance(e, ConnectionError):
                # the client hung up mid-stream — THEIR outcome, not a
                # server fault: no traceback, and no responses_5xx
                # (which would corrupt the 5xx SLO signal on every
                # reset); a dedicated counter keeps it observable
                self.metrics.counter(
                    "frontend/client_disconnects").inc()
                return False
            status, body, _hdrs = self._classify(e)
            if status >= 500 and status != 504 \
                    and not isinstance(e, _HTTPError):
                # same contract as do_POST's 5xx path: an internal bug
                # after the 200 header is committed must still leave a
                # traceback, not vanish into an ndjson error line
                logger.exception(
                    "frontend mid-stream 5xx after %d rows", sent)
            self._count_status(status)
            try:
                handler.send_chunk(json.dumps(
                    {"error": body["error"], "status": status,
                     "rows_streamed": sent}).encode() + b"\n")
            except ConnectionError:
                pass  # client already gone
            return False
        finally:
            if started[0]:
                try:
                    handler.end_chunked()
                except ConnectionError:
                    pass

    def _flush_one(self, handler, inflight, timeout, brk,
                   ensure_started) -> int:
        """Resolve the OLDEST in-flight chunk and stream its line (the
        200 chunked header is committed here, by the FIRST result —
        see _respond_stream)."""
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        off, n, fut = inflight.pop(0)
        try:
            out = self._result_or_504(fut, timeout)
        except BaseException as e:
            if not fut.cancelled():
                ModelRegistry.record_outcome(brk, e)
            raise
        ModelRegistry.record_outcome(brk, None)
        ensure_started()
        handler.send_chunk(json.dumps(
            {"offset": off, "rows": n,
             "outputs": _jsonify(out)}).encode() + b"\n")
        self.metrics.counter("frontend/stream_chunks").inc()
        return n

    # -- error mapping -----------------------------------------------------
    @staticmethod
    def _classify(e: BaseException):
        """Exception → (status, json_body, headers)."""
        if isinstance(e, _HTTPError):
            return e.status, e.body, e.headers
        if isinstance(e, ServiceOverloaded):  # incl. TenantRateLimited
            err = _shed_error(e)
            return err.status, err.body, err.headers
        if isinstance(e, DeadlineExceeded):
            return 504, {"error": str(e)}, {}
        if isinstance(e, UnknownTenantError):
            return 403, {"error": str(e)}, {}
        if isinstance(e, ServiceClosed):
            return 503, {"error": str(e)}, {}
        # NO blanket ValueError/TypeError → 400: client-driven parse
        # and validation errors are wrapped in _HTTPError where they
        # are raised, so an unexpected one here is a server bug that
        # must report 500 and hit the 5xx traceback log, not hide as
        # a client error
        return 500, {"error": f"{type(e).__name__}: {e}"}, {}

    def _count_status(self, status: int) -> None:
        if status == 429:
            self.metrics.counter("frontend/sheds").inc()
        if status == 504:
            self.metrics.counter("frontend/deadline_504").inc()
        bucket = f"responses_{status // 100}xx"
        self.metrics.counter(f"frontend/{bucket}").inc()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        """Bind + serve; idempotent.  Returns the bound port.  The
        ``core`` knob picks the connection core: ``"eventloop"`` (the
        default — a few selector loop threads own every socket,
        optionally SO_REUSEPORT-sharded) or ``"threaded"`` (the
        thread-per-connection stdlib core).  Both speak the identical
        wire surface."""
        if self._httpd is not None or self._elc is not None:
            return self.port
        if self.core == "eventloop":
            from bigdl_tpu_torch.frontend.eventloop import EventLoopCore
            self._elc = EventLoopCore(
                self, host=self.host, port=self.requested_port,
                shards=self._shards, reuse_port=self._reuse_port,
                idle_timeout_s=self._idle_timeout_s,
                pin_cpus=self._pin_cpus)
            self.port = self._elc.start()
            logger.info(
                "wire frontend listening on http://%s:%d "
                "(event-loop core, %d shard(s); POST "
                "/v1/models/<name>/predict)", self.host, self.port,
                self._shards)
            return self.port
        return self._start_threaded()

    def _start_threaded(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1: keep-alive + chunked transfer encoding (the
            # streaming predict path needs it); every non-chunked
            # response therefore MUST carry Content-Length
            protocol_version = "HTTP/1.1"
            # buffered response writes + TCP_NODELAY: the stdlib
            # default (unbuffered wfile) emits every header line as
            # its own segment, and Nagle + delayed-ACK turns that
            # into ~40 ms per exchange on loopback — measured by the
            # bench's wire_overhead_ms before this pair of lines
            wbufsize = 64 * 1024
            disable_nagle_algorithm = True
            # idle keep-alive connections die after this many seconds
            # (the threaded twin of the event-loop core's reaper; None
            # keeps the historical wait-forever behavior)
            timeout = server._idle_timeout_s or None

            def log_message(self, fmt, *args):
                logger.debug("frontend: " + fmt, *args)

            def finish(self):
                try:
                    super().finish()
                finally:
                    # admitted in verify_request; released exactly once
                    # per connection, however the handler exits
                    server._conns.release()

            # -- response primitives the server methods drive ----------
            def send_body(self, status, body: bytes, ctype: str,
                          headers: Optional[dict] = None) -> None:
                server._count_status(status)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
                self.wfile.flush()  # buffered wfile + keep-alive

            def send_json(self, status, obj,
                          headers: Optional[dict] = None) -> None:
                self.send_body(status, json.dumps(obj).encode(),
                               "application/json", headers)

            def start_chunked(self, status, ctype,
                              headers: Optional[dict] = None) -> None:
                # status accounting happens at stream END (success or
                # error line) — see _respond_stream
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Transfer-Encoding", "chunked")
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()

            def send_chunk(self, data: bytes) -> None:
                if data:
                    self.wfile.write(
                        f"{len(data):x}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()  # stream lines land promptly

            def end_chunked(self) -> None:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            def check_auth(self) -> bool:
                """True when no token is configured (historical open
                loopback) or the request carries the right bearer.
                Refuses with 401 BEFORE the body is read (so the
                connection closes — the 411/413 keep-alive desync
                guard) and never echoes the expected token."""
                tok = server._auth_token
                if not tok:
                    return True
                hdr = self.headers.get("Authorization", "")
                if hdr.startswith("Bearer ") and hmac.compare_digest(
                        hdr[len("Bearer "):].strip(), tok):
                    return True
                self.close_connection = True  # body (if any) unread
                try:
                    self.send_json(
                        401, {"error": "missing or invalid bearer "
                                       "token"},
                        {"WWW-Authenticate": "Bearer"})
                except ConnectionError:
                    pass
                return False

            # -- routes -------------------------------------------------
            def do_GET(self):  # noqa: N802 - stdlib API
                if not self.check_auth():
                    return
                if self.path == "/v1/models":
                    self.send_json(200, {"models": server.models()})
                else:
                    self.send_json(404, {
                        "error": f"no route {self.path}",
                        "routes": ["/v1/models",
                                   "POST /v1/models/<name>[:<v>]"
                                   "/predict",
                                   "POST /v1/models/<name>[:<v>]"
                                   "/generate"]})

            def do_POST(self):  # noqa: N802 - stdlib API
                if not self.check_auth():
                    return
                m = _PREDICT_RE.match(self.path)
                gen = None if m is not None \
                    else _GENERATE_RE.match(self.path)
                if m is None and gen is None:
                    # the request body is never read on this path — a
                    # keep-alive stream would parse it as the next
                    # request line, so close (same guard as 411/413)
                    self.close_connection = True
                    self.send_json(404, {"error": f"no route "
                                                  f"{self.path}"})
                    return
                body_read = False
                try:
                    te = (self.headers.get("Transfer-Encoding")
                          or "").strip().lower()
                    if te:
                        # chunked request bodies: drive the SAME
                        # incremental de-chunker the event-loop parser
                        # embeds over this core's blocking rfile
                        from bigdl_tpu_torch.frontend.http1 import (
                            ProtocolError, read_chunked_body)
                        if self.headers.get("Content-Length") \
                                is not None:
                            raise _HTTPError(
                                400, "both Content-Length and "
                                     "Transfer-Encoding present")
                        if te != "chunked":
                            raise _HTTPError(
                                501, f"unsupported transfer coding "
                                     f"{te!r}")
                        try:
                            body = read_chunked_body(self.rfile,
                                                     _MAX_BODY)
                        except ProtocolError as e:
                            raise _HTTPError(e.status,
                                             str(e)) from None
                    else:
                        try:
                            length = int(self.headers.get(
                                "Content-Length", -1))
                        except ValueError:
                            raise _HTTPError(
                                400, "unreadable "
                                     "Content-Length") from None
                        if length < 0:
                            raise _HTTPError(
                                411, "Content-Length required")
                        if length > _MAX_BODY:
                            raise _HTTPError(
                                413, f"body of {length} bytes exceeds "
                                     f"the {_MAX_BODY} byte cap")
                        body = self.rfile.read(length)
                    body_read = True
                    deadline_ms = self.headers.get("X-Deadline-Ms")
                    if deadline_ms is not None:
                        try:
                            deadline_ms = float(deadline_ms)
                        except ValueError:
                            raise _HTTPError(
                                400, f"bad X-Deadline-Ms "
                                     f"{deadline_ms!r}") from None
                    route = m if m is not None else gen
                    version = route.group("version")
                    ctype = (self.headers.get("Content-Type") or
                             "").split(";")[0].strip().lower()
                    if m is not None:
                        server._traced_predict(
                            self, m.group("name"),
                            int(version) if version else None, body,
                            ctype,
                            (self.headers.get("Accept") or
                             "").split(",")[0].strip().lower(),
                            self.headers.get("X-Tenant"), deadline_ms,
                            self.headers.get("X-Trace-Id"))
                    else:
                        server._traced_generate(
                            self, gen.group("name"),
                            int(version) if version else None, body,
                            ctype, self.headers.get("X-Tenant"),
                            deadline_ms,
                            self.headers.get("X-Trace-Id"))
                except ConnectionError:
                    # client went away mid-exchange (pipe break OR
                    # hard reset) — nothing to send, and letting it
                    # escape would have socketserver print a traceback
                    # per reset
                    pass
                except BaseException as e:
                    status, body_, hdrs = server._classify(e)
                    if status >= 500 and status != 504 \
                            and not isinstance(e, _HTTPError):
                        # 504 is a client-driven outcome (its own
                        # counter tracks it), not a server fault worth
                        # a traceback per expiry
                        logger.exception("frontend 5xx on %s",
                                         self.path)
                    if not body_read:
                        # the request body is still sitting unread on
                        # the keep-alive stream (411/413 reject) — a
                        # persistent connection would parse it as the
                        # next request line, so close instead
                        self.close_connection = True
                    try:
                        self.send_json(status, body_, hdrs)
                    except ConnectionError:
                        pass

        class _Httpd(ThreadingHTTPServer):
            daemon_threads = True
            # socketserver's default backlog of 5 SYN-drops any
            # connect burst; keep the threaded baseline comparable in
            # the bench connection sweep
            request_queue_size = 1024

            def verify_request(self, request, client_address):
                # the hard connection cap, enforced BEFORE a handler
                # thread is spawned — socketserver closes the refused
                # socket itself (the cheap-refusal contract both cores
                # share)
                return server._conns.try_admit()

        self._httpd = _Httpd(
            (self.host, self.requested_port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="bigdl-tpu-frontend", daemon=True)
        self._thread.start()
        logger.info("wire frontend listening on http://%s:%d "
                    "(POST /v1/models/<name>/predict)", self.host,
                    self.port)
        return self.port

    def _traced_predict(self, handler, name, version, body, ctype,
                        accept, tenant, deadline_ms, trace_id) -> None:
        tracer = self.tracer
        if tracer is None or not tracer.enabled:
            self._run_predict(handler, name, version, body, ctype,
                              accept, tenant, deadline_ms, trace_id)
            return
        if trace_id is None:
            # mint HERE, not later in the RequestContext, so the
            # wire_request span carries the id — otherwise stories for
            # clients that sent no X-Trace-Id would be missing their
            # wire hop (the id still flows down and is echoed)
            from bigdl_tpu_torch.telemetry.context import new_trace_id
            trace_id = new_trace_id()
        status_box = {"status": 200}
        try:
            with tracer.span("wire_request", cat="serving",
                             model=name, tenant=tenant,
                             trace_id=trace_id):
                try:
                    self._run_predict(handler, name, version, body,
                                      ctype, accept, tenant,
                                      deadline_ms, trace_id)
                except BaseException as e:
                    status_box["status"] = self._classify(e)[0]
                    raise
        finally:
            if status_box["status"] != 200:
                tracer.instant("wire_error", cat="serving",
                               model=name, tenant=tenant,
                               status=status_box["status"])

    def _traced_generate(self, handler, name, version, body, ctype,
                         tenant, deadline_ms, trace_id) -> None:
        """Span-wrapping twin of :meth:`_traced_predict` for the
        generate route (same mint-here trace-id reasoning)."""
        tracer = self.tracer
        if tracer is None or not tracer.enabled:
            self._run_generate(handler, name, version, body, ctype,
                               tenant, deadline_ms, trace_id)
            return
        if trace_id is None:
            from bigdl_tpu_torch.telemetry.context import new_trace_id
            trace_id = new_trace_id()
        status_box = {"status": 200}
        try:
            with tracer.span("wire_request", cat="serving",
                             model=name, tenant=tenant,
                             trace_id=trace_id):
                try:
                    self._run_generate(handler, name, version, body,
                                       ctype, tenant, deadline_ms,
                                       trace_id)
                except BaseException as e:
                    status_box["status"] = self._classify(e)[0]
                    raise
        finally:
            if status_box["status"] != 200:
                tracer.instant("wire_error", cat="serving",
                               model=name, tenant=tenant,
                               status=status_box["status"])

    @property
    def running(self) -> bool:
        if self._elc is not None:
            return self._elc.running
        return self._thread is not None and self._thread.is_alive()

    @property
    def open_connections(self) -> int:
        """Live connection count (same number the
        ``frontend/open_connections`` gauge exports)."""
        return self._conns.open

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def stop(self) -> None:
        elc, self._elc = self._elc, None
        if elc is not None:
            elc.stop()
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._admin_name is not None:
            from bigdl_tpu_torch.telemetry import admin as _admin
            _srv = _admin.current()
            if _srv is not None:
                _srv.remove_source(self._admin_name)
            self._admin_name = None

    def __enter__(self) -> "FrontendServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

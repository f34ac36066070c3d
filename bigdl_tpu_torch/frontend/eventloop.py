"""EventLoopCore — the selectors-based non-blocking connection core.

Port of ``bigdl_tpu/frontend/eventloop.py`` (an owned copy).  The
threaded core serves every connection on its own OS thread, a hard
ceiling long before "heavy traffic from millions of users".  Here one (or a few, with SO_REUSEPORT sharding)
loop threads own ALL sockets through a ``selectors`` readiness loop:
HTTP/1.1 is parsed incrementally (``frontend/http1.py``), requests run
through the SAME QoS-admission → resolve-and-pin → batcher submit path
as the threaded core, and responses — including chunked ndjson streams
— are written from future-completion callbacks with per-connection
write buffering and backpressure.  No thread per connection anywhere;
an idle connection costs one socket and ~1 KiB of parser state.

Threading model / lock contract (the GL2xx + lockdep story)
-----------------------------------------------------------
Single-owner discipline: every ``_Conn`` and ``_Exchange`` field is
touched ONLY from the one ``_Loop`` thread that accepted the
connection — no locks guard them, BY CONTRACT, because the only
cross-thread entry into a loop is :meth:`_Loop.call_soon`, whose ready
deque is the sole shared structure (guarded by its own lock).  Future
done-callbacks fire on batcher/ReplicaSet worker threads and therefore
never touch an exchange directly: they ``call_soon`` a bound method
and return.  Timers (``call_later``/``call_at``) are created and fired
on the loop thread only.  Everything shared across loops — the
connection ledger, the MetricRegistry, ``_WireInflight``, the QoS
gate — carries its own internal lock and is documented at its
definition site.

Semantic parity: the entire wire surface (status taxonomy,
auth-before-body, streaming order + ``{"done":true}`` trailer, version
pinning, keep-alive desync guards, zero-drop cutover draining) is
mirrored method-for-method from ``server.py``'s threaded core; the wire tests of
``tests/test_torch_frontend.py`` run against both cores.
"""

from __future__ import annotations

import heapq
import hmac
import json
import logging
import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import List, Optional

from bigdl_tpu_torch.frontend.http1 import (CHUNK_TRAILER, ProtocolError,
                                            RequestParser, encode_chunk,
                                            render_head)

logger = logging.getLogger("bigdl_tpu_torch.frontend")

_READ_CHUNK = 64 * 1024
# write-buffer watermarks: a stream stops pumping results above HIGH
# and resumes below LOW, so one slow reader bounds its own memory
# instead of ballooning the loop's
_HIGH_WATER = 256 * 1024
_LOW_WATER = 64 * 1024
_ACCEPTS_PER_TICK = 64  # accept bursts can't starve established conns


class _Timer:
    """Cancelable loop-thread timer handle (heap entries are lazily
    skipped once cancelled)."""

    __slots__ = ("when", "fn", "cancelled")

    def __init__(self, when: float, fn):
        self.when = when
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class _Loop(threading.Thread):
    """One selector loop thread.  All registered sockets, timers and
    connection state are owned by this thread (single-owner — see the
    module docstring); ``call_soon`` is the only cross-thread entry."""

    def __init__(self, core: "EventLoopCore", idx: int):
        super().__init__(name=f"bigdl-tpu-frontend-loop{idx}",
                         daemon=True)
        self.core = core
        self.idx = idx
        self._sel = selectors.DefaultSelector()
        r, w = socket.socketpair()
        r.setblocking(False)
        w.setblocking(False)
        self._wake_r, self._wake_w = r, w
        self._lock = threading.Lock()
        self._ready = deque()   # guarded-by: _lock (sole cross-thread entry)
        self._woken = False     # guarded-by: _lock (coalesces wake bytes)
        self._timers: List = []  # loop-thread only (heap of (when, seq, _Timer))
        self._seq = 0            # loop-thread only
        self._stopping = False   # loop-thread only (set via call_soon)
        self.conns: set = set()  # loop-thread only
        self.listener: Optional[socket.socket] = None

    # -- cross-thread entry ------------------------------------------------
    def call_soon(self, fn, *args) -> None:
        """Schedule ``fn(*args)`` on the loop thread.  Safe from any
        thread (and from the loop thread itself)."""
        with self._lock:
            self._ready.append((fn, args))
            woken, self._woken = self._woken, True
        if not woken:
            try:
                self._wake_w.send(b"\0")
            except OSError:
                pass  # loop tearing down — nothing left to wake

    # -- loop-thread-only scheduling --------------------------------------
    def call_later(self, delay: float, fn) -> _Timer:
        return self.call_at(time.monotonic() + max(0.0, delay), fn)

    def call_at(self, when: float, fn) -> _Timer:
        t = _Timer(when, fn)
        self._seq += 1
        heapq.heappush(self._timers, (when, self._seq, t))
        return t

    # -- lifecycle ---------------------------------------------------------
    def add_listener(self, lsock: socket.socket) -> None:
        lsock.setblocking(False)
        self.listener = lsock

    def request_stop(self) -> None:
        self.call_soon(self._do_stop)

    def _do_stop(self) -> None:
        self._stopping = True

    def run(self) -> None:
        if self.core.pin_cpus:
            # pin this shard to one CPU (loop i → available cpu i mod
            # count): shards stop migrating across cores under load.
            # Silently inert where unsupported (macOS/Windows have no
            # sched_setaffinity) — the knob is best-effort by contract
            try:
                cpus = sorted(os.sched_getaffinity(0))
                if cpus:
                    os.sched_setaffinity(
                        0, {cpus[self.idx % len(cpus)]})
            except (AttributeError, OSError, ValueError):
                pass
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        if self.listener is not None:
            self._sel.register(self.listener, selectors.EVENT_READ,
                               self._on_accept_ready)
        if self.core.idle_timeout_s > 0:
            period = min(max(self.core.idle_timeout_s / 2.0, 0.05), 5.0)
            self.call_later(period, self._reap_tick)
        try:
            while True:
                now = time.monotonic()
                due = []
                while self._timers:
                    when, _seq, t = self._timers[0]
                    if t.cancelled:
                        heapq.heappop(self._timers)
                        continue
                    if when > now:
                        break
                    heapq.heappop(self._timers)
                    due.append(t)
                for t in due:
                    self._safe(t.fn)
                timeout = None
                if self._timers:
                    timeout = max(0.0, self._timers[0][0]
                                  - time.monotonic())
                with self._lock:
                    if self._ready:
                        timeout = 0.0
                for key, mask in self._sel.select(timeout):
                    if key.data is None:  # waker: drain the byte
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                        continue
                    self._safe(key.data, mask)
                with self._lock:
                    ready, self._ready = self._ready, deque()
                    self._woken = False
                for fn, args in ready:
                    self._safe(fn, *args)
                if self._stopping:
                    return
        finally:
            for conn in list(self.conns):
                conn.destroy_at_stop()
            self.conns.clear()
            if self.listener is not None:
                try:
                    self._sel.unregister(self.listener)
                except (KeyError, ValueError):
                    pass
                self.listener.close()
            try:
                self._sel.unregister(self._wake_r)
            except (KeyError, ValueError):
                pass
            self._wake_r.close()
            self._wake_w.close()
            self._sel.close()

    @staticmethod
    def _safe(fn, *args) -> None:
        """One callback must never kill the loop (it owns every other
        connection too)."""
        try:
            fn(*args)
        except BaseException:
            logger.exception("frontend loop callback failed")

    # -- accepting ---------------------------------------------------------
    def _on_accept_ready(self, _mask) -> None:
        for _ in range(_ACCEPTS_PER_TICK):
            try:
                sock, _addr = self.listener.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # listener closing under us (stop path)
            if not self.core.ledger.try_admit():
                # past the hard cap: the refusal is this close() — no
                # parser, no conn object, no thread, nothing to reap
                sock.close()
                continue
            target = self.core.pick_loop(self)
            if target is self:
                _Conn(self.core, self, sock)
            else:
                # single-listener fallback (no SO_REUSEPORT): hand the
                # socket to its owning loop — the conn is CONSTRUCTED
                # there, so single-owner discipline holds from byte 0
                target.call_soon(_Conn, self.core, target, sock)

    # -- idle reaping ------------------------------------------------------
    def _reap_tick(self) -> None:
        if self._stopping:
            return
        cutoff = time.monotonic() - self.core.idle_timeout_s
        for conn in list(self.conns):
            if conn.exchange is None and not conn.out_pending \
                    and conn.last_activity < cutoff:
                conn.close(reaped=True)
        period = min(max(self.core.idle_timeout_s / 2.0, 0.05), 5.0)
        self.call_later(period, self._reap_tick)


class _Conn:
    """One accepted connection.  Single-owner: every field is touched
    only on ``self.loop``'s thread (see module docstring — this is the
    loop-owned-state discipline graftlint's catalog documents)."""

    __slots__ = ("core", "loop", "sock", "parser", "exchange",
                 "head_checked", "peer_eof", "closing", "closed",
                 "last_activity", "_out", "_out_len", "_mask",
                 "_registered", "_pumping")

    def __init__(self, core: "EventLoopCore", loop: _Loop,
                 sock: socket.socket):
        self.core = core
        self.loop = loop
        self.sock = sock
        sock.setblocking(False)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self.parser = RequestParser()
        self.exchange = None          # active _Exchange, at most one
        self.head_checked = False     # early checks ran for current head
        self.peer_eof = False
        self.closing = False          # flush remaining output, then close
        self.closed = False
        self.last_activity = time.monotonic()
        self._out = deque()           # buffered response bytes
        self._out_len = 0
        self._mask = selectors.EVENT_READ
        self._registered = True
        self._pumping = False
        loop._sel.register(sock, self._mask, self._on_events)
        loop.conns.add(self)

    # -- readiness ---------------------------------------------------------
    def _on_events(self, mask) -> None:
        if mask & selectors.EVENT_WRITE:
            self._flush()
        if not self.closed and (mask & selectors.EVENT_READ):
            self._on_readable()

    def _set_interest(self, read: bool, write: bool) -> None:
        mask = (selectors.EVENT_READ if read else 0) \
            | (selectors.EVENT_WRITE if write else 0)
        if mask == self._mask or self.closed:
            return
        self._mask = mask
        if mask == 0:
            # zero interest (half-closed peer, nothing to write, an
            # exchange still computing): unregister entirely — a dead
            # read side left registered would wake every tick forever
            if self._registered:
                self.loop._sel.unregister(self.sock)
                self._registered = False
        elif not self._registered:
            self.loop._sel.register(self.sock, mask, self._on_events)
            self._registered = True
        else:
            self.loop._sel.modify(self.sock, mask, self._on_events)

    def _on_readable(self) -> None:
        try:
            data = self.sock.recv(_READ_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._abort()
            return
        if not data:
            # EOF ≠ gone: a half-closed client may still be reading
            # its response (the threaded core only learns of a real
            # disconnect from a failed WRITE — mirror that, but stop
            # polling a forever-readable dead read side)
            self.peer_eof = True
            self._set_interest(False, bool(self._out))
            if self.exchange is None and not self._out:
                self.close()
            return
        self.last_activity = time.monotonic()
        self.parser.feed(data)
        self.pump()

    # -- request framing → dispatch ---------------------------------------
    def pump(self) -> None:
        """Drive parsed requests into the core, one exchange at a time
        (no pipelining overlap: the next buffered request starts only
        after the current exchange finishes — same ordering the
        threaded core's sequential handler loop gives).  Re-entrant
        calls (an exchange that fails synchronously finishes inside
        ``dispatch``) flatten into the outer loop instead of
        recursing per buffered request."""
        if self._pumping:
            return
        self._pumping = True
        try:
            self._pump_inner()
        finally:
            self._pumping = False

    def _pump_inner(self) -> None:
        while not self.closed and not self.closing \
                and self.exchange is None:
            try:
                head = self.parser.head()
                if head is None:
                    return
                if not self.head_checked:
                    if not self.core.early_check(self, head):
                        return  # responded + closing
                    self.head_checked = True
                req = self.parser.poll()
                if req is None:
                    return
            except ProtocolError as e:
                self.core.protocol_error(self, e)
                return
            self.head_checked = False
            self.last_activity = time.monotonic()
            self.core.dispatch(self, req)

    def exchange_done(self, keep_alive: bool) -> None:
        self.exchange = None
        if self.closed:
            return
        self.last_activity = time.monotonic()
        if not keep_alive or self.peer_eof:
            self.close_when_flushed()
        else:
            self.pump()

    # -- writing -----------------------------------------------------------
    @property
    def out_pending(self) -> int:
        return self._out_len

    def write(self, data: bytes) -> None:
        if self.closed or not data:
            return
        self._out.append(memoryview(bytes(data)))
        self._out_len += len(data)
        self._flush()

    def _flush(self) -> None:
        while self._out:
            buf = self._out[0]
            try:
                n = self.sock.send(buf)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._abort()
                return
            self._out_len -= n
            if n == len(buf):
                self._out.popleft()
            else:
                self._out[0] = buf[n:]
                break
        if self._out:
            self._set_interest(not self.peer_eof, True)
            return
        self._set_interest(not self.peer_eof, False)
        if self.closing:
            self.close()
        elif self._out_len < _LOW_WATER and self.exchange is not None:
            self.exchange.on_drain()

    def close_when_flushed(self) -> None:
        if self._out:
            self.closing = True
        else:
            self.close()

    # -- teardown ----------------------------------------------------------
    def _abort(self) -> None:
        """Peer-driven failure (reset / failed send): tear down and let
        the active exchange classify it as a client disconnect."""
        ex = self.exchange
        self._teardown(reaped=False)
        if ex is not None:
            ex.on_client_gone()

    def close(self, reaped: bool = False) -> None:
        self._teardown(reaped=reaped)

    def destroy_at_stop(self) -> None:
        """Server-stop teardown: abandon the exchange quietly (no
        disconnect accounting — the peer did nothing wrong)."""
        ex = self.exchange
        if ex is not None:
            ex.abandon()
        self._teardown(reaped=False)

    def _teardown(self, reaped: bool) -> None:
        if self.closed:
            return
        self.closed = True
        self.exchange = None
        try:
            self.loop._sel.unregister(self.sock)
        except (KeyError, ValueError):
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self.loop.conns.discard(self)
        self.core.ledger.release(reaped=reaped)


class EventLoopCore:
    """The loop-threaded connection core behind a
    :class:`~bigdl_tpu_torch.frontend.server.FrontendServer` (selected by its
    ``core="eventloop"`` knob — the default).  Owns the listening
    socket(s) and loop threads; all HTTP semantics delegate to the
    server object so both cores share one behavior surface."""

    def __init__(self, server, *, host: str, port: int, shards: int = 1,
                 reuse_port: bool = False, idle_timeout_s: float = 0.0,
                 pin_cpus: bool = False):
        self.server = server
        self.host = host
        self.requested_port = int(port)
        self.shards = max(1, int(shards))
        self.reuse_port = bool(reuse_port)
        self.idle_timeout_s = float(idle_timeout_s)
        self.pin_cpus = bool(pin_cpus)
        self.ledger = server._conns
        self.loops: List[_Loop] = []
        self.port: Optional[int] = None
        self._fanout = False  # single listener feeding several loops
        self._rr = 0  # round-robin cursor (accepting-loop thread only)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        n = self.shards
        has_reuseport = hasattr(socket, "SO_REUSEPORT")
        want_reuseport = self.reuse_port or n > 1
        if n > 1 and not has_reuseport:
            logger.warning(
                "frontend: SO_REUSEPORT unavailable on this platform — "
                "falling back to one shared listener fanned out across "
                "%d loops", n)
        self.loops = [_Loop(self, i) for i in range(n)]
        listeners: List[socket.socket] = []
        try:
            first = self._bind(self.requested_port,
                               want_reuseport and has_reuseport)
            listeners.append(first)
            self.port = first.getsockname()[1]
            if n > 1 and has_reuseport:
                for _ in range(n - 1):
                    listeners.append(self._bind(self.port, True))
        except BaseException:
            for ls in listeners:
                ls.close()
            raise
        if len(listeners) == len(self.loops):
            for loop, ls in zip(self.loops, listeners):
                loop.add_listener(ls)
        else:
            self._fanout = True
            self.loops[0].add_listener(listeners[0])
        for loop in self.loops:
            loop.start()
        return self.port

    def _bind(self, port: int, reuseport: bool) -> socket.socket:
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if reuseport:
                ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            ls.bind((self.host, port))
            # deep backlog: a C100K connect burst must queue in the
            # kernel (clamped to somaxconn), not SYN-drop into client
            # retransmit backoff
            ls.listen(4096)
        except BaseException:
            ls.close()
            raise
        return ls

    def stop(self) -> None:
        for loop in self.loops:
            loop.request_stop()
        for loop in self.loops:
            loop.join(timeout=2.0)
        self.loops = []

    @property
    def running(self) -> bool:
        return any(loop.is_alive() for loop in self.loops)

    def pick_loop(self, accepting: _Loop) -> _Loop:
        """Owning loop for a fresh connection.  With per-loop
        SO_REUSEPORT listeners the kernel already sharded — the
        accepting loop keeps it; the single-listener fallback
        round-robins (cursor touched only by the one accepting
        loop)."""
        if not self._fanout:
            return accepting
        self._rr = (self._rr + 1) % len(self.loops)
        return self.loops[self._rr]

    # -- shared HTTP semantics (mirrors the threaded handler) -------------
    def _auth_ok(self, head) -> bool:
        tok = self.server._auth_token
        if not tok:
            return True
        hdr = head.get("authorization", "")
        return hdr.startswith("Bearer ") and hmac.compare_digest(
            hdr[len("Bearer "):].strip(), tok)

    def early_check(self, conn: _Conn, head) -> bool:
        """Checks that must answer BEFORE the body is read (the
        401/404/411/413 keep-alive desync guards — all of them close).
        True → proceed to body framing; False → responded."""
        from bigdl_tpu_torch.frontend.server import (_GENERATE_RE, _MAX_BODY,
                                                     _PREDICT_RE)
        if not self._auth_ok(head):
            self.respond(conn, 401,
                         {"error": "missing or invalid bearer token"},
                         {"WWW-Authenticate": "Bearer"}, close=True)
            return False
        if head.method == "GET":
            return True
        if head.method != "POST":
            self.respond(conn, 501,
                         {"error": f"unsupported method "
                                   f"{head.method!r}"}, close=True)
            return False
        if _PREDICT_RE.match(head.target) is None \
                and _GENERATE_RE.match(head.target) is None:
            self.respond(conn, 404,
                         {"error": f"no route {head.target}"},
                         close=True)
            return False
        if head.get("transfer-encoding"):
            # chunked framing: the parser's embedded ChunkedDecoder
            # enforces the whole 400/413/501 taxonomy itself (incl.
            # the TE+CL smuggling refusal), so no length check here
            return True
        cl = head.get("content-length")
        try:
            length = int(cl) if cl is not None else -1
        except ValueError:
            self.respond(conn, 400, {"error": "unreadable "
                                              "Content-Length"},
                         close=True)
            return False
        if length < 0:
            self.respond(conn, 411, {"error": "Content-Length "
                                              "required"}, close=True)
            return False
        if length > _MAX_BODY:
            self.respond(conn, 413,
                         {"error": f"body of {length} bytes exceeds "
                                   f"the {_MAX_BODY} byte cap"},
                         close=True)
            return False
        return True

    def protocol_error(self, conn: _Conn, e: ProtocolError) -> None:
        self.respond(conn, e.status, {"error": str(e)}, close=True)

    def respond(self, conn: _Conn, status: int, obj, headers=None,
                *, close: bool = False, keep_alive: bool = True) -> None:
        """One complete JSON response (counted — same accounting point
        as the threaded handler's ``send_json``)."""
        self.server._count_status(status)
        body = json.dumps(obj).encode("utf-8")
        hdrs = {"Content-Type": "application/json"}
        hdrs.update(headers or {})
        must_close = close or not keep_alive
        conn.write(render_head(status, hdrs, content_length=len(body),
                               close=must_close) + body)
        if must_close:
            conn.close_when_flushed()

    def dispatch(self, conn: _Conn, req) -> None:
        from bigdl_tpu_torch.frontend.server import _GENERATE_RE
        if req.method == "GET":
            if req.target == "/v1/models":
                self.respond(conn, 200, {"models": self.server.models()},
                             keep_alive=req.keep_alive)
            else:
                self.respond(conn, 404, {
                    "error": f"no route {req.target}",
                    "routes": ["/v1/models",
                               "POST /v1/models/<name>[:<v>]"
                               "/predict",
                               "POST /v1/models/<name>[:<v>]"
                               "/generate"]}, keep_alive=req.keep_alive)
            return
        if _GENERATE_RE.match(req.target) is not None:
            _GenExchange(self, conn, req).start()
            return
        _Exchange(self, conn, req).start()


class _Exchange:
    """One POST .../predict exchange as a loop-owned state machine —
    the async mirror of the threaded core's ``_run_predict`` /
    ``_respond_stream`` (single-owner: all fields loop-thread only;
    future callbacks re-enter via ``loop.call_soon``)."""

    def __init__(self, core: EventLoopCore, conn: _Conn, req):
        from bigdl_tpu_torch.frontend.server import _PREDICT_RE
        self.core = core
        self.server = core.server
        self.conn = conn
        self.loop = conn.loop
        self.req = req
        m = _PREDICT_RE.match(req.target)
        self.name = m.group("name")
        self.req_version = (int(m.group("version"))
                            if m.group("version") else None)
        self.ctype = (req.get("content-type") or "") \
            .split(";")[0].strip().lower()
        self.accept = (req.get("accept") or "") \
            .split(",")[0].strip().lower()
        self.tenant = req.get("x-tenant")
        self.trace_id = req.get("x-trace-id")
        self._settled = False
        self._entered = False   # past body parse → qos/latency recorded
        self._t0 = 0.0
        self._span_t0: Optional[int] = None
        self._key = None
        self._pinned = False
        self._backend = None
        self._brk = None
        self._attempt = 0
        self.deadline: Optional[float] = None
        self.ctx = None
        self.x = None
        self.rows = 0
        self._fut = None
        self._deadline_timer: Optional[_Timer] = None
        self._retry_timer: Optional[_Timer] = None
        # stream state
        self._max_batch = 0
        self._next_off = 0
        self._inflight: List = []  # [(offset, n, future)], oldest first
        self._sent = 0
        self._stalls = 0
        self._started = False
        self._paused = False

    # -- entry -------------------------------------------------------------
    def start(self) -> None:
        server = self.server
        raw_deadline = self.req.get("x-deadline-ms")
        deadline_ms = None
        if raw_deadline is not None:
            try:
                deadline_ms = float(raw_deadline)
            except ValueError:
                # pre-dispatch reject (mirrors do_POST: no requests
                # count, no trace span — the exchange never began)
                self.core.respond(self.conn, 400,
                                  {"error": f"bad X-Deadline-Ms "
                                            f"{raw_deadline!r}"},
                                  keep_alive=self.req.keep_alive)
                return
        tracer = server.tracer
        if tracer is not None and tracer.enabled:
            if self.trace_id is None:
                # mint HERE so the wire_request span carries the id
                # (same reasoning as the threaded _traced_predict)
                from bigdl_tpu_torch.telemetry.context import new_trace_id
                self.trace_id = new_trace_id()
            self._span_t0 = time.perf_counter_ns()
        self.conn.exchange = self
        self._t0 = time.monotonic()
        server.metrics.counter("frontend/requests").inc()
        try:
            server.qos.admit(self.tenant)
            self.deadline = (self._t0 + deadline_ms / 1e3
                             if deadline_ms is not None else None)
            from bigdl_tpu_torch.telemetry.context import RequestContext
            self.ctx = RequestContext(trace_id=self.trace_id,
                                      tenant=self.tenant,
                                      deadline=self.deadline)
            server._resolve(self.name, self.req_version)  # 404 precedence
            self.x, self.rows = server._parse_body(self.req.body,
                                                   self.ctype)
        except BaseException as e:
            self._finish_error(e)
            return
        self._entered = True
        self._begin_attempt()

    # -- resolve-and-pin attempts (the ServiceClosed cutover retry) --------
    def _begin_attempt(self) -> None:
        server = self.server
        try:
            key, backend, brk = server._resolve_pinned(self.name,
                                                       self.req_version)
        except BaseException as e:
            self._finish_error(e)
            return
        self._key, self._backend, self._brk = key, backend, brk
        self._pinned = True
        try:
            max_batch = server._backend_max_batch(backend)
            if self.rows <= max_batch:
                fut = server._submit(backend, self.x, self.deadline,
                                     self.ctx)
            else:
                self._stream_init(max_batch)
                return
        except BaseException as e:
            self._attempt_failed(e)
            return
        self._fut = fut
        if self.deadline is not None:
            self._deadline_timer = self.loop.call_at(
                self.deadline, self._on_single_deadline)
        fut.add_done_callback(
            lambda f: self.loop.call_soon(self._single_done, f))

    def _attempt_failed(self, e: BaseException) -> None:
        """A pinned attempt died before anything was served: unpin and
        either retry onto the cutover successor (idempotent — nothing
        left this server) or answer with the real status."""
        from bigdl_tpu_torch.serving.batcher import ServiceClosed
        self._unpin()
        self._cancel_timers()
        if isinstance(e, ServiceClosed) and self.req_version is None \
                and self._attempt < 2:
            self._attempt += 1
            self._begin_attempt()
            return
        self._finish_error(e)

    def _unpin(self) -> None:
        if self._pinned:
            self._pinned = False
            self.server.inflight.exit(self._key)  # releases: wire_inflight

    # -- single-response path ---------------------------------------------
    def _single_done(self, fut) -> None:
        if self._settled:
            return
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        try:
            out = self.server._result_or_504(fut, 0)  # done: no block
        except BaseException as e:
            if not fut.cancelled():
                ModelRegistry.record_outcome(self._brk, e)
            self._attempt_failed(e)
            return
        ModelRegistry.record_outcome(self._brk, None)
        self._respond_single(out)

    def _on_single_deadline(self) -> None:
        if self._settled:
            return
        from bigdl_tpu_torch.serving.batcher import DeadlineExceeded
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        fut = self._fut
        fut.cancel()  # refuse late service; batcher honors cancel
        e = DeadlineExceeded("wire deadline expired while the request "
                             "was queued")
        if not fut.cancelled():
            ModelRegistry.record_outcome(self._brk, e)
        self._attempt_failed(e)

    def _respond_single(self, out) -> None:
        import numpy as np
        from bigdl_tpu_torch.frontend.server import _NPY, _jsonify
        server = self.server
        name, version = self._key
        headers = {"X-Trace-Id": self.ctx.trace_id,
                   "X-Model-Version": str(version)}
        if self.accept == _NPY and isinstance(out, np.ndarray):
            from io import BytesIO
            buf = BytesIO()
            np.save(buf, out, allow_pickle=False)
            payload = buf.getvalue()
            headers["Content-Type"] = _NPY
            server._count_status(200)
            self.conn.write(render_head(200, headers,
                                        content_length=len(payload))
                            + payload)
        else:
            body = json.dumps({
                "model": name, "version": version,
                "trace_id": self.ctx.trace_id,
                "outputs": _jsonify(out)}).encode("utf-8")
            headers["Content-Type"] = "application/json"
            server._count_status(200)
            self.conn.write(render_head(200, headers,
                                        content_length=len(body))
                            + body)
        self._finish(200, ok=True)

    # -- streaming path ----------------------------------------------------
    def _stream_init(self, max_batch: int) -> None:
        # (re)entered per pinned attempt — a ServiceClosed retry onto
        # the cutover successor restarts the whole stream (nothing was
        # committed: retries only happen before the first result)
        self._max_batch = max_batch
        self._next_off = 0
        self._sent = 0
        self._stalls = 0
        self._paused = False
        if self.deadline is not None:
            self._deadline_timer = self.loop.call_at(
                self.deadline, self._on_stream_deadline)
        self._stream_tick()

    def _leaf_slice(self, lo: int, hi: int):
        if isinstance(self.x, dict):
            return {k: v[lo:hi] for k, v in self.x.items()}
        return self.x[lo:hi]

    def _stream_tick(self) -> None:
        """The pump: flush completed head-of-line results, submit up
        to the window, finish with the done trailer.  Re-entered from
        chunk-future completion, the overload retry timer, and
        write-buffer drain."""
        from bigdl_tpu_torch.serving.batcher import ServiceOverloaded
        if self._settled:
            return
        server = self.server
        while True:
            while self._inflight and self._inflight[0][2].done():
                if not self._flush_head():
                    return  # stream failed/settled inside
            if self.conn.out_pending > _HIGH_WATER:
                self._paused = True  # resumed by on_drain
                return
            if self._next_off < self.rows \
                    and len(self._inflight) < server._stream_window:
                off = self._next_off
                hi = min(off + self._max_batch, self.rows)
                try:
                    fut = server._submit(self._backend,
                                         self._leaf_slice(off, hi),
                                         self.deadline, self.ctx)
                except ServiceOverloaded as e:
                    if self._inflight:
                        # oldest chunk's completion re-ticks and the
                        # submit retries — the flush-oldest rule,
                        # without parking a thread
                        return
                    # foreign traffic owns the queue: honor the drain
                    # hint briefly, but give up eventually on a
                    # deadline-less stream rather than retrying forever
                    self._stalls += 1
                    if self.deadline is None and self._stalls > 200:
                        self._stream_fail(e)
                        return
                    self._retry_timer = self.loop.call_later(
                        min(0.05, (e.retry_after_ms or 10.0) / 1e3),
                        self._stream_tick)
                    return
                except BaseException as e:
                    self._stream_fail(e)
                    return
                self._stalls = 0
                self._next_off = hi
                self._inflight.append((off, hi - off, fut))
                fut.add_done_callback(
                    lambda f: self.loop.call_soon(self._stream_tick))
                continue
            if self._next_off >= self.rows and not self._inflight:
                self._stream_done()
                return
            return  # waiting on in-flight futures

    def _flush_head(self) -> bool:
        """Resolve the OLDEST in-flight chunk and stream its line (the
        200 chunked header is committed here, by the FIRST result)."""
        from bigdl_tpu_torch.frontend.server import _jsonify
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        off, n, fut = self._inflight.pop(0)
        try:
            # done already, so this never blocks the loop; the shared
            # helper keeps the resolved-timeout normalization identical
            # to the threaded core's flush
            out = self.server._result_or_504(fut, 0)
        except BaseException as e:
            if not fut.cancelled():
                ModelRegistry.record_outcome(self._brk, e)
            self._stream_fail(e)
            return False
        ModelRegistry.record_outcome(self._brk, None)
        try:
            self._ensure_started()
            self.conn.write(encode_chunk(json.dumps(
                {"offset": off, "rows": n,
                 "outputs": _jsonify(out)}).encode("utf-8") + b"\n"))
        except BaseException as e:
            # e.g. an unserializable output pytree — an internal fault
            # AFTER the result resolved (the threaded core catches the
            # same family in _respond_stream's failure tail)
            self._stream_fail(e)
            return False
        self.server.metrics.counter("frontend/stream_chunks").inc()
        self._sent += n
        return True

    def _ensure_started(self) -> None:
        if self._started:
            return
        from bigdl_tpu_torch.frontend.server import _NDJSON
        self._started = True
        self.conn.write(render_head(
            200, {"Content-Type": _NDJSON,
                  "X-Trace-Id": self.ctx.trace_id,
                  "X-Model-Version": str(self._key[1])}, chunked=True))

    def _on_stream_deadline(self) -> None:
        if self._settled:
            return
        from bigdl_tpu_torch.serving.batcher import DeadlineExceeded
        self._stream_fail(DeadlineExceeded(
            f"deadline passed after {self._sent} of {self.rows} rows "
            f"streamed"))

    def _stream_fail(self, e: BaseException) -> None:
        """Mirror of the threaded ``_respond_stream`` failure tail:
        cancel the backlog FIRST, answer with the real status if the
        200 was never committed (incl. the cutover ServiceClosed
        retry), else an error line; a client disconnect is the
        client's outcome, never a 5xx."""
        from bigdl_tpu_torch.frontend.server import _HTTPError
        if self._settled:
            return
        for _off, _n, fut in self._inflight:
            fut.cancel()
        self._inflight = []
        if not self._started:
            self._attempt_failed(e)
            return
        if isinstance(e, ConnectionError):
            self.server.metrics.counter(
                "frontend/client_disconnects").inc()
            self._finish(200, ok=False)
            return
        status, body, _hdrs = self.server._classify(e)
        if status >= 500 and status != 504 \
                and not isinstance(e, _HTTPError):
            logger.error("frontend mid-stream 5xx after %d rows",
                         self._sent, exc_info=e)
        self.server._count_status(status)
        self.conn.write(encode_chunk(json.dumps(
            {"error": body["error"], "status": status,
             "rows_streamed": self._sent}).encode("utf-8") + b"\n"))
        self.conn.write(CHUNK_TRAILER)
        self._finish(200, ok=False)

    def _stream_done(self) -> None:
        self._ensure_started()
        self.conn.write(encode_chunk(json.dumps(
            {"done": True, "rows": self._sent,
             "trace_id": self.ctx.trace_id}).encode("utf-8") + b"\n"))
        self.conn.write(CHUNK_TRAILER)
        self.server._count_status(200)
        self._finish(200, ok=True)

    # -- conn-driven notifications ----------------------------------------
    def on_drain(self) -> None:
        if self._paused and not self._settled:
            self._paused = False
            self._stream_tick()

    def on_client_gone(self) -> None:
        """The conn died under us (reset / failed send).  A committed
        stream aborts as a client disconnect; a single in-flight
        predict completes normally — its response is simply dropped
        (the threaded core likewise only fails at write time)."""
        if self._settled:
            return
        if self._started:
            self._stream_fail(ConnectionError(
                "client disconnected mid-stream"))
        # not started (single predict, or stream before its first
        # result): let the exchange complete — its writes are dropped
        # by the closed conn, exactly where the threaded core's write
        # would have failed silently

    def abandon(self) -> None:
        """Server-stop teardown: drop everything without response or
        accounting (the process is taking the whole plane down)."""
        if self._settled:
            return
        self._settled = True
        self._cancel_timers()
        for _off, _n, fut in self._inflight:
            fut.cancel()
        self._inflight = []
        if self._fut is not None:
            self._fut.cancel()
        self._unpin()

    # -- error + completion tails -----------------------------------------
    def _finish_error(self, e: BaseException) -> None:
        from bigdl_tpu_torch.frontend.server import _HTTPError
        status, body, hdrs = self.server._classify(e)
        if status >= 500 and status != 504 \
                and not isinstance(e, _HTTPError):
            logger.error("frontend 5xx on %s", self.req.target,
                         exc_info=e)
        self.core.respond(self.conn, status, body, hdrs)
        self._finish(status, ok=False)

    def _cancel_timers(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None

    def _finish(self, trace_status: int, *, ok: bool) -> None:
        if self._settled:
            return
        self._settled = True
        self._cancel_timers()
        self._unpin()
        server = self.server
        if self._entered:
            dt = time.monotonic() - self._t0
            server.qos.record_result(self.tenant, dt, ok)
            server._latency_h.observe(dt)
        if self._span_t0 is not None:
            tracer = server.tracer
            tracer.record("wire_request", self._span_t0,
                          time.perf_counter_ns(), cat="serving",
                          model=self.name, tenant=self.tenant,
                          trace_id=self.trace_id)
            if trace_status != 200:
                tracer.instant("wire_error", cat="serving",
                               model=self.name, tenant=self.tenant,
                               status=trace_status)
        self.conn.exchange_done(self.req.keep_alive)


class _GenExchange:
    """One POST .../generate exchange — the loop-owned token-streaming
    twin of the threaded core's ``_run_generate``/``_respond_generate``.
    Single-owner like :class:`_Exchange`: every field is loop-thread
    only.  The decode scheduler thread crosses in at exactly two
    points — the ``on_token`` callback and the future's done callback —
    and both only ``call_soon`` a bound method; because one scheduler
    thread emits every token BEFORE settling the future, the ready
    deque preserves token order and the done entry lands after the last
    token."""

    def __init__(self, core: EventLoopCore, conn: _Conn, req):
        from bigdl_tpu_torch.frontend.server import _GENERATE_RE
        self.core = core
        self.server = core.server
        self.conn = conn
        self.loop = conn.loop
        self.req = req
        m = _GENERATE_RE.match(req.target)
        self.name = m.group("name")
        self.req_version = (int(m.group("version"))
                            if m.group("version") else None)
        self.ctype = (req.get("content-type") or "") \
            .split(";")[0].strip().lower()
        self.tenant = req.get("x-tenant")
        self.trace_id = req.get("x-trace-id")
        self._settled = False
        self._entered = False
        self._t0 = 0.0
        self._span_t0: Optional[int] = None
        self._key = None
        self._pinned = False
        self._backend = None
        self._brk = None
        self._attempt = 0
        self.deadline: Optional[float] = None
        self.ctx = None
        self.prompt = None
        self.max_new = None
        self._fut = None
        self._deadline_timer: Optional[_Timer] = None
        self._started = False
        self._sent = 0

    # -- entry -------------------------------------------------------------
    def start(self) -> None:
        server = self.server
        raw_deadline = self.req.get("x-deadline-ms")
        deadline_ms = None
        if raw_deadline is not None:
            try:
                deadline_ms = float(raw_deadline)
            except ValueError:
                self.core.respond(self.conn, 400,
                                  {"error": f"bad X-Deadline-Ms "
                                            f"{raw_deadline!r}"},
                                  keep_alive=self.req.keep_alive)
                return
        tracer = server.tracer
        if tracer is not None and tracer.enabled:
            if self.trace_id is None:
                from bigdl_tpu_torch.telemetry.context import new_trace_id
                self.trace_id = new_trace_id()
            self._span_t0 = time.perf_counter_ns()
        self.conn.exchange = self
        self._t0 = time.monotonic()
        server.metrics.counter("frontend/requests").inc()
        try:
            server.qos.admit(self.tenant)
            self.deadline = (self._t0 + deadline_ms / 1e3
                             if deadline_ms is not None else None)
            from bigdl_tpu_torch.telemetry.context import RequestContext
            self.ctx = RequestContext(trace_id=self.trace_id,
                                      tenant=self.tenant,
                                      deadline=self.deadline)
            server._resolve(self.name, self.req_version)  # 404 first
            self.prompt, self.max_new = server._parse_generate_body(
                self.req.body, self.ctype)
        except BaseException as e:
            self._finish_error(e)
            return
        self._entered = True
        self._begin_attempt()

    # -- resolve-and-pin (the ServiceClosed cutover retry) -----------------
    def _begin_attempt(self) -> None:
        from bigdl_tpu_torch.frontend.server import _HTTPError
        from bigdl_tpu_torch.serving.batcher import RequestSpecError
        server = self.server
        try:
            key, backend, brk = server._resolve_pinned(self.name,
                                                       self.req_version)
        except BaseException as e:
            self._finish_error(e)
            return
        self._key, self._backend, self._brk = key, backend, brk
        self._pinned = True
        if not getattr(backend, "is_decode_backend", False):
            self._fail(_HTTPError(
                400, f"model {self.name!r} is not a decode backend — "
                     f"use /predict"))
            return
        try:
            fut = backend.submit(self.prompt,
                                 max_new_tokens=self.max_new,
                                 deadline=self.deadline, ctx=self.ctx,
                                 on_token=self._on_token_threadsafe)
        except RequestSpecError as e:
            self._fail(_HTTPError(400, str(e)))
            return
        except BaseException as e:
            self._fail(e)
            return
        self._fut = fut
        if self.deadline is not None:
            self._deadline_timer = self.loop.call_at(
                self.deadline, self._on_deadline)
        fut.add_done_callback(
            lambda f: self.loop.call_soon(self._done, f))

    # -- token stream ------------------------------------------------------
    def _on_token_threadsafe(self, index: int, token: int) -> None:
        """Runs on the decode scheduler thread — the ONE rule is it
        only crosses via call_soon (single-owner discipline)."""
        self.loop.call_soon(self._on_token, int(index), int(token))

    def _on_token(self, index: int, token: int) -> None:
        if self._settled or self.conn.closed:
            return
        self._ensure_started()
        self.conn.write(encode_chunk(json.dumps(
            {"index": index, "token": token}).encode("utf-8") + b"\n"))
        self._sent += 1

    def _ensure_started(self) -> None:
        if self._started:
            return
        from bigdl_tpu_torch.frontend.server import _NDJSON
        self._started = True
        self.conn.write(render_head(
            200, {"Content-Type": _NDJSON,
                  "X-Trace-Id": self.ctx.trace_id,
                  "X-Model-Version": str(self._key[1])}, chunked=True))

    # -- completion --------------------------------------------------------
    def _done(self, fut) -> None:
        if self._settled:
            return
        from bigdl_tpu_torch.serving.registry import ModelRegistry
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None
        try:
            out = self.server._result_or_504(fut, 0)  # done: no block
        except BaseException as e:
            if not fut.cancelled():
                ModelRegistry.record_outcome(self._brk, e)
            self._fail(e)
            return
        ModelRegistry.record_outcome(self._brk, None)
        self._ensure_started()
        self.conn.write(encode_chunk(json.dumps(
            {"done": True,
             "tokens": [int(t) for t in out.tokens],
             "n": len(out.tokens),
             "finish_reason": out.finish_reason,
             "trace_id": self.ctx.trace_id}).encode("utf-8") + b"\n"))
        self.conn.write(CHUNK_TRAILER)
        self.server._count_status(200)
        self.server.metrics.counter(
            "frontend/generate_tokens").inc(self._sent)
        self._finish(200, ok=True)

    def _on_deadline(self) -> None:
        if self._settled:
            return
        fut = self._fut
        if fut is not None and fut.cancel():
            # still queued past the wire deadline: refuse late service
            # (a RUNNING sequence is failed by the scheduler's own
            # per-step deadline check, which settles the future)
            from bigdl_tpu_torch.serving.batcher import DeadlineExceeded
            self._fail(DeadlineExceeded(
                "wire deadline expired while the prompt was queued"))

    # -- failure tails -----------------------------------------------------
    def _fail(self, e: BaseException) -> None:
        """Real status if the 200 was never committed (incl. the
        cutover ServiceClosed retry), else an error line + trailer —
        the threaded ``_respond_generate`` failure tail, loop-shaped."""
        from bigdl_tpu_torch.frontend.server import _HTTPError
        from bigdl_tpu_torch.serving.batcher import ServiceClosed
        if self._settled:
            return
        if self._fut is not None:
            self._fut.cancel()
        if not self._started:
            self._unpin()
            self._cancel_timers()
            if isinstance(e, ServiceClosed) \
                    and self.req_version is None and self._attempt < 2:
                self._attempt += 1
                self._fut = None
                self._begin_attempt()
                return
            self._finish_error(e)
            return
        if isinstance(e, ConnectionError):
            self.server.metrics.counter(
                "frontend/client_disconnects").inc()
            self._finish(200, ok=False)
            return
        status, body, _hdrs = self.server._classify(e)
        if status >= 500 and status != 504 \
                and not isinstance(e, _HTTPError):
            logger.error("frontend mid-generate 5xx after %d tokens",
                         self._sent, exc_info=e)
        self.server._count_status(status)
        self.conn.write(encode_chunk(json.dumps(
            {"error": body["error"], "status": status,
             "tokens_streamed": self._sent}).encode("utf-8") + b"\n"))
        self.conn.write(CHUNK_TRAILER)
        self._finish(200, ok=False)

    def _finish_error(self, e: BaseException) -> None:
        from bigdl_tpu_torch.frontend.server import _HTTPError
        status, body, hdrs = self.server._classify(e)
        if status >= 500 and status != 504 \
                and not isinstance(e, _HTTPError):
            logger.error("frontend 5xx on %s", self.req.target,
                         exc_info=e)
        self.core.respond(self.conn, status, body, hdrs)
        self._finish(status, ok=False)

    # -- conn-driven notifications ----------------------------------------
    def on_drain(self) -> None:
        pass  # token lines are tiny; no pull-driven pump to resume

    def on_client_gone(self) -> None:
        if self._settled:
            return
        if self._started:
            self._fail(ConnectionError(
                "client disconnected mid-generate"))
        # not started: let the exchange complete — writes are dropped
        # by the closed conn (same contract as _Exchange)

    def abandon(self) -> None:
        if self._settled:
            return
        self._settled = True
        self._cancel_timers()
        if self._fut is not None:
            self._fut.cancel()
        self._unpin()

    # -- bookkeeping -------------------------------------------------------
    def _unpin(self) -> None:
        if self._pinned:
            self._pinned = False
            self.server.inflight.exit(self._key)  # releases: wire_inflight

    def _cancel_timers(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
            self._deadline_timer = None

    def _finish(self, trace_status: int, *, ok: bool) -> None:
        if self._settled:
            return
        self._settled = True
        self._cancel_timers()
        self._unpin()
        server = self.server
        if self._entered:
            dt = time.monotonic() - self._t0
            server.qos.record_result(self.tenant, dt, ok)
            server._latency_h.observe(dt)
        if self._span_t0 is not None:
            tracer = server.tracer
            tracer.record("wire_request", self._span_t0,
                          time.perf_counter_ns(), cat="serving",
                          model=self.name, tenant=self.tenant,
                          trace_id=self.trace_id)
            if trace_status != 200:
                tracer.instant("wire_error", cat="serving",
                               model=self.name, tenant=self.tenant,
                               status=trace_status)
        self.conn.exchange_done(self.req.keep_alive)

"""Incremental HTTP/1.1 request framing for the event-loop front end.

Port of ``bigdl_tpu/frontend/http1.py`` (stdlib only, an owned copy).
The parser half of the C100K wire plane: a pure,
allocation-light state machine the loop core feeds raw socket bytes —
no file objects, no blocking reads, no threads.  ``feed()`` only
appends; ``head()`` / ``poll()`` advance the machine and either return
parsed structures, return ``None`` (need more bytes — the slow-loris
case: a byte-dribbled request line parks the CONNECTION, never a
thread or a loop tick), or raise :class:`ProtocolError` carrying the
HTTP status the connection should die with.  Body framing is
Content-Length or ``Transfer-Encoding: chunked``: chunked request
bodies are de-chunked INCREMENTALLY by :class:`ChunkedDecoder` — one
state machine shared by both connection cores (this parser embeds it;
the threaded core drives the same machine over its blocking ``rfile``
via :func:`read_chunked_body`) — with malformed chunk framing answered
400 and the total de-chunked body bounded (413, the body-phase twin of
the 431 head cap, so a chunk stream can't buffer unboundedly).

Keep-alive semantics follow the RFC defaults the stdlib handler uses:
HTTP/1.1 persists unless ``Connection: close``; HTTP/1.0 closes unless
``Connection: keep-alive``.  After ``poll()`` returns a complete
request the parser is immediately ready for the next one on the same
buffer, so pipelined bytes are never mis-framed (the keep-alive desync
guard, now at the parser layer).

Separated from the loop so the robustness tests can drive it
byte-at-a-time without sockets (``tests/test_torch_frontend.py``).
"""

from __future__ import annotations

from http.client import responses as _REASONS
from typing import Dict, Optional

# caps: a request head (line + headers) past this size is a client
# error (431), not a reason to buffer unboundedly — the slow-loris
# memory bound for the head phase
MAX_HEAD_BYTES = 64 << 10

# chunk-size lines are tiny (hex length + optional extensions); a line
# past this is framing garbage, not a big chunk
MAX_CHUNK_LINE = 256

# default total-body cap for chunked requests — matches the frontend's
# Content-Length 413 cap so the two framing modes share one bound
MAX_BODY_BYTES = 256 << 20


class ProtocolError(Exception):
    """Unrecoverable wire-level framing error: respond ``status`` (if
    anything can still be written) and close — re-synchronizing a
    stream after a malformed head is guesswork."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    """One parsed request.  ``headers`` keys are lowercased; ``body``
    is filled by ``poll()`` (empty until then)."""

    __slots__ = ("method", "target", "version", "headers", "keep_alive",
                 "body")

    def __init__(self, method: str, target: str, version: str,
                 headers: Dict[str, str], keep_alive: bool):
        self.method = method
        self.target = target
        self.version = version
        self.headers = headers
        self.keep_alive = keep_alive
        self.body = b""

    def get(self, name: str, default=None):
        return self.headers.get(name.lower(), default)


def _body_length(headers: Dict[str, str]) -> int:
    """Framing length from Content-Length.  Missing / unparseable /
    negative values frame as ZERO body — the exchange layer then
    answers the threaded core's exact 411/400 and closes, so the bogus
    framing never reaches a next request."""
    cl = headers.get("content-length")
    if cl is None:
        return 0
    try:
        n = int(cl.strip())
    except ValueError:
        return 0
    return n if n > 0 else 0


class ChunkedDecoder:
    """Incremental ``Transfer-Encoding: chunked`` request-body decoder —
    the ONE chunk-framing state machine both connection cores share.
    The event-loop :class:`RequestParser` embeds it (feed bytes, poll);
    the threaded core drives the same instance over its blocking
    ``rfile`` through :func:`read_chunked_body`.

    ``feed(bytes)`` appends; ``poll()`` advances the machine and
    returns the complete de-chunked body once the terminal chunk and
    its (discarded) trailer section arrive, else ``None``.  Malformed
    framing raises :class:`ProtocolError` 400; a stream whose
    de-chunked total exceeds ``max_body`` raises 413 — the body-phase
    twin of the head's 431 cap.  Bytes past the body's end (pipelined
    next request) stay in ``residual()``.
    """

    __slots__ = ("_max_body", "_buf", "_body", "_mode", "_remaining")

    def __init__(self, max_body: int = MAX_BODY_BYTES):
        self._max_body = int(max_body)
        self._buf = bytearray()
        self._body = bytearray()
        # size → data → crlf → size … → trailer → (returns)
        self._mode = "size"
        self._remaining = 0

    def feed(self, data: bytes) -> None:
        if data:
            self._buf += data

    def residual(self) -> bytes:
        """Unconsumed bytes past the body's end (only meaningful after
        ``poll()`` returned the body)."""
        return bytes(self._buf)

    # hints for a BLOCKING driver (read_chunked_body): what to read next
    def wants_line(self) -> bool:
        return self._mode != "data"

    def bytes_needed(self) -> int:
        """In data mode: exact payload bytes still owed to the current
        chunk (drivers may read less; never read more than this plus
        the trailing CRLF)."""
        return self._remaining

    def _take_line(self, cap: int) -> Optional[str]:
        nl = self._buf.find(b"\n")
        if nl < 0:
            if len(self._buf) > cap:
                raise ProtocolError(
                    400, "malformed chunk framing: oversized line")
            return None
        if nl > cap:
            raise ProtocolError(
                400, "malformed chunk framing: oversized line")
        line = bytes(self._buf[:nl])
        del self._buf[:nl + 1]
        return line.rstrip(b"\r").decode("latin-1")

    def poll(self) -> Optional[bytes]:
        while True:
            if self._mode == "size":
                line = self._take_line(MAX_CHUNK_LINE)
                if line is None:
                    return None
                # chunk extensions (";ext=val") are legal; discard them
                size_tok = line.split(";", 1)[0].strip()
                try:
                    n = int(size_tok, 16)
                except ValueError:
                    raise ProtocolError(
                        400, f"malformed chunk framing: bad chunk size "
                             f"{size_tok!r}") from None
                if n < 0:
                    raise ProtocolError(
                        400, "malformed chunk framing: negative size")
                if n == 0:
                    self._mode = "trailer"
                    continue
                if len(self._body) + n > self._max_body:
                    raise ProtocolError(
                        413, f"chunked body exceeds the "
                             f"{self._max_body} byte cap")
                self._remaining = n
                self._mode = "data"
            elif self._mode == "data":
                if not self._buf:
                    return None
                take = min(len(self._buf), self._remaining)
                self._body += self._buf[:take]
                del self._buf[:take]
                self._remaining -= take
                if self._remaining:
                    return None
                self._mode = "crlf"
            elif self._mode == "crlf":
                # each chunk's payload is followed by a bare CRLF
                line = self._take_line(2)
                if line is None:
                    return None
                if line:
                    raise ProtocolError(
                        400, "malformed chunk framing: missing chunk "
                             "terminator")
                self._mode = "size"
            else:  # trailer: zero or more fields, then an empty line
                line = self._take_line(MAX_CHUNK_LINE)
                if line is None:
                    return None
                if line:
                    continue  # trailer field — legal, discarded
                body = bytes(self._body)
                self._body.clear()
                return body


def read_chunked_body(rfile, max_body: int = MAX_BODY_BYTES) -> bytes:
    """Drive :class:`ChunkedDecoder` over a BLOCKING file-like (the
    threaded core's buffered ``rfile``) — same state machine, same 400 /
    413 taxonomy as the event-loop core.  Reads exactly the body's
    bytes: size/terminator/trailer lines via bounded ``readline`` and
    chunk payloads via exact-length ``read``, so pipelined keep-alive
    bytes after the body are never consumed."""
    dec = ChunkedDecoder(max_body)
    while True:
        body = dec.poll()
        if body is not None:
            return body
        if dec.wants_line():
            # +1 for the \n; a line hitting the cap without one is
            # flagged by the decoder itself
            data = rfile.readline(MAX_CHUNK_LINE + 2)
        else:
            data = rfile.read(min(dec.bytes_needed(), 64 << 10))
        if not data:
            raise ProtocolError(400, "truncated chunked body")
        dec.feed(data)


class RequestParser:
    """Incremental request parser: ``feed(bytes)`` → ``head()`` /
    ``poll()``.  Once a :class:`ProtocolError` is raised the parser is
    poisoned (every later call re-raises): the connection is done."""

    def __init__(self, max_head: int = MAX_HEAD_BYTES,
                 max_body: int = MAX_BODY_BYTES):
        self._max_head = int(max_head)
        self._max_body = int(max_body)
        self._buf = bytearray()
        self._head: Optional[Request] = None
        self._body_len = 0
        self._chunked: Optional[ChunkedDecoder] = None
        self._error: Optional[ProtocolError] = None

    def feed(self, data: bytes) -> None:
        """Append raw socket bytes.  Never raises — errors surface
        from ``head()``/``poll()`` so the reader's fast path stays
        branch-free."""
        if self._error is None and data:
            self._buf += data

    def buffered(self) -> int:
        return len(self._buf)

    def head(self) -> Optional[Request]:
        """The current request's head once its header block is
        complete (body may still be arriving), else ``None``.  Lets
        the exchange layer run must-happen-before-body checks (auth,
        411/413) without waiting for — or ever reading — the body."""
        if self._error is not None:
            raise self._error
        if self._head is None:
            self._parse_head()
        return self._head

    def poll(self) -> Optional[Request]:
        """A COMPLETE request (head + body, Content-Length or chunked
        framing) or ``None``; returning one resets the machine for the
        next request on the same connection."""
        req = self.head()
        if req is None:
            return None
        if self._chunked is not None:
            # hand every buffered byte to the shared chunk machine;
            # whatever follows the body comes back via residual()
            self._chunked.feed(bytes(self._buf))
            self._buf.clear()
            try:
                body = self._chunked.poll()
            except ProtocolError as e:
                self._fail(e.status, str(e))
            if body is None:
                return None
            self._buf += self._chunked.residual()
            req.body = body
            self._head = None
            self._chunked = None
            return req
        if len(self._buf) < self._body_len:
            return None
        req.body = bytes(self._buf[:self._body_len])
        del self._buf[:self._body_len]
        self._head = None
        self._body_len = 0
        return req

    # -- internals ---------------------------------------------------------
    def _fail(self, status: int, message: str):
        self._error = ProtocolError(status, message)
        self._buf.clear()
        raise self._error

    def _parse_head(self) -> None:
        # tolerate a stray CRLF preamble between keep-alive requests
        # (RFC 9112 §2.2) — some clients flush one after a body
        while self._buf[:2] == b"\r\n":
            del self._buf[:2]
        end = self._buf.find(b"\r\n\r\n")
        if end < 0:
            if len(self._buf) > self._max_head:
                self._fail(431, f"request head exceeds the "
                                f"{self._max_head} byte cap")
            return
        if end > self._max_head:
            self._fail(431, f"request head exceeds the "
                            f"{self._max_head} byte cap")
        block = bytes(self._buf[:end])
        del self._buf[:end + 4]
        lines = block.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            self._fail(400, f"malformed request line {lines[0]!r}")
        method, target, version = parts
        if version not in ("HTTP/1.0", "HTTP/1.1"):
            self._fail(505, f"unsupported protocol version {version!r}")
        headers: Dict[str, str] = {}
        last: Optional[str] = None
        for ln in lines[1:]:
            if ln[:1] in (" ", "\t") and last is not None:
                # obs-fold continuation: join with a space (RFC 9112)
                headers[last] += " " + ln.strip()
                continue
            name, sep, value = ln.partition(":")
            if not sep or not name or name.strip() != name:
                # whitespace before the colon is a smuggling classic —
                # refuse rather than guess (matches RFC 9112 §5.1 MUST)
                self._fail(400, f"malformed header line {ln!r}")
            last = name.lower()
            headers[last] = value.strip()
        conn_toks = headers.get("connection", "").lower()
        keep_alive = ("close" not in conn_toks if version == "HTTP/1.1"
                      else "keep-alive" in conn_toks)
        self._head = Request(method, target, version, headers,
                             keep_alive)
        te = headers.get("transfer-encoding", "").lower().strip()
        if te:
            # a CL alongside TE is the request-smuggling classic
            # (RFC 9112 §6.1 MUST treat as an error); any coding other
            # than a single terminal "chunked" we don't implement
            if "content-length" in headers:
                self._fail(400, "both Content-Length and "
                                "Transfer-Encoding present")
            if te != "chunked":
                self._fail(501, f"unsupported transfer coding {te!r}")
            self._body_len = 0
            self._chunked = ChunkedDecoder(self._max_body)
        else:
            self._body_len = _body_length(headers)
            self._chunked = None


# -- response encoding (the write half of the wire) ------------------------
def render_head(status: int, headers=None, *,
                content_length: Optional[int] = None,
                chunked: bool = False, close: bool = False) -> bytes:
    """Serialize one response head.  Exactly one framing mode: chunked
    OR Content-Length (every non-chunked response MUST carry one —
    keep-alive clients frame the next response off it)."""
    reason = _REASONS.get(status, "")
    lines = [f"HTTP/1.1 {status} {reason}".rstrip()]
    for k, v in (headers or {}).items():
        lines.append(f"{k}: {v}")
    if chunked:
        lines.append("Transfer-Encoding: chunked")
    elif content_length is not None:
        lines.append(f"Content-Length: {content_length}")
    if close:
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def encode_chunk(data: bytes) -> bytes:
    """One chunked-transfer frame (empty payloads encode to nothing —
    a zero-length chunk would terminate the stream)."""
    if not data:
        return b""
    return f"{len(data):x}\r\n".encode("latin-1") + data + b"\r\n"


CHUNK_TRAILER = b"0\r\n\r\n"

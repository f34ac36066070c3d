"""Admin plane — /metrics, /healthz, /trace, /flight, /profile over HTTP.

Port of ``bigdl_tpu/telemetry/admin.py`` (stdlib only, an owned copy:
the same routes and the same Prometheus rendering, metric prefix
included, so one scraper reads both packages).

BigDL 2.0 Cluster Serving treats external monitoring of the serving
pipeline as a product surface (arXiv:2204.01715 §4 — the dashboard);
here that surface is a lightweight stdlib ``http.server`` thread and
the first HTTP beachhead for ROADMAP item 1's RPC front end:

- ``GET /metrics`` — Prometheus text exposition (v0.0.4) rendered from
  the registered :class:`~bigdl_tpu_torch.telemetry.registry.MetricRegistry`
  snapshots: counters, gauges, and histograms as summaries with
  p50/p95/p99 quantiles — which includes the per-row-bucket serving
  latency reservoirs (``serving/latency_s_bucket{N}``).  Sources are
  distinguished by a ``source`` label, so a ReplicaSet's per-replica
  registries and its set-level resilience counters scrape as one page.
- ``GET /healthz`` — JSON health: every registered provider's verdict
  (ReplicaSet health states, registry breaker states, driver watchdog
  verdicts); HTTP 200 when every source reports ``ok``, 503 otherwise.
- ``GET /trace`` — the bounded telemetry tracer(s), dumped on demand
  as Chrome-trace JSON (one pid per source, mergeable in Perfetto).
- ``GET /flight`` — the flight-recorder ring as JSON.
- ``GET /profile?seconds=N`` — on-demand ``torch.profiler`` capture via
  the ``utils/profiling`` bridge; returns the trace's log dir, with the
  window's device events, kernel launches and retakes.  The one
  endpoint that may sync the device — it exists to be the opt-in deep
  dive, never scraped.

Security posture (documented in the README): binds ``127.0.0.1`` ONLY
by default and is OFF by default (``Config.admin_port = 0``); there is
no auth — anything that can reach the port can read metrics and
trigger a profile, so a non-loopback bind is an explicit, logged
choice.

Inertness contract: with ``admin_port == 0`` nothing here is ever
constructed — no socket, no thread (the zero-extra-threads gate in
``tests/test_obs_plane.py``).  The serving/driver hot paths never call
into this module; the scrape path only READS registry snapshots (each
under its own lock) — rendering cost is paid by the scraper's thread,
measured by ``bench.py --serving``'s ``admin_scrape_overhead`` point.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

logger = logging.getLogger("bigdl_tpu_torch.telemetry")

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "bigdl_tpu_"
_MAX_PROFILE_S = 60.0


def _prom_name(name: str) -> str:
    """``serving/latency_s`` → ``bigdl_tpu_serving_latency_s``."""
    return _PREFIX + _NAME_RE.sub("_", name)


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def render_prometheus(snapshots: Dict[str, dict]) -> str:
    """Prometheus text exposition from ``{source: registry.snapshot()}``.

    Families are merged across sources (one ``# TYPE`` header per
    metric name); every sample carries a ``source`` label.  Histograms
    render as summaries: ``quantile``-labelled samples from the
    reservoir percentiles plus ``_sum``/``_count`` from the exact
    accumulators.
    """
    counters: Dict[str, list] = {}
    gauges: Dict[str, list] = {}
    summaries: Dict[str, list] = {}
    for source, snap in sorted(snapshots.items()):
        lbl = f'{{source="{_prom_escape(source)}"}}'
        for name, v in sorted((snap.get("counters") or {}).items()):
            counters.setdefault(_prom_name(name), []).append(
                f"{_prom_name(name)}{lbl} {v}")
        for name, v in sorted((snap.get("gauges") or {}).items()):
            gauges.setdefault(_prom_name(name), []).append(
                f"{_prom_name(name)}{lbl} {v}")
        for name, h in sorted((snap.get("histograms") or {}).items()):
            pn = _prom_name(name)
            rows = summaries.setdefault(pn, [])
            src = _prom_escape(source)
            for q in ("p50", "p95", "p99"):
                if h.get(q) is not None:
                    rows.append(
                        f'{pn}{{source="{src}",quantile="0.{q[1:]}"}} '
                        f"{h[q]}")
            rows.append(f'{pn}_sum{{source="{src}"}} {h.get("sum", 0.0)}')
            rows.append(f'{pn}_count{{source="{src}"}} {h.get("count", 0)}')
    lines = []
    for fam, kind in ((counters, "counter"), (gauges, "gauge"),
                      (summaries, "summary")):
        for name in sorted(fam):
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(fam[name])
    return "\n".join(lines) + ("\n" if lines else "")


class AdminServer:
    """One process-local admin HTTP endpoint (see module docstring).

    Sources register by name; registration replaces (idempotent — a
    redeployed service under the same name just swaps its registry in).
    ``port=0`` binds an ephemeral port (tests); ``.port`` reports the
    bound one.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 profile_dir: Optional[str] = None):
        self.host = host
        self.requested_port = int(port)
        self.profile_dir = profile_dir
        self.port: Optional[int] = None
        self._lock = threading.Lock()
        self._registries: Dict[str, object] = {}  # guarded-by: _lock
        self._tracers: Dict[str, object] = {}     # guarded-by: _lock
        # guarded-by: _lock
        self._health: Dict[str, Callable[[], dict]] = {}
        # names handed out, not yet bound; guarded-by: _lock
        self._reserved: set = set()
        self._flight = None  # write-guarded-by: _lock
        self._profile_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        if host not in ("127.0.0.1", "localhost", "::1"):
            logger.warning(
                "admin plane binding non-loopback host %r — there is no "
                "auth on this surface; make sure the network trusts it",
                host)

    # ------------------------------------------------------ registration
    def add_registry(self, name: str, registry) -> "AdminServer":
        with self._lock:
            self._registries[name] = registry
        return self

    def add_tracer(self, name: str, tracer) -> "AdminServer":
        with self._lock:
            self._tracers[name] = tracer
        return self

    def add_health(self, name: str,
                   provider: Callable[[], dict]) -> "AdminServer":
        """``provider()`` returns a JSON-able dict; an ``"ok"`` key
        (when present) feeds the top-level verdict/status code."""
        with self._lock:
            self._health[name] = provider
        return self

    def set_flight(self, recorder) -> "AdminServer":
        with self._lock:
            self._flight = recorder
        return self

    def drop_tracer(self, name: str) -> None:
        """Unregister just the tracer under ``name`` (a driver rerun
        with telemetry off must not keep serving the previous run's
        trace as current)."""
        with self._lock:
            self._tracers.pop(name, None)

    def drop_health(self, name: str) -> None:
        """Unregister just the health provider under ``name``."""
        with self._lock:
            self._health.pop(name, None)

    def remove_source(self, name: str) -> None:
        """Drop every registration under ``name`` (registry, tracer,
        health) and release its reservation.  Stopped services MUST
        call this (their ``stop()`` does): a retired ReplicaSet left
        registered would hold its metrics alive forever and report its
        parked replicas as a permanent ``/healthz`` 503."""
        with self._lock:
            self._registries.pop(name, None)
            self._tracers.pop(name, None)
            self._health.pop(name, None)
            self._reserved.discard(name)

    def unique_source_name(self, base: str) -> str:
        """``base`` if unused, else ``base-2``, ``base-3``, ... —
        for sources with no natural unique name (two concurrent
        training drivers must not silently overwrite each other's
        ``driver`` registration).  The returned name is RESERVED
        atomically (two racing callers cannot both get ``base``);
        ``remove_source`` releases it."""
        with self._lock:
            taken = (self._registries.keys() | self._tracers.keys()
                     | self._health.keys() | self._reserved)
            name = base
            if name in taken:
                k = 2
                while f"{base}-{k}" in taken:
                    k += 1
                name = f"{base}-{k}"
            self._reserved.add(name)
            return name

    # -------------------------------------------------------- rendering
    def metrics_text(self) -> str:
        with self._lock:
            regs = dict(self._registries)
        return render_prometheus(
            {name: reg.snapshot() for name, reg in regs.items()})

    def health_json(self) -> dict:
        with self._lock:
            providers = dict(self._health)
        sources, ok = {}, True
        for name, fn in sorted(providers.items()):
            try:
                verdict = fn()
            except Exception as e:  # a broken probe IS a health signal
                verdict = {"ok": False,
                           "error": f"{type(e).__name__}: {e}"}
            sources[name] = verdict
            if isinstance(verdict, dict) and verdict.get("ok") is False:
                ok = False
        return {"ok": ok, "sources": sources}

    def trace_json(self) -> dict:
        """All registered tracers merged into one Chrome trace — one
        pid per source so Perfetto shows them as separate processes.
        Deduplicated by tracer IDENTITY: a ReplicaSet and its replicas
        legitimately register the same shared Tracer under N+1 names,
        which must export once, not N+1 times."""
        with self._lock:
            tracers = dict(self._tracers)
        events = []
        seen: Dict[int, str] = {}
        pid = 0
        for name, tr in sorted(tracers.items()):
            if id(tr) in seen:
                continue
            seen[id(tr)] = name
            sub = tr.to_chrome_trace(process_name=name)
            for ev in sub["traceEvents"]:
                ev = dict(ev)
                ev["pid"] = pid
                events.append(ev)
            pid += 1
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"sources": sorted(seen.values())}}

    def flight_json(self) -> dict:
        with self._lock:
            fl = self._flight
        if fl is None:
            return {"meta": None, "events": []}
        return {"meta": fl.meta, "events": fl.events()}

    def profile(self, seconds: float) -> dict:
        """On-demand torch profiler capture (the ``utils/profiling``
        bridge) — serialized: one capture at a time."""
        seconds = max(0.1, min(float(seconds), _MAX_PROFILE_S))
        if not self._profile_lock.acquire(blocking=False):
            raise RuntimeError("a profile capture is already running")
        try:
            from bigdl_tpu_torch.utils.profiling import profile_window
            with self._lock:
                tracer = next(iter(self._tracers.values()), None)
            stats = {}
            log_dir = profile_window(seconds, log_dir=self.profile_dir,
                                     tracer=tracer, stats=stats)
            return {"log_dir": log_dir, "seconds": seconds, **stats}
        finally:
            self._profile_lock.release()

    # -------------------------------------------------------- lifecycle
    def start(self) -> int:
        """Bind + serve on a daemon thread; idempotent.  Returns the
        bound port."""
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # stdlib default spams
                logger.debug("admin: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib API
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._send(200, server.metrics_text().encode(),
                                   "text/plain; version=0.0.4")
                    elif url.path == "/healthz":
                        h = server.health_json()
                        self._send(200 if h["ok"] else 503,
                                   json.dumps(h).encode(),
                                   "application/json")
                    elif url.path == "/trace":
                        self._send(200,
                                   json.dumps(server.trace_json()).encode(),
                                   "application/json")
                    elif url.path == "/flight":
                        self._send(
                            200, json.dumps(server.flight_json(),
                                            default=str).encode(),
                            "application/json")
                    elif url.path == "/profile":
                        q = parse_qs(url.query)
                        secs = float(q.get("seconds", ["3"])[0])
                        self._send(200,
                                   json.dumps(server.profile(secs)).encode(),
                                   "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": f"no route {url.path}",
                             "routes": ["/metrics", "/healthz", "/trace",
                                        "/flight", "/profile"]}).encode(),
                            "application/json")
                except Exception as e:
                    self._send(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")

        self._httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="bigdl-tpu-torch-admin",
            daemon=True)
        self._thread.start()
        logger.info("admin plane listening on http://%s:%d "
                    "(/metrics /healthz /trace /flight /profile)",
                    self.host, self.port)
        return self.port

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def url(self, path: str = "/") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "AdminServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------- process-wide singleton
_install_lock = threading.Lock()
# write-guarded-by: _install_lock
_installed: Optional[AdminServer] = None


def install(server: Optional[AdminServer]) -> None:
    """Install (or clear) the process-wide admin server that serving /
    driver constructors register their sources with."""
    global _installed
    with _install_lock:
        _installed = server


def current() -> Optional[AdminServer]:
    return _installed


_start_failed = False  # write-guarded-by: _install_lock


def maybe_start() -> Optional[AdminServer]:
    """Start-and-install the admin plane per ``Config.admin_port`` /
    ``BIGDL_TPU_ADMIN_PORT`` (0 = off → None, the zero-thread inert
    state).  Idempotent; an explicitly installed server wins.

    A bind failure (port already taken) DEGRADES monitoring, never the
    product: it is logged once and remembered — serving/training
    constructors keep working without an admin plane instead of
    crashing on an observability knob."""
    global _installed, _start_failed
    if _installed is not None:
        return _installed
    if _start_failed:
        return None
    from bigdl_tpu_torch.utils.config import get_config
    port = int(getattr(get_config(), "admin_port", 0) or 0)
    if port <= 0:
        return None
    with _install_lock:
        if _installed is None and not _start_failed:
            srv = AdminServer(port=port)
            try:
                srv.start()
            except OSError as e:
                _start_failed = True
                logger.warning(
                    "admin plane could not bind 127.0.0.1:%d (%s) — "
                    "monitoring disabled for this process, serving/"
                    "training unaffected", port, e)
                return None
            _installed = srv
    return _installed


def reset() -> None:
    """Stop + drop the singleton (tests)."""
    global _installed, _start_failed
    with _install_lock:
        if _installed is not None:
            _installed.stop()
        _installed = None
        _start_failed = False

"""Step-timeline tracer — nested host-side spans, Chrome-trace export.

Port of ``bigdl_tpu/telemetry/tracer.py`` (stdlib only, an owned copy):
the same ``PHASE_CATS`` and the same Chrome-trace layout, so
``tools/trace_report.py`` reads the port's dumps unchanged.  The driver
records its pipeline as spans: block staging (host stacking and the H2D
copy on the side stream), the eager dispatch of a block's steps, the
one-block-behind loss fetch (device wait), the replay of the block's
iterations and the trigger work (validation, snapshots).  Open the JSON
in Perfetto / ``chrome://tracing``, summarize with
``python -m tools.trace_report``.

The contract — telemetry is inert:

- a span is two ``time.perf_counter_ns()`` reads and one list append —
  no device work, no host-device sync, ever;
- spans around device fetches wrap fetches the driver already performs
  (the one-block-behind loss fetch), never introduce one;
- disabled (``enabled=False``), ``span()`` returns one shared no-op
  context manager: zero allocation — the loss sequence and the kernel
  launches are identical either way (gated in
  ``tests/test_torch_telemetry.py``).

Event volume is bounded: past ``capacity`` events the tracer drops and
counts (``dropped_events`` rides in the export) — an always-on run may
not grow memory with step count.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Tuple


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()

# phase categories the driver emits; trace_report computes time shares
# over these (plus "other" for unaccounted wall time)
PHASE_CATS = ("stage", "dispatch", "device_wait", "replay", "trigger")


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: Optional[str],
                 args: Optional[dict]):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tr._record("X", self.name, self.cat, self._t0,
                         t1 - self._t0, self.args)
        return False


class Tracer:
    """Thread-safe span recorder with Chrome-trace JSON export.

    Events are stored as tuples ``(ph, name, cat, t0_ns, dur_ns, tid,
    args, flow)`` where ``ph`` is the Chrome phase ("X" complete span,
    "i" instant, "s"/"f" flow start/finish) and ``tid`` is either a
    host thread id or a virtual track name (the driver puts in-flight
    device blocks on a ``"device"`` track so they can overlap host
    spans without breaking nesting).  ``flow`` is the flow-arrow id for
    "s"/"f" events (None otherwise) — the serving engine uses flows to
    fan N coalesced request spans into their one dispatch span.
    """

    def __init__(self, enabled: bool = True, capacity: int = 200_000):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: List[Tuple] = []  # guarded-by: _lock
        self._dropped = 0               # write-guarded-by: _lock

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: Optional[str] = None, **args):
        """Context manager timing one host-side phase.  ``cat`` groups
        spans into pipeline phases (see ``PHASE_CATS``); ``args`` ride
        into the Chrome-trace ``args`` field (keep them cheap scalars)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args or None)

    def instant(self, name: str, cat: str = "watchdog", **args) -> None:
        """Point-in-time marker (watchdog events: recompile, stall)."""
        if not self.enabled:
            return
        self._record("i", name, cat, time.perf_counter_ns(), 0,
                     args or None)

    def flow_start(self, name: str, fid: int, cat: Optional[str] = None,
                   **args) -> None:
        """Open one side of a Chrome flow arrow (``ph:"s"``).  Emit it
        INSIDE an open span on the emitting thread — flow events bind to
        the enclosing slice whose time range contains them.  ``fid``
        pairs starts with finishes (``telemetry.context.flow_id``); the
        request-fan-in edges in the serving trace are N ``flow_start``s
        (one per coalesced request's submit span) finishing in the one
        dispatch span."""
        if not self.enabled:
            return
        self._record("s", name, cat, time.perf_counter_ns(), 0,
                     args or None, flow=fid)

    def flow_end(self, name: str, fid: int, cat: Optional[str] = None,
                 **args) -> None:
        """Close a flow arrow (``ph:"f"``, binding to the ENCLOSING
        slice — ``bp:"e"``); emit inside the consuming span."""
        if not self.enabled:
            return
        self._record("f", name, cat, time.perf_counter_ns(), 0,
                     args or None, flow=fid)

    def record(self, name: str, t0_ns: int, t1_ns: int,
               cat: Optional[str] = None, track: Optional[str] = None,
               **args) -> None:
        """Record a span with explicit endpoints — for durations whose
        start predates the call site (e.g. a dispatched block's
        in-flight window, closed by the one-block-behind fetch).
        ``track`` places it on a named virtual track instead of the
        calling thread."""
        if not self.enabled:
            return
        self._record("X", name, cat, t0_ns, max(0, t1_ns - t0_ns),
                     args or None, tid=track)

    def _record(self, ph, name, cat, t0_ns, dur_ns, args, tid=None,
                flow=None):
        if tid is None:
            tid = threading.get_ident()
        with self._lock:
            if len(self._events) >= self.capacity:
                self._dropped += 1
                return
            self._events.append((ph, name, cat, t0_ns, dur_ns, tid, args,
                                 flow))

    # -- reading -----------------------------------------------------------
    def events(self) -> List[Tuple]:
        with self._lock:
            return list(self._events)

    @property
    def dropped_events(self) -> int:
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def phase_totals(self) -> Dict[str, float]:
        """Seconds per span category (instants excluded) — the cheap
        aggregate ``bench._measure`` consumes; the full self-time
        attribution lives in ``tools/trace_report.py``."""
        totals: Dict[str, float] = {}
        for ph, _name, cat, _t0, dur_ns, _tid, _args, _flow in self.events():
            if ph != "X":
                continue
            key = cat or "uncategorized"
            totals[key] = totals.get(key, 0.0) + dur_ns / 1e9
        return totals

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self,
                        process_name: str = "bigdl_tpu_torch") -> dict:
        """Chrome-trace JSON object (``ts``/``dur`` in microseconds,
        which is what Perfetto and ``chrome://tracing`` expect)."""
        events = self.events()
        tid_map: Dict[object, int] = {}

        def tid_of(tid) -> int:
            if tid not in tid_map:
                # virtual tracks get small ids after the host threads
                tid_map[tid] = len(tid_map) + 1
            return tid_map[tid]

        out = []
        for ph, name, cat, t0_ns, dur_ns, tid, args, flow in events:
            ev = {"name": name, "ph": ph, "pid": 0, "tid": tid_of(tid),
                  "ts": t0_ns / 1e3}
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            elif ph in ("s", "f"):
                # flow arrow: id pairs the start with its finish; "f"
                # binds to the ENCLOSING slice (bp:"e") so the arrow
                # lands on the dispatch span, not the next slice
                ev["id"] = flow
                if ph == "f":
                    ev["bp"] = "e"
            else:
                ev["s"] = "t"
            if cat:
                ev["cat"] = cat
            if args:
                ev["args"] = args
            out.append(ev)
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": process_name}}]
        for tid, small in sorted(tid_map.items(), key=lambda kv: kv[1]):
            label = tid if isinstance(tid, str) else f"host-{small}"
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": small, "args": {"name": label}})
        return {"traceEvents": meta + out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped,
                              "span_count": len(out)}}

    def dump(self, path: str,
             process_name: str = "bigdl_tpu_torch") -> str:
        """Write the Chrome-trace JSON to ``path`` and return it."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(process_name), f)
        return path

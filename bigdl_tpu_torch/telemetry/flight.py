"""Flight recorder — a crash-surviving structured-event black box.

Port of ``bigdl_tpu/telemetry/flight.py`` (stdlib only, an owned copy:
the same JSONL stream and dump formats, so either package loads the
other's dumps with ``load_dump``).

The tracer (PR 6) answers "where did the time go" but dies with the
process; the flight recorder answers "what happened, in what order,
to which request" and SURVIVES the process: every recorded event is
appended to a JSONL file and flushed immediately, so even a SIGKILL'd
process leaves its event history on disk (gated by the subprocess kill
test in ``tests/test_obs_plane.py``).  Recorded events are the *rare,
load-bearing* state changes of the stack — health transitions, breaker
trips, failovers, sheds, rollbacks, recompiles, checkpoint commits,
preemption — each optionally carrying a ``trace_id`` so
``tools/obs_report.py`` can join the dump with a telemetry trace into
one post-mortem timeline.

Design rules (house discipline):

- **Provably inert when off.**  ``from_config()`` returns ``None`` for
  an empty ``Config.flight_recorder_path`` — every call site guards on
  ``flight is not None``, so the disabled path allocates nothing,
  opens nothing, and starts no thread.
- **Bounded.**  In memory: a ``deque(maxlen=capacity)`` ring.  On
  disk: the JSONL stream rotates to ``<path>.1`` past
  ``max_bytes`` — an always-on recorder may not grow without bound.
- **Host-side only.**  No device work, no syncs —
  events ride boundaries the stack already crosses (a failover, a
  checkpoint commit), never add one (graftlint catalog note "events
  ride existing boundaries").
- **Clock-anchored.**  The meta header records a paired
  ``(unix_ns, perf_ns)`` sample so obs_report can place tracer spans
  (``perf_counter_ns`` time base) and flight events on ONE wall-clock
  axis.

Writing from a signal handler is deliberately NOT done here (fsync in
a handler is how files get torn — the preemption lesson of PR 7); the
driver records its ``preemption`` event on the driver thread after the
flag-only handler fires, and crashes are covered by the append-per-
event stream plus the driver's ``run_crash`` event in its ``finally``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

logger = logging.getLogger("bigdl_tpu_torch.telemetry")

SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded structured-event ring with an append-and-flush JSONL
    stream (see module docstring).

    ``path=None`` keeps the recorder memory-only (tests, ad-hoc use);
    ``dump()`` then writes a one-shot snapshot.  With ``path`` set,
    the stream IS the dump — obs_report reads either format.
    """

    def __init__(self, path: Optional[str] = None, capacity: int = 4096,
                 max_bytes: int = 8 << 20):
        self.path = path or None
        self.capacity = max(1, int(capacity))
        self.max_bytes = max(1 << 16, int(max_bytes))
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._file = None   # guarded-by: _lock
        self._bytes = 0     # guarded-by: _lock
        self.meta = {
            "schema": SCHEMA_VERSION,
            "pid": os.getpid(),
            "unix_ns": time.time_ns(),
            "perf_ns": time.perf_counter_ns(),
        }
        if self.path:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._file = open(self.path, "a", buffering=1)
            # count what a previous process already appended, or the
            # rotation bound silently stops holding across restarts
            self._bytes = self._file.tell()
            try:
                self._write_line({"meta": self.meta})
            except OSError as e:
                self._disable_stream_locked(e)

    # ----------------------------------------------------------- record
    def record(self, event: str, cat: str = "event",
               trace_id: Optional[str] = None, **fields) -> dict:
        """Append one event (thread-safe; flushed to disk before
        returning when streaming).  ``fields`` must be JSON-able cheap
        scalars — this runs on failure paths, keep it allocation-light.

        Disk trouble NEVER propagates: record() is called from the
        ReplicaSet supervisor, the checkpoint writer, and the driver's
        crash ``finally`` — an OSError escaping here would kill the
        supervisor (stranding requests) or mask the training exception
        it was recording.  On a write failure the stream is disabled
        with one warning and the recorder degrades to memory-only."""
        entry = {"event": event, "cat": cat,
                 "t_unix": time.time(),
                 "perf_ns": time.perf_counter_ns()}
        if trace_id is not None:
            entry["trace_id"] = trace_id
        if fields:
            entry.update(fields)
        with self._lock:
            self._ring.append(entry)
            if self._file is not None:
                try:
                    self._write_line(entry)
                except OSError as e:
                    self._disable_stream_locked(e)
        return entry

    # guarded-by: _lock  (also reached from __init__, pre-sharing)
    def _disable_stream_locked(self, exc: OSError) -> None:
        logger.warning(
            "flight recorder stream to %s failed (%s) — disk recording "
            "disabled, in-memory ring continues", self.path, exc)
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        self._file = None

    # guarded-by: _lock  (or __init__, before the object is shared)
    def _write_line(self, obj: dict) -> None:
        # line-buffered file + explicit flush → a SIGKILL loses at most
        # the in-flight line
        line = json.dumps(obj, default=str) + "\n"
        self._file.write(line)
        self._file.flush()
        self._bytes += len(line)
        if self._bytes > self.max_bytes:
            self._rotate_locked()

    # guarded-by: _lock
    def _rotate_locked(self) -> None:
        try:
            self._file.close()
            os.replace(self.path, self.path + ".1")
        except OSError:  # rotation is best-effort, never fatal
            pass
        self._file = open(self.path, "a", buffering=1)
        self._bytes = 0
        self._write_header_after_rotate()

    # guarded-by: _lock
    def _write_header_after_rotate(self) -> None:
        line = json.dumps({"meta": self.meta, "rotated": True}) + "\n"
        self._file.write(line)
        self._file.flush()
        self._bytes += len(line)

    # ------------------------------------------------------------- read
    def events(self) -> List[dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def events_for(self, trace_id: str) -> List[dict]:
        """The retained events carrying one trace id — the in-process
        version of the obs_report request story."""
        return [e for e in self.events() if e.get("trace_id") == trace_id]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events():
            out[e["event"]] = out.get(e["event"], 0) + 1
        return out

    # ------------------------------------------------------------- dump
    def dump(self, path: str) -> str:
        """One-shot ring snapshot as a JSON object (atomic tmp+rename;
        the streamed JSONL at ``self.path`` is independent of this)."""
        blob = {"meta": self.meta, "events": self.events()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None


# ---------------------------------------------------------------- loading
def load_dump(path: str) -> dict:
    """Read a flight dump — streamed JSONL (meta header line + one
    event per line; torn final lines from a crash are skipped) or the
    one-shot ``dump()`` JSON object.  Returns ``{"meta": {...},
    "events": [...]}``."""
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "{" and _looks_like_object_dump(path):
            blob = json.load(f)
            return {"meta": blob.get("meta", {}),
                    "events": blob.get("events", [])}
        meta: dict = {}
        events: List[dict] = []
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a killed process — expected
            if "meta" in obj and "event" not in obj:
                meta = obj["meta"]
            else:
                events.append(obj)
        return {"meta": meta, "events": events}


def _looks_like_object_dump(path: str) -> bool:
    """A ``dump()`` file is ONE json object spanning the whole file; a
    JSONL stream is one object per line.  Distinguish by whether the
    first line parses alone."""
    with open(path) as f:
        first = f.readline()
    try:
        obj = json.loads(first)
    except json.JSONDecodeError:
        return True  # multi-line object
    return isinstance(obj, dict) and "events" in obj


# ------------------------------------------------- process-wide singleton
_install_lock = threading.Lock()
# write-guarded-by: _install_lock
_installed: Optional[FlightRecorder] = None


def install(recorder: Optional[FlightRecorder]) -> None:
    """Install (or clear, with None) the process-wide recorder that
    ``from_config()`` call sites pick up."""
    global _installed
    with _install_lock:
        _installed = recorder


def current() -> Optional[FlightRecorder]:
    return _installed


def from_config() -> Optional[FlightRecorder]:
    """The process-wide recorder per ``Config.flight_recorder_path``
    ("" = off → None, the provably-inert state).  First live call
    creates and installs the singleton; an explicitly ``install()``-ed
    recorder always wins (tests, embedders)."""
    global _installed
    if _installed is not None:
        return _installed
    from bigdl_tpu_torch.utils.config import get_config
    cfg = get_config()
    path = getattr(cfg, "flight_recorder_path", "") or ""
    if not path:
        return None
    with _install_lock:
        if _installed is None:
            _installed = FlightRecorder(
                path, capacity=cfg.flight_recorder_capacity)
    return _installed


def reset() -> None:
    """Drop the singleton (tests)."""
    global _installed
    with _install_lock:
        if _installed is not None:
            _installed.close()
        _installed = None

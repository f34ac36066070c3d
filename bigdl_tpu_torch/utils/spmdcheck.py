"""spmdcheck — a collective-schedule sanitizer for multi-host divergence.

Port of ``bigdl_tpu/utils/spmdcheck.py`` (stdlib only, an owned copy).
Its fingerprints spell the port's tensor trees as the reference spells
its arrays (``float32``, not ``torch.float32``; a dict's keys sorted, as
a jax treedef prints them), so one model's schedule, taken in the
reference's tree layout (``interop.jax_tree``), fingerprints the same in
both packages.

The static half of the divergence story is graftlint GL401-GL404: a
branch whose predicate is process-local sitting above a collective.
What static analysis cannot see is the DYNAMIC schedule — the actual
sequence of collectives each process issues once real data, real
preemptions and real membership epochs drive the branches.  This module
validates the SPMD invariant at runtime the way lockdep validates lock
ordering: record the schedule every (emulated) process issues and fail
the session on the FIRST divergence, with both schedules and both
stacks, instead of letting a one-sided allgather hang a pod.

How it works
------------

The driver's collective boundaries carry ``note(kind, axis, payload)``
calls (block dispatch, the replay fetch, checkpoint capture, the
multihost allgather helpers, membership adoption).  When the sanitizer
is off, ``note`` reads ONE module global and returns — the inertness
contract (gated bitwise in ``tests/test_spmdcheck.py``).  When on, the
note appends a :class:`ScheduleEntry` — ``(kind, axis, payload
fingerprint)`` plus a cheap stack — to the current participant's
schedule.

Multi-host is EMULATED: tests wrap per-process work in ``with
participant(pid):`` and run the same workload once per pid (the
``local[1]``-style trick the virtual-mesh conftest already plays).
Outside a ``participant`` block the pid defaults to the process's rank
in the ``torch.distributed`` group (0 without one), so the same note
sites keep working across processes.  Entry ``i`` of participant ``p`` is compared against entry ``i``
of the LOWEST-pid participant as soon as both exist; the first mismatch
records a :class:`DivergenceReport` carrying both entries, both stacks
and both full schedules.  Reporting is once per participant pair — a
schedule that slid out of phase would otherwise flood every subsequent
entry.

Fingerprints cover what the collective contract actually requires to
agree: op kind, mesh axis, and the payload's treedef + leaf
dtypes/shapes (values are allowed to differ — that is the point of a
collective).

Inertness contract (house discipline, the lockdep/FaultInjector
shape): with ``Config.spmdcheck`` off nothing is allocated, ``note``
is a single ``is None`` test, and driver behavior is byte-identical.

Opt-in: ``Config.spmdcheck`` (``BIGDL_TPU_SPMDCHECK=1``) and
:func:`maybe_install`.  Composes with lockdep; the two sanitizers share
no state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

_THIS_FILE = os.path.abspath(__file__)

_MAX_REPORTS = 100     # bound the report list; a broken suite floods
_STACK_DEPTH = 10

FrameTup = Tuple[str, int, str]  # (filename, lineno, funcname)


def _cheap_stack(skip: int = 2) -> List[FrameTup]:
    """A few frames of (file, line, func) without touching linecache —
    cheap enough to capture on every note (source lines resolve lazily,
    only when a report renders)."""
    out: List[FrameTup] = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return out
    while f is not None and len(out) < _STACK_DEPTH:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE:
            out.append((fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return out


def _fmt_stack(frames: List[FrameTup], indent: str = "    ") -> str:
    if not frames:
        return indent + "<no frames>"
    return "\n".join(
        f"{indent}{os.path.relpath(fn) if fn.startswith(os.sep) else fn}"
        f":{ln} in {fun}" for fn, ln, fun in frames)


def _dtype_name(leaf) -> str:
    dtype = getattr(leaf, "dtype", None)
    if dtype is None:
        import numpy as np
        dtype = np.asarray(leaf).dtype
    return str(dtype).replace("torch.", "")


def _spell(payload, leaves: list) -> str:
    """The treedef of ``payload`` as a jax ``PyTreeDef`` prints it (dict
    keys sorted, tuples with a trailing comma at length one); its leaves
    are appended to ``leaves`` in the same order."""
    if payload is None:
        return "None"
    if isinstance(payload, dict):
        return "{" + ", ".join(f"{k!r}: {_spell(payload[k], leaves)}"
                               for k in sorted(payload)) + "}"
    if isinstance(payload, tuple):
        kids = [_spell(v, leaves) for v in payload]
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
    if isinstance(payload, list):
        return "[" + ", ".join(_spell(v, leaves) for v in payload) + "]"
    leaves.append(payload)
    return "*"


def _fingerprint(payload) -> str:
    """Treedef + leaf dtype/shape digest — the structural identity a
    collective needs every process to agree on.  Only called when the
    sanitizer is ON."""
    if payload is None:
        return "-"
    try:
        import numpy as np
        leaves: list = []
        treedef = _spell(payload, leaves)
        leaf_s = ",".join(
            f"{_dtype_name(l)}"
            f"{tuple(getattr(l, 'shape', np.shape(l)))!r}"
            for l in leaves)
        return f"PyTreeDef({treedef})|{leaf_s}"
    except Exception:  # exotic payloads still fingerprint by repr-type
        return f"<{type(payload).__name__}>"


@dataclasses.dataclass
class ScheduleEntry:
    """One recorded collective boundary."""

    kind: str                 # e.g. "dispatch", "allgather", "checkpoint"
    axis: Optional[str]       # mesh axis, when the op names one
    fingerprint: str          # payload treedef/dtype/shape digest
    stack: List[FrameTup]

    def brief(self) -> str:
        fp = self.fingerprint
        if len(fp) > 60:
            fp = fp[:57] + "..."
        return f"{self.kind}(axis={self.axis or '-'}, {fp})"


@dataclasses.dataclass
class DivergenceReport:
    """Two participants disagree on schedule position ``index``."""

    pid_a: int
    pid_b: int
    index: int
    entry_a: Optional[ScheduleEntry]   # None: participant a ended early
    entry_b: Optional[ScheduleEntry]
    schedule_a: List[ScheduleEntry]
    schedule_b: List[ScheduleEntry]

    def render(self) -> str:
        def side(pid, entry, sched):
            lines = [f"  process {pid} at #{self.index}: "
                     + (entry.brief() if entry else "<schedule ended>")]
            if entry is not None:
                lines.append(_fmt_stack(entry.stack, indent="      "))
            lines.append(f"   schedule of process {pid} "
                         f"({len(sched)} entries):")
            lines += [f"      #{i} {e.brief()}"
                      for i, e in enumerate(sched)]
            return lines

        out = ["spmdcheck: collective schedules diverge"]
        out += side(self.pid_a, self.entry_a, self.schedule_a)
        out += side(self.pid_b, self.entry_b, self.schedule_b)
        out.append("  one process will enter a collective the other "
                   "never issues — on a real pod this deadlocks")
        return "\n".join(out)


class SpmdDivergenceError(RuntimeError):
    """Raised by :func:`check_clean` when divergences were recorded."""


class _Recorder:
    """The one global schedule table.  Guarded by a raw ``threading``
    lock allocated at install time (under lockdep this is a proxy; the
    sanitizers compose — spmdcheck never patches anything)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.schedules: Dict[int, List[ScheduleEntry]] = {}
        self.divergences: List[DivergenceReport] = []
        self.reported_pairs: set = set()
        self.notes = 0

    def reset(self):
        with self.lock:
            self.schedules.clear()
            self.divergences.clear()
            self.reported_pairs.clear()
            self.notes = 0

    def record(self, pid: int, entry: ScheduleEntry) -> None:
        with self.lock:
            self.notes += 1
            sched = self.schedules.setdefault(pid, [])
            sched.append(entry)
            self._compare_locked(pid, len(sched) - 1)

    def _compare_locked(self, pid: int, index: int) -> None:
        """Compare the fresh entry against the reference participant
        (lowest pid) at the same position, as soon as both exist."""
        ref = min(self.schedules)
        if pid == ref:
            # the reference grew: re-check any laggard already past us
            for other, osched in self.schedules.items():
                if other != ref and len(osched) > index:
                    self._diverge_locked(ref, other, index)
            return
        if len(self.schedules[ref]) > index:
            self._diverge_locked(ref, pid, index)

    def _diverge_locked(self, ref: int, pid: int, index: int) -> None:
        a = self.schedules[ref][index]
        b = self.schedules[pid][index]
        if (a.kind, a.axis, a.fingerprint) == (b.kind, b.axis,
                                               b.fingerprint):
            return
        pair = frozenset((ref, pid))
        if pair in self.reported_pairs:
            return  # one slid schedule reports once, not per entry
        self.reported_pairs.add(pair)
        if len(self.divergences) < _MAX_REPORTS:
            self.divergences.append(DivergenceReport(
                pid_a=ref, pid_b=pid, index=index, entry_a=a, entry_b=b,
                schedule_a=list(self.schedules[ref]),
                schedule_b=list(self.schedules[pid])))

    def finalize_locked_lengths(self) -> None:
        """Length mismatches (one participant simply stopped noting) —
        checked at :func:`divergences` read time, not per note, because
        schedules legitimately grow at different rates mid-run."""
        with self.lock:
            if len(self.schedules) < 2:
                return
            ref = min(self.schedules)
            rs = self.schedules[ref]
            for pid, sched in self.schedules.items():
                if pid == ref or len(sched) == len(rs):
                    continue
                pair = frozenset((ref, pid))
                if pair in self.reported_pairs:
                    continue
                self.reported_pairs.add(pair)
                n = min(len(rs), len(sched))
                if len(self.divergences) < _MAX_REPORTS:
                    self.divergences.append(DivergenceReport(
                        pid_a=ref, pid_b=pid, index=n,
                        entry_a=rs[n] if len(rs) > n else None,
                        entry_b=sched[n] if len(sched) > n else None,
                        schedule_a=list(rs), schedule_b=list(sched)))


#: None when off — the single global ``note`` reads (inertness contract)
_RECORDER: Optional[_Recorder] = None

_tls = threading.local()

_DEFAULT_PID: Optional[int] = None


def _current_pid() -> int:
    pid = getattr(_tls, "pid", None)
    if pid is not None:
        return pid
    global _DEFAULT_PID
    if _DEFAULT_PID is None:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return 0  # no group yet: a later one may still start
        _DEFAULT_PID = dist.get_rank()
    return _DEFAULT_PID


@contextlib.contextmanager
def participant(pid: int):
    """Attribute notes on this thread to emulated process ``pid`` —
    the test-side K-process emulation.  Nestable; restores the previous
    pid on exit."""
    prev = getattr(_tls, "pid", None)
    _tls.pid = int(pid)
    try:
        yield
    finally:
        _tls.pid = prev


def note(kind: str, axis: Optional[str] = None, payload=None) -> None:
    """Record one collective boundary for the current participant.

    THE hot-path contract: when the sanitizer is off this is one global
    read and a return — no allocation, no fingerprinting."""
    rec = _RECORDER
    if rec is None:
        return
    rec.record(_current_pid(), ScheduleEntry(
        kind=kind, axis=axis, fingerprint=_fingerprint(payload),
        stack=_cheap_stack(skip=2)))


# ------------------------------------------------------------------ API
def install() -> None:
    """Start recording; idempotent.  Nothing is patched — the note
    sites are compiled into the driver and gate on the recorder."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = _Recorder()


def uninstall() -> None:
    """Stop recording and drop the recorder (reports are discarded —
    read :func:`divergences` first)."""
    global _RECORDER
    _RECORDER = None


def maybe_install() -> bool:
    """The config/env gate: install iff ``Config.spmdcheck`` (or
    ``BIGDL_TPU_SPMDCHECK=1``) — the off path allocates NOTHING."""
    from bigdl_tpu_torch.utils.config import get_config
    if not get_config().spmdcheck:
        return False
    install()
    return True


def installed() -> bool:
    return _RECORDER is not None


def reset() -> None:
    """Clear schedules and reports (between independent suites)."""
    rec = _RECORDER
    if rec is not None:
        rec.reset()


def notes_recorded() -> int:
    rec = _RECORDER
    return 0 if rec is None else rec.notes


def schedules() -> Dict[int, List[ScheduleEntry]]:
    rec = _RECORDER
    if rec is None:
        return {}
    with rec.lock:
        return {p: list(s) for p, s in rec.schedules.items()}


def divergences(final: bool = False) -> List[DivergenceReport]:
    """All recorded divergences.  ``final=True`` additionally compares
    schedule LENGTHS (a participant that stopped noting early), which
    only makes sense once the emulated processes have finished."""
    rec = _RECORDER
    if rec is None:
        return []
    if final:
        rec.finalize_locked_lengths()
    with rec.lock:
        return list(rec.divergences)


def report() -> str:
    """Human summary of everything recorded so far."""
    rec = _RECORDER
    if rec is None:
        return "spmdcheck: not installed"
    ds = divergences()
    with rec.lock:
        n_sched = len(rec.schedules)
        n_notes = rec.notes
    lines = [f"spmdcheck: {n_notes} note(s) across {n_sched} "
             f"participant(s), {len(ds)} divergence(s)"]
    lines += [d.render() for d in ds]
    return "\n".join(lines)


def check_clean(final: bool = True) -> None:
    """Raise :class:`SpmdDivergenceError` naming every divergence (the
    conftest session gate)."""
    ds = divergences(final=final)
    if ds:
        raise SpmdDivergenceError(
            f"{len(ds)} collective-schedule divergence(s) detected:\n"
            + "\n".join(d.render() for d in ds))

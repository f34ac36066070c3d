"""lockdep — a TSan-lite lock-order sanitizer for the threaded plane.

Port of ``bigdl_tpu/utils/lockdep.py`` (stdlib only, an owned copy armed
by the port's ``Config.lockdep`` / ``lockdep_hold_ms``).

The static half of the deadlock story is graftlint GL202: per-file
lexical lock nesting plus one level of call expansion.  What it cannot
see is the DYNAMIC order — lock A of one module taken under lock B of
another, through callbacks, supervisors and executor threads.  This
module validates the static model at runtime, the way kernel lockdep
does: run the real test suites with every lock instrumented and let
the acquisition-order graph prove (or break) the ordering claims.

How it works
------------

``install()`` replaces ``threading.Lock`` / ``threading.RLock`` with
factories returning thin proxies around the real primitives.  A
default ``threading.Condition()`` (and everything built on it —
``Event``, ``Semaphore``, ``queue.Queue``, ``concurrent.futures``)
rides the patched factories automatically, and ``Condition(lock)``
aliasing shares the wrapped lock object, so the graph sees through the
``ReplicaSet._wake`` shape for free.

Each proxy is keyed by its ALLOCATION SITE (``file:line`` of the
constructor call) — the lockdep notion of a lock *class*: every
``RequestBatcher._cond`` across every test shares one node, so an
ordering observed between two instances generalizes the way the static
rules assume.  Per thread, a stack of held locks is kept; acquiring B
while holding A adds the edge ``A → B`` (with both acquisition stacks)
to one global graph.  At acquire time, if a path ``B →* A`` already
exists, a :class:`CycleReport` is recorded naming BOTH sides: the
current stack (holding A, acquiring B) and the recorded stacks of
every edge on the conflicting path.  The graph is kept acyclic (the
offending edge is not inserted), so one bad ordering reports once per
site pair instead of cascading.

Same-site pairs (two instances of the same lock class nested) are NOT
edges — with site-keyed classes the direction is ambiguous, and the
same-object re-take is GL202's static domain (a non-reentrant re-take
deadlocks immediately anyway).

A wall-clock **held-too-long** check rides the same accounting: a hold
longer than ``Config.lockdep_hold_ms`` (default 200 ms; 0 disables) is
recorded with its acquire stack — GL206 blocking-under-lock, observed
rather than inferred.  Slow holds are advisory (warmup compiles
legitimately serialize under the warm lock); cycles are the errors.

Inertness contract (house discipline, the ``FaultInjector`` empty-plan
shape): with ``Config.lockdep`` off nothing is allocated and nothing
is patched — ``threading.Lock is _ORIG_LOCK`` stays bitwise true,
``proxies_allocated() == 0``, and the driver/serving paths are
byte-identical (gated in ``tests/test_torch_spmdcheck.py``).

Opt-in: ``configure(lockdep=True)`` then :func:`maybe_install`, before
the threaded modules build their locks.  ``BIGDL_TPU_LOCKDEP=1 python
-m pytest tests/ ...`` arms the reference's copy from the conftest,
which patches the same ``threading`` factories, so the port's locks are
traced in those runs too.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import _thread

#: the real factories, captured at import — the off-state identity the
#: inertness gate asserts on
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_THIS_FILE = os.path.abspath(__file__)
# frames from these files are plumbing, not the caller's story
_SKIP_FILES = (_THIS_FILE, threading.__file__)

_MAX_REPORTS = 100     # bound the report lists; a broken suite floods
_STACK_DEPTH = 10

FrameTup = Tuple[str, int, str]  # (filename, lineno, funcname)


def _cheap_stack(skip: int = 2) -> List[FrameTup]:
    """A few frames of (file, line, func) without touching linecache —
    cheap enough to capture on EVERY acquire (formatting resolves
    source lines lazily, only when a report renders)."""
    out: List[FrameTup] = []
    try:
        f = sys._getframe(skip)
    except ValueError:
        return out
    while f is not None and len(out) < _STACK_DEPTH:
        fn = f.f_code.co_filename
        if fn not in _SKIP_FILES:
            out.append((fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return out


def _fmt_stack(frames: List[FrameTup], indent: str = "    ") -> str:
    if not frames:
        return indent + "<no frames>"
    return "\n".join(f"{indent}{os.path.relpath(fn) if fn.startswith(os.sep) else fn}"
                     f":{ln} in {fun}" for fn, ln, fun in frames)


def _site(skip: int = 2) -> str:
    """Allocation site of a lock: first frame outside lockdep/threading
    — the lock's *class* in the kernel-lockdep sense."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return "<unknown>"
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE and fn != _SKIP_FILES[1]:
            rel = os.path.relpath(fn) if fn.startswith(os.sep) else fn
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


@dataclasses.dataclass
class _Edge:
    """Observed order: ``a`` held while ``b`` acquired."""

    a: str
    b: str
    thread: str
    a_stack: List[FrameTup]
    b_stack: List[FrameTup]
    count: int = 1


@dataclasses.dataclass
class CycleReport:
    """One detected lock-order inversion, with both sides' stacks."""

    thread: str
    holding: str          # site of the lock currently held
    acquiring: str        # site of the lock being acquired
    path: List[str]       # acquiring ->* holding through recorded edges
    this_stack: List[FrameTup]
    conflict_edges: List[_Edge]

    def render(self) -> str:
        lines = [
            "lockdep: lock-order cycle",
            f"  thread {self.thread!r} acquiring {self.acquiring} "
            f"while holding {self.holding}:",
            _fmt_stack(self.this_stack),
            f"  but the order {' -> '.join(self.path)} was already "
            "established:",
        ]
        for e in self.conflict_edges:
            lines.append(f"  edge {e.a} -> {e.b} "
                         f"(thread {e.thread!r}, seen {e.count}x):")
            lines.append("   held at:")
            lines.append(_fmt_stack(e.a_stack, indent="      "))
            lines.append("   acquired at:")
            lines.append(_fmt_stack(e.b_stack, indent="      "))
        return "\n".join(lines)


@dataclasses.dataclass
class SlowHold:
    """A lock held past the wall-clock threshold (advisory)."""

    site: str
    held_s: float
    thread: str
    acquire_stack: List[FrameTup]

    def render(self) -> str:
        return (f"lockdep: {self.site} held {self.held_s * 1e3:.1f} ms "
                f"on thread {self.thread!r}\n"
                f"{_fmt_stack(self.acquire_stack)}")


class LockOrderError(RuntimeError):
    """Raised by :func:`check_clean` when cycles were recorded."""


class _State:
    """The one global graph.  Its own lock is a RAW ``_thread`` lock so
    the sanitizer never traces itself."""

    def __init__(self):
        self.lock = _thread.allocate_lock()
        self.installed = False
        self.hold_threshold_s = 0.0
        self.edges: Dict[Tuple[str, str], _Edge] = {}
        self.adj: Dict[str, Set[str]] = {}
        self.cycles: List[CycleReport] = []
        self.slow_holds: List[SlowHold] = []
        self.reported_pairs: Set[frozenset] = set()
        self.proxies = 0
        self.acquires = 0

    def reset_graph(self):
        self.edges.clear()
        self.adj.clear()
        self.cycles.clear()
        self.slow_holds.clear()
        self.reported_pairs.clear()


_STATE = _State()

_tls = threading.local()


class _Held:
    __slots__ = ("obj", "site", "t0", "frames")

    def __init__(self, obj, site, t0, frames):
        self.obj = obj
        self.site = site
        self.t0 = t0
        self.frames = frames


def _held_list() -> list:
    lst = getattr(_tls, "held", None)
    if lst is None:
        lst = _tls.held = []
    return lst


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """BFS over the order graph; path [src, ..., dst] or None.
    Caller holds the state lock."""
    if src == dst:
        return [src]
    prev: Dict[str, str] = {}
    frontier = [src]
    seen = {src}
    while frontier:
        nxt: List[str] = []
        for u in frontier:
            for v in _STATE.adj.get(u, ()):  # deterministic enough
                if v in seen:
                    continue
                prev[v] = u
                if v == dst:
                    path = [v]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                seen.add(v)
                nxt.append(v)
        frontier = nxt
    return None


def _note_acquire(proxy) -> None:
    held = _held_list()
    frames = _cheap_stack(skip=3)
    entry = _Held(proxy, proxy._ld_site, time.monotonic(), frames)
    first_hold = all(h.obj is not proxy for h in held)
    if held and first_hold:
        tname = threading.current_thread().name
        with _STATE.lock:
            _STATE.acquires += 1
            for h in held:
                if h.site == proxy._ld_site:
                    continue  # same lock class: direction ambiguous
                _add_edge_locked(h, entry, tname)
    else:
        with _STATE.lock:
            _STATE.acquires += 1
    held.append(entry)


def _add_edge_locked(a: _Held, b: _Held, thread_name: str) -> None:
    key = (a.site, b.site)
    edge = _STATE.edges.get(key)
    if edge is not None:
        edge.count += 1
        return
    # new order a -> b: does b already reach a?  Then two threads can
    # interleave the two orders and deadlock.
    path = _find_path(b.site, a.site)
    if path is not None:
        pair = frozenset((a.site, b.site))
        if pair not in _STATE.reported_pairs:
            _STATE.reported_pairs.add(pair)
            conflict = [_STATE.edges[(path[i], path[i + 1])]
                        for i in range(len(path) - 1)
                        if (path[i], path[i + 1]) in _STATE.edges]
            if len(_STATE.cycles) < _MAX_REPORTS:
                _STATE.cycles.append(CycleReport(
                    thread=thread_name, holding=a.site,
                    acquiring=b.site, path=path,
                    this_stack=b.frames, conflict_edges=conflict))
        return  # keep the graph acyclic: report once, don't cascade
    _STATE.edges[key] = _Edge(a.site, b.site, thread_name,
                              a.frames, b.frames)
    _STATE.adj.setdefault(a.site, set()).add(b.site)


def _note_release(proxy) -> None:
    held = _held_list()
    for i in range(len(held) - 1, -1, -1):
        if held[i].obj is proxy:
            entry = held.pop(i)
            thr = _STATE.hold_threshold_s
            if thr > 0:
                dt = time.monotonic() - entry.t0
                if dt > thr:
                    with _STATE.lock:
                        if len(_STATE.slow_holds) < _MAX_REPORTS:
                            _STATE.slow_holds.append(SlowHold(
                                entry.site, dt,
                                threading.current_thread().name,
                                entry.frames))
            return
    # release of a lock this thread never tracked (e.g. acquired
    # before install, or handed across threads) — nothing to pop


class _LockProxy:
    """Wraps a non-reentrant lock.  Deliberately does NOT define
    ``_release_save``/``_acquire_restore``/``_is_owned`` so a
    ``Condition`` built on it falls back to ``self.release()`` /
    ``self.acquire()`` — every wait/notify round-trip flows through the
    proxy and the accounting stays truthful."""

    __slots__ = ("_ld_inner", "_ld_site")

    def __init__(self, inner, site):
        self._ld_inner = inner
        self._ld_site = site

    def acquire(self, blocking=True, timeout=-1):
        got = self._ld_inner.acquire(blocking, timeout)
        if got:
            _note_acquire(self)
        return got

    def release(self):
        self._ld_inner.release()
        _note_release(self)

    def locked(self):
        return self._ld_inner.locked()

    def __getattr__(self, name):
        # delegate everything else (e.g. ``_at_fork_reinit``, which
        # concurrent.futures registers as an at-fork hook) to the real
        # lock.  A plain Lock has no ``_release_save`` family, so a
        # Condition built on a _LockProxy still falls back to the
        # proxy's acquire/release — accounting stays truthful.
        return getattr(object.__getattribute__(self, "_ld_inner"), name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<lockdep Lock {self._ld_site} of {self._ld_inner!r}>"


class _RLockProxy(_LockProxy):
    """Wraps an RLock.  Forwards the Condition fast-path hooks to the
    inner lock WITH held-stack save/restore, because the default
    ``Condition._release_save`` (one ``release()``) is wrong for a
    recursively-held RLock."""

    __slots__ = ()

    def _release_save(self):
        held = _held_list()
        mine = [h for h in held if h.obj is self]
        for h in mine:
            held.remove(h)
        return (self._ld_inner._release_save(), mine)

    def _acquire_restore(self, state):
        inner_state, mine = state
        self._ld_inner._acquire_restore(inner_state)
        _held_list().extend(mine)

    def _is_owned(self):
        return self._ld_inner._is_owned()


def _lock_factory():
    with _STATE.lock:
        _STATE.proxies += 1
    return _LockProxy(_ORIG_LOCK(), _site())


def _rlock_factory(*args, **kwargs):
    with _STATE.lock:
        _STATE.proxies += 1
    return _RLockProxy(_ORIG_RLOCK(*args, **kwargs), _site())


# ------------------------------------------------------------------ API
def install(hold_ms: Optional[float] = None) -> None:
    """Patch the lock factories; idempotent.  Call BEFORE the threaded
    modules construct their locks (locks created earlier stay raw and
    invisible — harmless, just unobserved)."""
    if _STATE.installed:
        return
    if hold_ms is None:
        from bigdl_tpu_torch.utils.config import get_config
        hold_ms = float(get_config().lockdep_hold_ms)
    _STATE.hold_threshold_s = max(0.0, hold_ms) / 1e3
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _STATE.installed = True


def uninstall() -> None:
    """Restore the stdlib factories.  Existing proxies keep working
    (they wrap real locks); the graph and reports are kept for
    inspection until :func:`reset`."""
    if not _STATE.installed:
        return
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    _STATE.installed = False


def maybe_install() -> bool:
    """The config/env gate: install iff ``Config.lockdep`` (or
    ``BIGDL_TPU_LOCKDEP=1``) — the off path allocates NOTHING."""
    from bigdl_tpu_torch.utils.config import get_config
    if not get_config().lockdep:
        return False
    install()
    return True


def installed() -> bool:
    return _STATE.installed


def reset() -> None:
    """Clear the graph and all reports (between independent suites)."""
    with _STATE.lock:
        _STATE.reset_graph()


def cycles() -> List[CycleReport]:
    with _STATE.lock:
        return list(_STATE.cycles)


def slow_holds() -> List[SlowHold]:
    with _STATE.lock:
        return list(_STATE.slow_holds)


def proxies_allocated() -> int:
    return _STATE.proxies


def acquire_count() -> int:
    return _STATE.acquires


def graph_edges() -> Dict[Tuple[str, str], int]:
    """(a, b) -> times observed; dashboards/tests."""
    with _STATE.lock:
        return {k: e.count for k, e in _STATE.edges.items()}


def report() -> str:
    """Human summary of everything recorded so far."""
    cs, sh = cycles(), slow_holds()
    lines = [f"lockdep: {len(_STATE.edges)} edge(s), {len(cs)} "
             f"cycle(s), {len(sh)} slow hold(s), "
             f"{_STATE.proxies} lock(s) instrumented"]
    for c in cs:
        lines.append(c.render())
    for s in sh:
        lines.append(s.render())
    return "\n".join(lines)


def check_clean() -> None:
    """Raise :class:`LockOrderError` naming every cycle (the conftest
    session gate).  Slow holds never fail — they are advisory."""
    cs = cycles()
    if cs:
        raise LockOrderError(
            f"{len(cs)} lock-order cycle(s) detected:\n"
            + "\n".join(c.render() for c in cs))

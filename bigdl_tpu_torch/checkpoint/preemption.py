"""Preemption handling: SIGTERM/SIGINT into a clean final snapshot (port of
``bigdl_tpu/checkpoint/preemption.py``).

Spot and preemptible pools deliver eviction as a signal with a grace
window.  The handler here only RECORDS the request — the
training driver polls :attr:`triggered` at block boundaries, finishes
the in-flight block (so the saved state sits exactly on a replayed
iteration boundary — the bitwise-resume invariant), writes one final
synchronous snapshot, and returns from ``optimize()`` cleanly with
``state["preempted"] = True``.

Doing real work inside a signal handler (fsync, device syncs) is how
checkpoints get torn; a one-line flag set is async-signal-safe by
construction.  The driver installs the handler only for the span of
``optimize()`` and only from the main thread.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Dict, Optional, Tuple

logger = logging.getLogger("bigdl_tpu_torch.checkpoint")

DEFAULT_SIGNALS: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    """Installable signal→flag bridge.

    The driver calls install() before its loop and uninstall() in the
    loop's ``finally``.  Installation outside the main thread is a documented
    no-op (CPython only delivers signals to the main thread, and
    ``signal.signal`` raises elsewhere) — ``installed`` stays False and
    ``triggered`` can still be set programmatically via
    :meth:`request` (tests, external schedulers).
    """

    def __init__(self, signals: Tuple[int, ...] = DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev: Dict[int, object] = {}
        self.installed = False
        self.signum: Optional[int] = None

    # -- signal side ----------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # flag only — everything heavy happens on the driver thread
        self.signum = signum
        self._event.set()

    def request(self) -> None:
        """Programmatic preemption (tests / cluster agents)."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    # -- lifecycle ------------------------------------------------------
    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "preemption handler not installed: signal handlers can "
                "only be set from the main thread (use request() to "
                "trigger programmatically)")
            return self
        for s in self.signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self.installed = True
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # pragma: no cover - teardown
                pass
        self._prev.clear()
        self.installed = False

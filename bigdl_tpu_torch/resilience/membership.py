"""Cluster membership epochs — the roster layer under elastic training.

Port of ``bigdl_tpu/resilience/membership.py``.  One process drives one
device here, so a roster is a tuple of launch ranks (the reference's
holds devices): each epoch's roster is a prefix of the ranks the job
was launched with.

Reference: BigDL 2.0's position that the pipeline must assume the
cluster under it can change shape (arXiv:2204.01715), and the ZeRO
observation that the reduce-scatter/owned-slice/all-gather protocol is
world-size-parameterized (arXiv:2004.13336) — gradient SUMS are
invariant under resharding, so a training run can shrink or regrow
without changing its loss trajectory at a replay boundary.

One :class:`ClusterMembership` instance tracks a monotonically
increasing **membership epoch**.  Each epoch freezes a device roster (a
prefix of the devices the layer was armed with); a preemption signal,
an injected ``host_loss``/``device_loss`` fault, or an explicit
``request_resize`` opens the next epoch.  The training driver compares
``epoch()`` against the epoch it dispatched under at the replay
boundary it already crosses (the one-block-behind fetch) — detecting a
resize costs **zero additional host synchronization**.

Change semantics mirror PR-7 preemption handling:

- *graceful* (``request_resize``, ``host_loss`` with warning): the
  driver replays the in-flight block, writes a final synchronous
  snapshot, then resumes on the new roster — ``steps_lost_to_resize``
  is 0;
- *abrupt* (``device_loss``): the in-flight block is abandoned (its
  device buffers are gone by assumption) and the run resumes from
  ``latest_valid()`` — steps since that snapshot are the measured loss.

The layer is host-side bookkeeping only: rosters are tuples of launch
ranks, epochs are ints, and every mutation is behind
one lock so signal handlers, fault-injection sites, and the driver
thread can race safely.  Like every resilience feature it is provably
inert when off — no ``ClusterMembership`` object exists unless a fault
plan or an explicit ``set_elastic()`` arms one, gated in
``tests/test_torch_membership.py``.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple


class MembershipChanged(RuntimeError):
    """Raised by the training driver when it observes a membership epoch
    newer than the one it dispatched under.  Carries everything the
    elastic resume path needs: the target epoch, whether the transition
    was graceful (in-flight block replayed + snapshotted) and the
    driver's position at detection time (for ``steps_lost_to_resize``).
    """

    def __init__(self, epoch: "MembershipEpoch", graceful: bool,
                 detected_neval: int, t0: float):
        super().__init__(
            f"membership epoch {epoch.epoch}: world {epoch.world} "
            f"({epoch.reason}, {'graceful' if graceful else 'abrupt'})")
        self.epoch = epoch
        self.graceful = graceful
        self.detected_neval = detected_neval
        self.t0 = t0  # monotonic detection time → resize_downtime_s


class MembershipEpoch:
    """One frozen roster.  Immutable after construction — readers hold
    a reference without the membership lock."""

    __slots__ = ("epoch", "devices", "world", "reason", "graceful")

    def __init__(self, epoch: int, devices: Tuple, reason: str,
                 graceful: bool):
        self.epoch = int(epoch)
        self.devices = tuple(devices)
        self.world = len(self.devices)
        self.reason = reason
        self.graceful = bool(graceful)

    def __repr__(self):
        return (f"MembershipEpoch(epoch={self.epoch}, world={self.world},"
                f" reason={self.reason!r}, graceful={self.graceful})")


class ClusterMembership:
    """Monotonic membership epochs over a fixed device pool.

    Armed with the full device list; every epoch's roster is a prefix
    of it (a shrink keeps the lowest-indexed survivors, a regrow
    re-admits the departed tail — the analog of pod re-provisioning;
    ``DistriOptimizer`` builds the roster's process group from it).  ``epoch()`` is designed to be polled from the
    driver's hot loop: one lock acquisition, no allocation.
    """

    def __init__(self, devices: Sequence, registry=None, recorder=None):
        pool = tuple(devices)
        if not pool:
            raise ValueError("ClusterMembership needs >= 1 device")
        self._pool = pool
        self._registry = registry
        self._recorder = recorder
        self._lock = threading.Lock()
        # the epoch ledger: append-only history of frozen rosters
        # guarded-by: _lock
        self._epochs: List[MembershipEpoch] = [
            MembershipEpoch(1, pool, "initial", True)]
        self._emit(self._epochs[0])

    # ------------------------------------------------------------- reads
    def epoch(self) -> int:
        """Current epoch number (driver hot-loop poll)."""
        with self._lock:
            return self._epochs[-1].epoch

    def current(self) -> MembershipEpoch:
        with self._lock:
            return self._epochs[-1]

    def history(self) -> List[MembershipEpoch]:
        with self._lock:
            return list(self._epochs)

    def pool_size(self) -> int:
        return len(self._pool)

    def changed_since(self, epoch: int) -> Optional[MembershipEpoch]:
        """The newest epoch if it is newer than ``epoch``, else None —
        the driver's replay-boundary check, one lock round-trip."""
        with self._lock:
            cur = self._epochs[-1]
        # the epoch ledger is the control plane's broadcast: every host
        # observes the same ledger, so the driver's resize branch is
        # uniform at its replay boundary
        # replicated-by: membership-epoch-ledger
        return cur if cur.epoch > epoch else None

    # ----------------------------------------------------------- signals
    def request_resize(self, world: int,
                       reason: str = "resize") -> MembershipEpoch:
        """Graceful resize to ``world`` devices (explicit operator/plan
        request).  No-op returning the current epoch when the roster
        already has that size."""
        return self._open(world, reason, graceful=True)

    def signal_host_loss(self, to: Optional[int] = None) -> MembershipEpoch:
        """A host received its preemption warning: graceful shrink (the
        warning window is long enough to replay + snapshot).  Default
        target: half the current world, floor 1."""
        with self._lock:
            cur = self._epochs[-1].world
        return self._open(to if to is not None else max(1, cur // 2),
                          "host_loss", graceful=True)

    def signal_device_loss(self,
                           to: Optional[int] = None) -> MembershipEpoch:
        """A device vanished without warning: abrupt shrink — the
        in-flight block is unrecoverable.  Default target: current
        world minus one, floor 1."""
        with self._lock:
            cur = self._epochs[-1].world
        return self._open(to if to is not None else max(1, cur - 1),
                          "device_loss", graceful=False)

    # ------------------------------------------------------------ intern
    def _open(self, world: int, reason: str,
              graceful: bool) -> MembershipEpoch:
        world = int(world)
        # replicated-by: membership-epoch-ledger
        if not 1 <= world <= len(self._pool):
            raise ValueError(
                f"resize target {world} outside [1, {len(self._pool)}] "
                f"(the armed device pool bounds every roster)")
        with self._lock:
            cur = self._epochs[-1]
            # replicated-by: membership-epoch-ledger
            if cur.world == world:
                return cur  # roster unchanged — no epoch churn
            nxt = MembershipEpoch(cur.epoch + 1, self._pool[:world],
                                  reason, graceful)
            self._epochs.append(nxt)
        self._emit(nxt)
        return nxt

    def _emit(self, ep: MembershipEpoch) -> None:
        if self._registry is not None:
            self._registry.gauge(
                "resilience/membership_epoch").set(ep.epoch)
        if self._recorder is not None:
            self._recorder.record(
                "membership_epoch", cat="resilience", epoch=ep.epoch,
                world=ep.world, reason=ep.reason, graceful=ep.graceful)

    def describe(self) -> str:
        with self._lock:
            eps = list(self._epochs)
        return " -> ".join(f"e{e.epoch}:w{e.world}({e.reason})"
                           for e in eps)


def monotonic() -> float:
    """Detection-time clock for ``MembershipChanged.t0`` (separated so
    tests can monkeypatch downtime measurement deterministically)."""
    return time.monotonic()

"""CheckpointManager: retention, discovery, asynchronous save and exact
resume (port of ``bigdl_tpu/checkpoint/manager.py``).

Files are named ``model.<neval>``, as the reference names them.

- **asynchronous save**: the driver pays the copy to the host and a
  bounded enqueue (``checkpoint/driver_stall_s``,
  ``checkpoint/stall_fraction``); serialization, CRC, fsync and retention
  run on the writer thread;
- **retention**: the newest ``keep_last`` snapshots always survive;
  ``keep_every=N`` also keeps every N-th step;
- **latest valid**: candidates are verified (manifest and streamed CRC)
  newest first, and a torn or corrupt one is skipped, never loaded;
- **full state**: params, model state, optimizer state (each in the
  reference's tree layout), driver counters, the seed and the dataset's
  shuffle position, so :meth:`restore_into` resumes mid-epoch exactly.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
from typing import List, Optional

import torch

from bigdl_tpu_torch.checkpoint.snapshot import (AsyncSnapshotWriter,
                                                 SnapshotError,
                                                 capture_to_host,
                                                 load_snapshot,
                                                 read_manifest,
                                                 verify_snapshot,
                                                 write_snapshot)

logger = logging.getLogger("bigdl_tpu_torch.checkpoint")

_SNAP_RE = re.compile(r"^model\.(\d+)$")


class CheckpointManager:
    """Snapshot lifecycle for one checkpoint directory.

    ``registry``: an optional ``telemetry.MetricRegistry`` where save
    durations, bytes and the driver's stall fraction land (the driver
    passes its own).
    """

    def __init__(self, directory: str, keep_last: int = 5,
                 keep_every: int = 0, overwrite: bool = True,
                 async_save: bool = True, registry=None,
                 queue_depth: int = 2, flight=None):
        self.directory = directory
        self.keep_last = max(1, int(keep_last))
        self.keep_every = max(0, int(keep_every))
        self.overwrite = overwrite
        self._writer = AsyncSnapshotWriter(queue_depth) if async_save \
            else None
        self._registry = registry
        # optional telemetry.FlightRecorder and the run's trace id (the
        # driver stamps both per run): a commit is a flight event, fired
        # on the writer thread after the fsync, so the recorder holds
        # what reached the disk
        self.flight = flight
        self.trace_id: Optional[str] = None
        self._t_run_start: Optional[float] = None
        self._driver_stall_s = 0.0
        # step of the newest save THIS manager issued (None = none yet);
        # the preemption path reads it to skip a redundant final
        # snapshot when a trigger checkpoint just covered the same
        # iteration
        self.last_saved_step: Optional[int] = None
        # GC pin: the step latest_valid() last returned is excluded
        # from _gc until restore completes — a retention ring turning
        # over during a slow (e.g. elastic) restore must not delete the
        # snapshot mid-read.  _gc runs on the writer thread, the pin is
        # taken on the driver/restore thread, hence the lock.
        self._pin_lock = threading.Lock()
        self._pinned_step: Optional[int] = None  # guarded-by: _pin_lock
        os.makedirs(directory, exist_ok=True)

    # --------------------------------------------------------- discovery
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"model.{int(step)}")

    def steps(self) -> List[int]:
        """Snapshot steps present on disk, ascending (no validity
        check)."""
        out = []
        for f in os.listdir(self.directory):
            m = _SNAP_RE.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # acquires: snapshot_pin
    def latest_valid(self, verify: bool = True) -> Optional[str]:
        """Newest snapshot that passes integrity verification; corrupt
        or torn candidates are logged and SKIPPED (never loaded) — the
        retry loop then resumes from the last good state instead of
        crashing again on a bad file.

        The returned snapshot is PINNED against ``keep_last`` GC until
        :meth:`unpin` runs (``restore``/``restore_into`` release it on
        every path, success or raise) — otherwise a retention ring
        turning over during a slow restore could delete the snapshot
        between this verify pass and the load."""
        for step in reversed(self.steps()):
            path = self.path_for(step)
            ok, detail = verify_snapshot(path) if verify else (True, "")
            if ok:
                with self._pin_lock:
                    self._pinned_step = step  # acquires: snapshot_pin
                return path
            logger.warning("checkpoint discovery: skipping %s (%s)",
                           path, detail)
            if self._registry is not None:
                self._registry.counter(
                    "checkpoint/corrupt_skipped").inc()
        return None

    # releases: snapshot_pin
    def unpin(self) -> None:
        """Release the :meth:`latest_valid` GC pin (idempotent)."""
        with self._pin_lock:
            self._pinned_step = None  # releases: snapshot_pin

    def manifest(self, path: Optional[str] = None) -> Optional[dict]:
        """The manifest of ``path``, or of the newest valid snapshot (None
        when there is none); inspecting holds no pin afterwards."""
        if path is None:
            try:
                path = self.latest_valid()
                if path is None:
                    return None
                return read_manifest(path)
            finally:
                self.unpin()
        return read_manifest(path)

    # -------------------------------------------------------------- save
    def mark_run_start(self) -> None:
        """Anchor the stall-fraction denominator at driver-loop start."""
        self._t_run_start = time.perf_counter()
        self._driver_stall_s = 0.0

    # replay-boundary: callers reach save() only at block edges (the
    # producing block is synced — see snapshot.capture_to_host)
    def save(self, step: int, params, model_state=None, opt_state=None,
             driver_state: Optional[dict] = None,
             run_state: Optional[dict] = None,
             schema: Optional[dict] = None, sync: bool = False) -> str:
        """Capture + commit one snapshot.

        Driver-path cost: the device→host capture (at a replay
        boundary the producing block is already synced — see
        ``snapshot.capture_to_host``) plus a bounded enqueue; the
        expensive serialize/CRC/fsync/GC runs on the writer thread.
        ``sync=True`` (or ``async_save=False``) commits inline —
        the preemption path and the legacy shim use that.

        Returns the path the snapshot commits to."""
        t0 = time.perf_counter()
        path = self.path_for(step)
        if os.path.exists(path) and not self.overwrite:
            raise FileExistsError(
                f"{path} exists (reference: overWriteCheckpoint not set)")
        host = capture_to_host((params, model_state, opt_state))
        hp, hm, ho = host
        drv = dict(driver_state) if driver_state else None
        run = dict(run_state) if run_state else None

        def job():
            t_w0 = time.perf_counter()
            write_snapshot(path, params=hp, model_state=hm, opt_state=ho,
                           driver_state=drv, run_state=run, step=step,
                           schema=schema, overwrite=self.overwrite)
            self._gc()
            if self._registry is not None:
                reg = self._registry
                reg.histogram("checkpoint/save_s").observe(
                    time.perf_counter() - t_w0)
                reg.counter("checkpoint/bytes_written").inc(
                    _tree_bytes(host))
                reg.counter("checkpoint/snapshots_committed").inc()
            if self.flight is not None:
                self.flight.record("checkpoint_commit", cat="driver",
                                   trace_id=self.trace_id, step=step,
                                   path=path)
            logger.info("checkpoint saved to %s", path)

        if sync or self._writer is None:
            job()
        else:
            # context travels with the job: a deferred write error
            # names exactly which snapshot was lost
            self._writer.submit(job, context=f"step {step} → {path}")
        self.last_saved_step = int(step)
        stall = time.perf_counter() - t0
        self._driver_stall_s += stall
        if self._registry is not None:
            self._registry.histogram(
                "checkpoint/driver_stall_s").observe(stall)
            self._registry.gauge("checkpoint/stall_fraction").set(
                self.stall_fraction())
        return path

    def stall_fraction(self) -> float:
        """Cumulative driver-side checkpoint time over run wall time —
        the number the async path exists to keep near zero (bench rider
        ``checkpoint_stall_fraction``)."""
        if self._t_run_start is None:
            return 0.0
        wall = time.perf_counter() - self._t_run_start
        return self._driver_stall_s / wall if wall > 0 else 0.0

    def _gc(self) -> None:
        """Retention: newest ``keep_last`` always survive; with
        ``keep_every=N`` every snapshot whose step is a multiple of N
        is pinned too.  Runs on the writer thread after each commit."""
        steps = self.steps()
        keep = set(steps[-self.keep_last:])
        if self.keep_every:
            keep.update(s for s in steps
                        if s and s % self.keep_every == 0)
        with self._pin_lock:
            pinned = self._pinned_step
        if pinned is not None:
            keep.add(pinned)  # a restore is reading this snapshot
        for s in steps:
            if s not in keep:
                try:
                    os.unlink(self.path_for(s))
                except OSError:  # already gone — racing GC is benign
                    pass

    def wait(self) -> None:
        """Block until every pending async save committed (surfaces
        deferred write errors)."""
        if self._writer is not None:
            self._writer.drain()

    def close(self, raise_errors: bool = True) -> None:
        if self._writer is not None:
            self._writer.close(raise_errors=raise_errors)

    # ----------------------------------------------------------- restore
    # acquires: snapshot_pin
    def restore(self, path: Optional[str] = None, *,
                verified: bool = False) -> dict:
        """Load a snapshot blob (latest valid when ``path`` is None).
        ``verified=True``: the caller's path already came from
        :meth:`latest_valid`, whose streamed CRC pass covers the whole
        file — skip the second end-to-end read.  Raises SnapshotError
        when nothing loadable exists.

        On success the snapshot stays pinned against GC (ownership of
        the pin passes to the caller — ``restore_into`` releases it
        once the state is applied); on ANY raise the pin is released
        here, so a failed restore cannot wedge retention."""
        try:
            if path is None:
                path = self.latest_valid()
                if path is None:
                    raise SnapshotError(
                        f"no valid checkpoint under {self.directory}")
                verified = True
            return load_snapshot(path, verify=not verified)
        except BaseException:
            self.unpin()
            raise

    def restore_into(self, optimizer, path: Optional[str] = None, *,
                     verified: bool = False) -> dict:
        """Apply a snapshot to an :class:`~bigdl_tpu_torch.optim.optimizer.
        Optimizer` so its next ``optimize()`` resumes mid-epoch
        EXACTLY: model params/state, optimizer state (validated against
        the saved schema at optimize() time), driver counters, seed and
        the dataset shuffle position.  Returns the blob.

        The snapshot stays GC-pinned for the whole application (the
        caller's ``latest_valid`` pin, or the one ``restore`` takes);
        the ``finally`` releases it on every path, raise included."""
        try:
            blob = self.restore(path, verified=verified)
            manifest_schema = (blob.get("manifest") or {}).get("schema")
            if manifest_schema is not None:
                # architecture drift is checked BEFORE the snapshot's
                # params overwrite the model (afterwards the drift is
                # invisible — the restored params ARE the old
                # architecture); grad_sync / bucket-plan drift is
                # checked at optimize(), where the sync mode is resolved
                from bigdl_tpu_torch.checkpoint.schema import \
                    validate_schema
                cur = getattr(optimizer, "_model_params_schema",
                              lambda: None)()
                if cur is not None:
                    validate_schema(
                        {"params": manifest_schema.get("params")},
                        {"params": cur}, source="restore_into")
            optimizer._load_training_state(blob["params"],
                                           blob["model_state"],
                                           blob["opt_state"])
            manifest = blob.get("manifest") or {}
            optimizer._resume_schema = manifest.get("schema")
            if blob["driver_state"]:
                optimizer.set_state(blob["driver_state"])
            run = blob.get("run") or {}
            if run.get("seed") is not None:
                optimizer.set_seed(int(run["seed"]))
            pos = run.get("dataset_position")
            restore_pos = getattr(optimizer.dataset, "restore_position",
                                  None)
            if pos and restore_pos is not None:
                restore_pos(pos)
            return blob
        finally:
            self.unpin()


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))

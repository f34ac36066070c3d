"""Load-driven replica autoscaling over a ReplicaSet.

Port of ``bigdl_tpu/frontend/autoscale.py`` (an owned copy).  The
:class:`~bigdl_tpu_torch.resilience.ReplicaSet` records the signals
(per-replica queue depth, the batcher's seconds-per-request drain EWMA,
batch occupancy) and has the actuator
(``ReplicaSet.set_replica_count``); this controller closes the loop.

**Load signal.**  Per active replica::

    busy_i = min(1, queue_depth_i * drain_ewma_s_i / horizon_s)

— the estimated seconds of backlog in replica *i*'s queue, normalized
by the sampling horizon: ``busy = 1`` means the replica holds at least
one full sampling interval's worth of work (saturated).  Before the
first dispatch (no EWMA yet) the fallback is ``queue_depth /
max_batch_size`` — "queued dispatches", the pure queue-depth signal.
The set-level load is the mean over active replicas, so it is
comparable across replica counts (load 0.5 at 2 replicas and at 6
replicas mean the same per-replica pressure).

**Controller.**  Deliberately boring — hysteresis + cooldown, the
thing every production autoscaler converges to:

- scale UP by one replica after ``up_consecutive`` consecutive samples
  with ``load >= high_watermark``;
- scale DOWN by one after ``down_consecutive`` consecutive samples
  with ``load <= low_watermark`` (down is slower than up by default:
  adding capacity late costs SLO, removing it late costs only money);
- never within ``cooldown_s`` of the previous action (a grow's warmup
  + queue redistribution must settle before the signal is trusted
  again), never outside ``[min_replicas, max_replicas]``.

``step()`` is the whole brain and takes an injectable ``now`` — unit
tests drive spike/decay scenarios deterministically with a fake clock
and never sleep.  ``start()`` wraps it in a daemon sampling thread for
production.

Scale actions run ON the controller thread and block it (a grow pays
the new replica's bucket warmup) — by design: while capacity is changing, sampling
is paused, which is exactly what the cooldown would enforce anyway.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

logger = logging.getLogger("bigdl_tpu_torch.frontend")


class ReplicaAutoscaler:
    """See module docstring.  ``registry`` defaults to the replica
    set's own, so ``frontend/autoscale_*`` counters and the
    ``frontend/replicas`` / ``frontend/load`` gauges scrape from the
    same ``/metrics`` source as the ``resilience/*`` family."""

    def __init__(self, replica_set, *, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 high_watermark: float = 0.75,
                 low_watermark: float = 0.15,
                 interval_s: float = 0.25,
                 up_consecutive: int = 2,
                 down_consecutive: int = 4,
                 cooldown_s: float = 2.0,
                 horizon_s: Optional[float] = None,
                 scale_timeout_s: float = 30.0,
                 registry=None, clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1: {min_replicas}")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if not (0.0 <= low_watermark < high_watermark):
            raise ValueError(
                f"need 0 <= low_watermark < high_watermark, got "
                f"{low_watermark} / {high_watermark}")
        self.rs = replica_set
        self.min_replicas = int(min_replicas)
        self.max_replicas = (int(max_replicas)
                             if max_replicas is not None else None)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.interval_s = float(interval_s)
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.cooldown_s = float(cooldown_s)
        self.horizon_s = (float(horizon_s) if horizon_s is not None
                          else self.interval_s)
        self.scale_timeout_s = float(scale_timeout_s)
        self.registry = (registry if registry is not None
                         else replica_set.registry)
        self._clock = clock
        # controller state: only step() mutates it, and step() is
        # serialized by _step_lock (the sampling thread and a test
        # driving step() directly must not interleave half-updates)
        self._step_lock = threading.Lock()
        self._above = 0                    # guarded-by: _step_lock
        self._below = 0                    # guarded-by: _step_lock
        # guarded-by: _step_lock
        self._last_action_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for c in ("autoscale_up", "autoscale_down"):
            self.registry.counter(f"frontend/{c}")
        self.registry.gauge("frontend/replicas").set(
            replica_set.n_replicas)

    # -- signal ------------------------------------------------------------
    def load(self) -> float:
        """Mean per-replica busyness in [0, 1] (module docstring)."""
        ixs = self.rs.active_indices()
        if not ixs:
            return 0.0
        total = 0.0
        for i in ixs:
            svc = self.rs.replica(i)
            depth = svc.queue_depth()
            spr = svc.drain_ewma_s
            if spr is not None:
                busy = depth * spr / max(self.horizon_s, 1e-6)
            else:
                busy = depth / max(1, svc.max_batch_size)
            total += min(1.0, busy)
        return total / len(ixs)

    # -- controller --------------------------------------------------------
    def step(self, now: Optional[float] = None) -> dict:
        """One sample → maybe one scale action.  Returns the decision
        record (load, counts, action taken) — what the sampling thread
        logs and what tests assert on."""
        if now is None:
            now = self._clock()
        with self._step_lock:
            load = self.load()
            self.registry.gauge("frontend/load").set(round(load, 4))
            n = self.rs.n_replicas
            self._above = self._above + 1 \
                if load >= self.high_watermark else 0
            self._below = self._below + 1 \
                if load <= self.low_watermark else 0
            action = None
            in_cooldown = (
                self._last_action_t is not None
                and now - self._last_action_t < self.cooldown_s)
            cap = self.max_replicas
            if not in_cooldown:
                if self._above >= self.up_consecutive \
                        and (cap is None or n < cap):
                    action = "up"
                elif self._below >= self.down_consecutive \
                        and n > self.min_replicas:
                    action = "down"
            if action is not None:
                target = n + 1 if action == "up" else n - 1
                # the scale call blocks this thread (grow pays the
                # bucket warmup; shrink drains a backlog) — sampling pausing
                # while capacity changes is intended (see module
                # docstring); no autoscaler lock is held around it
                # beyond the step serialization.  The timeout is
                # mandatory here: an unbounded shrink onto a WEDGED
                # replica would park this thread (and the set's scale
                # lock) forever — the stranded sweep past the deadline
                # is exactly the escape hatch set_replica_count
                # provides
                self.rs.set_replica_count(
                    target, timeout=self.scale_timeout_s)
                self.registry.counter(
                    f"frontend/autoscale_{action}").inc()
                self.registry.gauge("frontend/replicas").set(
                    self.rs.n_replicas)
                self._last_action_t = now
                self._above = self._below = 0
                logger.info("autoscale %s: %d -> %d (load %.3f)",
                            self.rs.name, n, target, load)
            return {"load": round(load, 4), "replicas":
                    self.rs.n_replicas, "action": action,
                    "above": self._above, "below": self._below,
                    "in_cooldown": in_cooldown}

    # -- sampling thread ---------------------------------------------------
    def start(self) -> "ReplicaAutoscaler":
        """Run ``step()`` every ``interval_s`` on a daemon thread;
        idempotent."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=f"{self.rs.name}-autoscaler",
                daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:
                # a scale failure (e.g. device OOM on grow) must not
                # kill the controller — the next sample retries
                logger.exception("autoscaler step failed on %s",
                                 self.rs.name)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ReplicaAutoscaler":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

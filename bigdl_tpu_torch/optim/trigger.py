"""Triggers: cadence and stop conditions of the training loop (port of
``bigdl_tpu/optim/trigger.py``).

A trigger is a predicate over the driver's state dict: ``epoch`` (0-based),
``neval`` (iterations done), ``loss``, ``score`` and ``epoch_finished``
(set at epoch boundaries, so ``every_epoch`` fires once per rollover).  The
K-step driver probes triggers ahead with :func:`probe_fire_step`, so a
block never runs past an iteration where one fires; probed states carry
``probe: True``, and ``loss``/``score`` hold their last real values.
"""

from __future__ import annotations

from typing import Iterable, Optional


class Trigger:
    def __call__(self, state: dict) -> bool:
        raise NotImplementedError

    def and_(self, other: "Trigger") -> "Trigger":
        return _And(self, other)

    def or_(self, other: "Trigger") -> "Trigger":
        return _Or(self, other)


class _And(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, state):
        return self.a(state) and self.b(state)


class _Or(Trigger):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, state):
        return self.a(state) or self.b(state)


class _EveryEpoch(Trigger):
    def __call__(self, state):
        return bool(state.get("epoch_finished", False))


class _SeveralIteration(Trigger):
    def __init__(self, interval: int):
        self.interval = interval

    def __call__(self, state):
        n = state.get("neval", 0)
        return n > 0 and n % self.interval == 0


class _MaxEpoch(Trigger):
    def __init__(self, max_epoch: int):
        self.max_epoch = max_epoch

    def __call__(self, state):
        return state.get("epoch", 0) >= self.max_epoch


class _MaxIteration(Trigger):
    def __init__(self, max_iteration: int):
        self.max_iteration = max_iteration

    def __call__(self, state):
        return state.get("neval", 0) >= self.max_iteration


class _MaxScore(Trigger):
    def __init__(self, max_score: float):
        self.max_score = max_score

    def __call__(self, state):
        s = state.get("score")
        return s is not None and s >= self.max_score


class _MinLoss(Trigger):
    def __init__(self, min_loss: float):
        self.min_loss = min_loss

    def __call__(self, state):
        l = state.get("loss")
        return l is not None and l <= self.min_loss


def every_epoch() -> Trigger:
    return _EveryEpoch()


def several_iteration(interval: int) -> Trigger:
    return _SeveralIteration(interval)


def max_epoch(n: int) -> Trigger:
    return _MaxEpoch(n)


def max_iteration(n: int) -> Trigger:
    return _MaxIteration(n)


def max_score(s: float) -> Trigger:
    return _MaxScore(s)


def min_loss(l: float) -> Trigger:
    return _MinLoss(l)


def probe_fire_step(state: dict, k_max: int, records_per_step: int,
                    epoch_size: int,
                    triggers: Iterable[Trigger]) -> Optional[int]:
    """First step offset j in ``1..k_max`` at which any trigger would
    fire, simulating the driver-state advance from ``state`` — or None
    when a full ``k_max``-step block is trigger-free.

    A block is capped so that a firing iteration is always its LAST step:
    iteration- and epoch-count triggers stay exact at any K.  Loss- and
    score-keyed triggers are probed with their last known values.

    ``records_per_step`` is the batch size (0 = unknown: epoch rollover is
    then left to the records budget of the block's staging)."""
    triggers = [t for t in triggers if t is not None]
    neval = state.get("neval", 0)
    epoch = state.get("epoch", 0)
    records = state.get("records_processed_this_epoch", 0)
    for j in range(1, int(k_max) + 1):
        sim = dict(state)
        sim["probe"] = True
        sim["neval"] = neval + j
        rec = records + j * records_per_step
        finishes_epoch = records_per_step > 0 and rec >= epoch_size
        sim["records_processed_this_epoch"] = 0 if finishes_epoch else rec
        sim["epoch"] = epoch + 1 if finishes_epoch else epoch
        sim["epoch_finished"] = finishes_epoch
        if finishes_epoch or any(t(sim) for t in triggers):
            return j
    return None

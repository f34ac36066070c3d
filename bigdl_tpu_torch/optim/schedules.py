"""Learning-rate schedules (port of ``bigdl_tpu/optim/schedules.py``, the
part ``SGD`` and ``Adam`` need).

Contract: ``schedule(base_lr, iteration, epoch, metric=None) -> lr`` runs on
the host each step; iterations and epochs are 0-based.
"""

from __future__ import annotations

from typing import Optional


class LearningRateSchedule:
    def __call__(self, base_lr: float, iteration: int, epoch: int,
                 metric: Optional[float] = None) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + decay * iteration)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr / (1.0 + self.decay * iteration)

"""Learning-rate schedules (port of ``bigdl_tpu/optim/schedules.py``).

Every schedule of the reference.  Each is host-side arithmetic that
matches the reference step for step; ``Plateau`` is fed the first
validation method's score once per validation by the optimizer.

Contract: ``schedule(base_lr, iteration, epoch, metric=None) -> lr`` runs on
the host each step; iterations and epochs are 0-based.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


class LearningRateSchedule:
    def __call__(self, base_lr: float, iteration: int, epoch: int,
                 metric: Optional[float] = None) -> float:
        raise NotImplementedError

    #: iterations consumed (used by SequentialSchedule)
    def __len__(self):
        return 0


class Default(LearningRateSchedule):
    """lr / (1 + decay * iteration)."""

    def __init__(self, learning_rate_decay: float = 0.0):
        self.decay = learning_rate_decay

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr / (1.0 + self.decay * iteration)


class Step(LearningRateSchedule):
    """lr * gamma^(floor(iter/step_size))."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr * self.gamma ** (iteration // self.step_size)


class MultiStep(LearningRateSchedule):
    """Drop by gamma at each listed iteration; ``epoch_based=True`` reads
    the thresholds as epochs instead."""

    def __init__(self, step_sizes: Sequence[int], gamma: float = 0.1,
                 epoch_based: bool = False):
        self.step_sizes, self.gamma = list(step_sizes), gamma
        self.epoch_based = epoch_based

    def __call__(self, base_lr, iteration, epoch, metric=None):
        at = epoch if self.epoch_based else iteration
        n = sum(1 for s in self.step_sizes if at >= s)
        return base_lr * self.gamma ** n


class EpochStep(LearningRateSchedule):
    """lr * gamma^(floor(epoch/step_size))."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size, self.gamma = step_size, gamma

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr * self.gamma ** (epoch // self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch) with a user fn."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr * 0.1 ** self.decay_fn(epoch)


class Poly(LearningRateSchedule):
    """lr * (1 - iter/max_iter)^power, 0 from max_iter on."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def __call__(self, base_lr, iteration, epoch, metric=None):
        if iteration >= self.max_iteration:
            return 0.0
        return base_lr * (1.0 - iteration / self.max_iteration) ** self.power

    def __len__(self):
        return self.max_iteration


class Exponential(LearningRateSchedule):
    """lr * gamma^(iter/decay_step), optionally staircased."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def __call__(self, base_lr, iteration, epoch, metric=None):
        p = iteration / self.decay_step
        if self.stair_case:
            p = math.floor(p)
        return base_lr * self.decay_rate ** p


class NaturalExp(LearningRateSchedule):
    """lr * exp(-gamma * floor(iter/decay_step))."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step, self.gamma = decay_step, gamma

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr * math.exp(-self.gamma * (iteration // self.decay_step))


class Warmup(LearningRateSchedule):
    """Linear ramp base_lr -> base_lr + delta*warmup_iters over
    warmup_iters."""

    def __init__(self, delta: float, warmup_iteration: int):
        self.delta = delta
        self.warmup_iteration = warmup_iteration

    def __call__(self, base_lr, iteration, epoch, metric=None):
        return base_lr + self.delta * min(iteration, self.warmup_iteration)

    def __len__(self):
        return self.warmup_iteration


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each consuming its ``len()`` iterations (or the
    ``max_iteration`` given to :meth:`add`); the last runs on."""

    def __init__(self, *schedules: LearningRateSchedule):
        self.schedules = list(schedules)

    def add(self, schedule: LearningRateSchedule,
            max_iteration: Optional[int] = None):
        if max_iteration is not None:
            schedule._seq_len = max_iteration  # type: ignore[attr-defined]
        self.schedules.append(schedule)
        return self

    @staticmethod
    def _length(s):
        return getattr(s, "_seq_len", None) or len(s)

    def __call__(self, base_lr, iteration, epoch, metric=None):
        it = iteration
        for s in self.schedules[:-1]:
            n = self._length(s)
            if it < n:
                return s(base_lr, it, epoch, metric)
            it -= n
        return self.schedules[-1](base_lr, it, epoch, metric)


class Plateau(LearningRateSchedule):
    """Drop the lr by ``factor`` when the monitored metric stops improving
    for ``patience`` validations (stateful; :meth:`record` is called by
    the optimizer after each validation)."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.monitor, self.factor, self.patience = monitor, factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self._best: Optional[float] = None
        self._wait = 0
        self._cooldown_left = 0
        self._scale = 1.0

    def record(self, metric: float):
        """Feed the monitored metric."""
        better = (self._best is None
                  or (self.mode == "min" and metric < self._best - self.epsilon)
                  or (self.mode == "max" and metric > self._best + self.epsilon))
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        if better:
            self._best = metric
            self._wait = 0
        elif self._cooldown_left == 0:
            self._wait += 1
            if self._wait >= self.patience:
                self._scale *= self.factor
                self._wait = 0
                self._cooldown_left = self.cooldown

    def __call__(self, base_lr, iteration, epoch, metric=None):
        if metric is not None:
            self.record(metric)
        return max(base_lr * self._scale, self.min_lr)


class EpochSchedule(LearningRateSchedule):
    """Piecewise regimes by epoch range: ``(start_epoch,
    end_epoch_inclusive, lr)`` with 0-based epochs; base_lr outside
    them."""

    def __init__(self, regimes: Sequence[tuple]):
        self.regimes = list(regimes)

    def __call__(self, base_lr, iteration, epoch, metric=None):
        for start, end, lr in self.regimes:
            if start <= epoch <= end:
                return lr
        return base_lr


class EpochDecayWithWarmUp(LearningRateSchedule):
    """Linear warmup for ``warmup_iteration`` steps, then the reached lr
    times 0.1^decay_fn(epoch) (the ImageNet ResNet-50 recipe's
    schedule)."""

    def __init__(self, warmup_iteration: int, warmup_delta: float, decay_fn):
        self.warmup_iteration = warmup_iteration
        self.warmup_delta = warmup_delta
        self.decay_fn = decay_fn

    def __call__(self, base_lr, iteration, epoch, metric=None):
        if iteration < self.warmup_iteration:
            return base_lr + self.warmup_delta * iteration
        max_lr = base_lr + self.warmup_delta * self.warmup_iteration
        return max_lr * 0.1 ** self.decay_fn(epoch)

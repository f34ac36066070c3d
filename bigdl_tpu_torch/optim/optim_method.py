"""Optimization methods (port of ``bigdl_tpu/optim/optim_method.py``:
``OptimMethod``, ``SGD``, ``Adam``).

Parameters, gradients and state are dicts of tensors keyed by parameter
name.  Where the reference's ``update`` is pure and returns new trees,
here it updates the parameters and the state IN PLACE under
``torch.no_grad()``: the training loop owns both, and in-place updates keep
one copy of each on the card.  The arithmetic follows the reference step
for step.  SGD's ``state_dtype`` (bf16 velocity with stochastic rounding)
is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

Tensors = Dict[str, torch.Tensor]


class OptimMethod:
    """Base optimizer: ``init_state(params)`` and ``update(grads, params,
    state, lr, step)``; ``current_lr`` runs on the host."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None,
                 weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.learning_rate_schedule = learning_rate_schedule
        self.weight_decay = weight_decay

    def current_lr(self, iteration: int, epoch: int,
                   metric: Optional[float] = None) -> float:
        if self.learning_rate_schedule is None:
            return self.learning_rate
        return self.learning_rate_schedule(self.learning_rate, iteration,
                                           epoch, metric)

    def init_state(self, params: Tensors) -> dict:
        return {}

    def update(self, grads: Tensors, params: Tensors, state: dict,
               lr: float, step: int) -> None:
        raise NotImplementedError

    def _decayed(self, grads: Tensors, params: Tensors) -> Tensors:
        """L2 weight decay folded into the gradient."""
        if self.weight_decay == 0.0:
            return grads
        wd = self.weight_decay
        return {k: g + wd * params[k] for k, g in grads.items()}


class SGD(OptimMethod):
    """SGD with momentum, dampening and nesterov (Torch semantics:
    ``v = mu*v + (1-dampening)*g``; nesterov steps along ``g + mu*v``)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        if learning_rate_schedule is None and learning_rate_decay != 0.0:
            learning_rate_schedule = Default(learning_rate_decay)
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "nesterov requires momentum > 0 and dampening = 0")

    def init_state(self, params):
        if self.momentum == 0.0:
            return {}
        return {"velocity": {k: torch.zeros_like(p)
                             for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        if self.momentum == 0.0:
            for k, p in params.items():
                p.sub_(lr * grads[k])
            return
        mu, damp = self.momentum, self.dampening
        for k, p in params.items():
            v = state["velocity"][k]
            g = grads[k]
            v.copy_(mu * v + (1 - damp) * g)
            p.sub_(lr * (g + mu * v if self.nesterov else v))


class Adam(OptimMethod):
    """Adam with bias correction."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, weight_decay: float = 0.0,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        if learning_rate_schedule is None and learning_rate_decay != 0.0:
            learning_rate_schedule = Default(learning_rate_decay)
        super().__init__(learning_rate, learning_rate_schedule, weight_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, params, state, lr, step):
        grads = self._decayed(grads, params)
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = step + 1
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for k, p in params.items():
            g, m, v = grads[k], state["m"][k], state["v"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            p.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))

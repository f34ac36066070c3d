"""Criteria (port of ``bigdl_tpu/nn/criterion.py``, the ported part).

``apply(input, target) -> scalar`` is plain tensor code, differentiated by
autograd.  Class targets are 0-based integer tensors.  ``size_average``
(default True) averages over the batch, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch


class Criterion:
    """Base class: ``forward(input, target)`` returns the loss;
    ``backward(input, target)`` returns d loss / d input."""

    size_average: bool = True

    def apply(self, input, target):
        raise NotImplementedError

    def forward(self, input, target):
        self.output = self.apply(input, target)
        return self.output

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(self.apply(x, target), x)
        return self.grad_input

    def _reduce(self, losses):
        """Mean when ``size_average`` (the reference default), else sum."""
        return torch.mean(losses) if self.size_average else torch.sum(losses)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (``logits=True``:
    over raw scores, log-softmax applied first), with optional class
    ``weights`` and an ``ignore_index`` whose targets count nothing.  The
    mean divides by the summed weights of the counted targets."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, logits: bool = False,
                 ignore_index: int = -100):
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.logits = logits
        self.ignore_index = ignore_index

    def apply(self, input, target):
        logp = torch.log_softmax(input, dim=-1) if self.logits else input
        t = target.long()
        valid = t != self.ignore_index
        t_safe = torch.where(valid, t, torch.zeros_like(t))
        picked = torch.gather(logp, -1, t_safe[..., None])[..., 0]
        if self.weights is not None:
            w = self.weights.to(device=logp.device, dtype=picked.dtype)[t_safe]
        else:
            w = torch.ones_like(picked)
        w = torch.where(valid, w, torch.zeros_like(w))
        total = -torch.sum(w * picked)
        if self.size_average:
            return total / torch.clamp(torch.sum(w), min=1e-8)
        return total


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        self._nll = ClassNLLCriterion(weights, size_average, logits=True)
        self.size_average = size_average

    def apply(self, input, target):
        return self._nll.apply(input, target)


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input: the
    per-step losses are summed over T, then divided by T iff
    ``size_average`` (default False).  Folding (N, T) into one batch, a
    batch-averaging inner criterion already yields ``sum_t(loss_t) / T``
    and a summing one ``sum_t(loss_t)``; the rule below undoes or keeps
    that division."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        self.critrn = critrn
        self.size_average = size_average

    def apply(self, input, target):
        T = input.shape[1]
        x = input.reshape((-1,) + tuple(input.shape[2:]))
        t = target.reshape((-1,) + tuple(target.shape[2:]))
        loss = self.critrn.apply(x, t)
        if getattr(self.critrn, "size_average", True):
            return loss if self.size_average else loss * T
        return loss / T if self.size_average else loss


class MSECriterion(Criterion):
    """Squared error, averaged over every element (``size_average``) or
    summed."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce((input - target) ** 2)


class BCECriterion(Criterion):
    """Binary cross entropy on probabilities (reference
    ``BCECriterion.scala``), in f32; the input is clamped to ``[eps, 1 -
    eps]`` with the f32 eps (1 - 1e-12 is 1.0 in f32, and a saturated
    sigmoid would give log(0))."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        eps = torch.finfo(torch.promote_types(input.dtype,
                                              torch.float32)).eps
        x = torch.clamp(input.float(), eps, 1.0 - eps)
        loss = -(target * torch.log(x) + (1.0 - target) * torch.log1p(-x))
        if self.weights is not None:
            loss = loss * self.weights.to(loss.device)
        return self._reduce(loss)


class BCEWithLogitsCriterion(Criterion):
    """Binary cross entropy on logits, in the stable form
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        loss = torch.clamp(input, min=0) - input * target + torch.log1p(
            torch.exp(-input.abs()))
        return self._reduce(loss)

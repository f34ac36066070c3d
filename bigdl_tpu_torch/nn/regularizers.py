"""Per-layer weight regularizers (port of ``bigdl_tpu/nn/regularizers.py``).

BigDL's ``L1L2Regularizer(l1, l2)`` adds ``l1*sign(w) + l2*w`` to a
layer's weight gradient.  As in the reference, the penalty enters the
loss instead, ``l1*|w|_1 + (l2/2)*|w|_2^2``, and autograd yields the same
gradient contribution.  ``Linear`` and ``SpatialConvolution`` take
``w_regularizer``/``b_regularizer``; :func:`regularization_loss` sums every
attached penalty over a model, and both optimizers add it to the
criterion's loss.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Regularizer:
    def penalty(self, w: torch.Tensor):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """``l1*|w|_1 + (l2/2)*|w|_2^2``; its gradient is BigDL's ``l1*sign(w)
    + l2*w``."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = float(l1)
        self.l2 = float(l2)

    def penalty(self, w):
        out = 0.0
        if self.l1:
            out = out + self.l1 * torch.sum(torch.abs(w))
        if self.l2:
            out = out + 0.5 * self.l2 * torch.sum(w * w)
        return out

    def __repr__(self):
        return f"{type(self).__name__}(l1={self.l1}, l2={self.l2})"


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1, l2=0.0)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l1=0.0, l2=l2)


def _regularized(module: torch.nn.Module):
    """(module, its dotted name prefix) of every module carrying a
    regularizer, in the module tree's order (the reference's walk)."""
    for name, m in module.named_modules():
        if getattr(m, "w_regularizer", None) is not None \
                or getattr(m, "b_regularizer", None) is not None:
            yield m, f"{name}." if name else ""


def regularization_loss(module: torch.nn.Module,
                        params: Optional[Dict[str, torch.Tensor]] = None):
    """The sum of every layer's ``w_regularizer``/``b_regularizer``
    penalty over its weight and bias: the module's own tensors, or
    ``params[name]`` (tensors keyed by the module's parameter names) where
    given.  0.0 when no layer carries a regularizer."""
    total = 0.0
    for m, prefix in _regularized(module):
        for attr, reg in (("weight", m.w_regularizer),
                          ("bias", m.b_regularizer)):
            t = getattr(m, attr, None)
            if reg is None or t is None:
                continue
            if params is not None:
                t = params[prefix + attr]
            total = total + reg.penalty(t)
    return total


def has_regularizers(module: torch.nn.Module) -> bool:
    return next(_regularized(module), None) is not None

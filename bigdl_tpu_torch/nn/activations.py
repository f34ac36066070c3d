"""Activation layers (port of ``bigdl_tpu/nn/activations.py``).

The stateless ones are one PyTorch expression each, written as the
reference writes its ``jnp`` one.  ``PReLU`` and ``SReLU`` hold learnable
weights (set to the reference's constants at construction);
``RReLU`` draws its training-mode slopes from ``self.generator``, which
the caller sets as for ``Dropout``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module, Stochastic


class ReLU(Module):
    def forward(self, x):
        return torch.relu(x)


class ReLU6(Module):
    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


class Tanh(Module):
    def forward(self, x):
        return torch.tanh(x)


class Sigmoid(Module):
    def forward(self, x):
        return torch.sigmoid(x)


class SoftMax(Module):
    """softmax over the last axis."""

    def forward(self, x):
        return torch.softmax(x, dim=-1)


class LogSoftMax(Module):
    """log-softmax over the last axis."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)


class SoftPlus(Module):
    def __init__(self, beta: float = 1.0, name=None):
        super().__init__(name)
        self.beta = beta

    def forward(self, x):
        # jax.nn.softplus: logaddexp(x, 0), with no large-input threshold
        return torch.logaddexp(self.beta * x, torch.zeros_like(x)) \
            / self.beta


class SoftSign(Module):
    def forward(self, x):
        return x / (1.0 + torch.abs(x))


class ELU(Module):
    def __init__(self, alpha: float = 1.0, inplace: bool = False, name=None):
        super().__init__(name)
        self.alpha = alpha

    def forward(self, x):
        return torch.where(x > 0, x, self.alpha * torch.expm1(x))


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, name=None):
        super().__init__(name)
        self.negval = negval

    def forward(self, x):
        return torch.where(x >= 0, x, self.negval * x)


class HardTanh(Module):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 name=None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class HardSigmoid(Module):
    def forward(self, x):
        return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


class GELU(Module):
    """The tanh approximation, as the reference's ``jax.nn.gelu``."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


class SiLU(Module):
    def forward(self, x):
        return F.silu(x)


class PReLU(Module):
    """Learnable leaky slope, 0.25 at construction; ``n_output_plane=0``
    means one shared slope, else one per channel (axis 1 of NCHW)."""

    def __init__(self, n_output_plane: int = 0, name=None):
        super().__init__(name)
        self.n_output_plane = n_output_plane
        self.weight = torch.nn.Parameter(
            torch.full((max(n_output_plane, 1),), 0.25), requires_grad=False)

    def forward(self, x):
        w = self.weight
        if self.n_output_plane > 0 and x.dim() == 4:
            w = w[None, :, None, None]
        return torch.where(x >= 0, x, w * x)


class RReLU(Stochastic):
    """Randomized leaky ReLU: slope ~ U(lower, upper) in training, drawn
    from ``self.generator`` (a ``torch.Generator`` on the input's device;
    training without one raises), the mean slope in eval mode."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 name=None):
        super().__init__(name)
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if self.training:
            if self.generator is None:
                raise ValueError("RReLU in training mode needs a generator")
            a = torch.rand(x.shape, generator=self.generator,
                           device=x.device, dtype=x.dtype)
            a = self.lower + (self.upper - self.lower) * a
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)


class SReLU(Module):
    """S-shaped ReLU with four learnable tensors of ``shape`` (thresholds
    0 and 1, slopes 0 and 1 at construction)."""

    def __init__(self, shape: Sequence[int], name=None):
        super().__init__(name)
        self.shape = tuple(shape)
        for k, v in (("t_left", 0.0), ("a_left", 0.0), ("t_right", 1.0),
                     ("a_right", 1.0)):
            setattr(self, k, torch.nn.Parameter(
                torch.full(self.shape, v), requires_grad=False))

    def forward(self, x):
        tl, al, tr, ar = self.t_left, self.a_left, self.t_right, self.a_right
        return torch.where(x >= tr, tr + ar * (x - tr),
                           torch.where(x <= tl, tl + al * (x - tl), x))


class Threshold(Module):
    """x where x > th, else v."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, name=None):
        super().__init__(name)
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class HardShrink(Module):
    """0 inside [-lambda, lambda], identity outside."""

    def __init__(self, the_lambda: float = 0.5, name=None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        return torch.where(torch.abs(x) > self.the_lambda, x,
                           torch.zeros_like(x))


class SoftShrink(Module):
    """Magnitudes shrunk by lambda, 0 inside [-lambda, lambda]."""

    def __init__(self, the_lambda: float = 0.5, name=None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        lam = self.the_lambda
        return torch.where(x > lam, x - lam,
                           torch.where(x < -lam, x + lam,
                                       torch.zeros_like(x)))


class LogSigmoid(Module):
    def forward(self, x):
        return F.logsigmoid(x)


class SoftMin(Module):
    """softmax of -x over the last axis."""

    def forward(self, x):
        return torch.softmax(-x, dim=-1)


class TanhShrink(Module):
    """x - tanh(x)."""

    def forward(self, x):
        return x - torch.tanh(x)

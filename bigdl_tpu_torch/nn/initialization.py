"""Weight initialization methods (port of ``bigdl_tpu/nn/initialization.py``).

Each method is ``init(generator, shape, fan_in, fan_out) -> f32 tensor``,
drawn on the CPU from an explicit ``torch.Generator``.  The numbers differ
from JAX's for the same seed (Philox vs threefry); tests that compare the
two packages carry weights across with ``interop.load_jax_params``.
"""

from __future__ import annotations

import math

import torch


class InitializationMethod:
    def init(self, generator: torch.Generator, shape, fan_in, fan_out):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out):
        return torch.zeros(shape, dtype=torch.float32)


class Ones(InitializationMethod):
    def init(self, generator, shape, fan_in, fan_out):
        return torch.ones(shape, dtype=torch.float32)


class ConstInitMethod(InitializationMethod):
    def __init__(self, value: float):
        self.value = value

    def init(self, generator, shape, fan_in, fan_out):
        return torch.full(shape, self.value, dtype=torch.float32)


class Xavier(InitializationMethod):
    """Glorot uniform: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""

    def init(self, generator, shape, fan_in, fan_out):
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=torch.float32).uniform_(
            -a, a, generator=generator)


class MsraFiller(InitializationMethod):
    """Kaiming/He normal: N(0, sqrt(2/fan)); ``variance_norm_average=False``
    uses fan_in."""

    def __init__(self, variance_norm_average: bool = False):
        self.variance_norm_average = variance_norm_average

    def init(self, generator, shape, fan_in, fan_out):
        fan = (fan_in + fan_out) / 2.0 if self.variance_norm_average \
            else fan_in
        std = math.sqrt(2.0 / fan)
        return std * torch.randn(shape, generator=generator,
                                 dtype=torch.float32)


class RandomUniform(InitializationMethod):
    """U(lower, upper); with no bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (the Torch default of Linear/SpatialConvolution)."""

    def __init__(self, lower: float | None = None, upper: float | None = None):
        self.lower, self.upper = lower, upper

    def init(self, generator, shape, fan_in, fan_out):
        if self.lower is None:
            b = 1.0 / math.sqrt(max(fan_in, 1))
            lo, hi = -b, b
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=torch.float32).uniform_(
            lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    """N(mean, stdv)."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def init(self, generator, shape, fan_in, fan_out):
        return self.mean + self.stdv * torch.randn(
            shape, generator=generator, dtype=torch.float32)


class BilinearFiller(InitializationMethod):
    """Bilinear-upsampling kernel of a full (transposed) convolution,
    broadcast over the leading axes of a (..., kh, kw) weight; draws
    nothing."""

    def init(self, generator, shape, fan_in, fan_out):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        c_w = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ys = torch.arange(kh, dtype=torch.int32)[:, None]
        xs = torch.arange(kw, dtype=torch.int32)[None, :]
        filt = (1 - torch.abs(ys / f_h - c_h)) \
            * (1 - torch.abs(xs / f_w - c_w))
        return filt.to(torch.float32).expand(tuple(shape)).contiguous()

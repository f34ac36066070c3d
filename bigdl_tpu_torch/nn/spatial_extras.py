"""Extended spatial layers (port of ``bigdl_tpu/nn/spatial_extras.py``,
these parts: ``SpatialSeparableConvolution``, ``UpSampling2D``,
``Cropping2D``, ``TemporalMaxPooling``, the layers the Keras wrappers
build).

NCHW (batch, channel, ...) like the reference, apart from
``TemporalMaxPooling``, which pools (N, T, C) over T.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module


def _param(*shape):
    return torch.nn.Parameter(torch.zeros(*shape), requires_grad=False)


class SpatialSeparableConvolution(Module):
    """Depthwise convolution with ``depth_multiplier`` outputs an input
    channel, then a 1x1 pointwise one: ``depth_weight`` (in*mult, 1, kh,
    kw), ``point_weight`` (out, in*mult, 1, 1), ``bias`` (out, zeros)."""

    def __init__(self, n_input_channel: int, n_output_channel: int,
                 depth_multiplier: int, kw: int, kh: int,
                 sw: int = 1, sh: int = 1, pw: int = 0, ph: int = 0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input = n_input_channel
        self.n_output = n_output_channel
        self.mult = depth_multiplier
        self.kernel = (kh, kw)
        self.stride = (sh, sw)
        self.pad = (ph, pw)
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        mid = n_input_channel * depth_multiplier
        self.depth_weight = _param(mid, 1, kh, kw)
        self.point_weight = _param(n_output_channel, mid, 1, 1)
        self.bias = _param(n_output_channel) if with_bias else None

    def reset_parameters(self, generator):
        kh, kw = self.kernel
        mid = self.n_input * self.mult
        self.depth_weight.data.copy_(self.weight_init.init(
            generator, self.depth_weight.shape, kh * kw,
            self.mult * kh * kw))
        self.point_weight.data.copy_(self.weight_init.init(
            generator, self.point_weight.shape, mid, self.n_output))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        y = F.conv2d(x, self.depth_weight, None, self.stride, self.pad,
                     groups=self.n_input)
        y = F.conv2d(y, self.point_weight)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


class UpSampling2D(Module):
    """Nearest-neighbour upsampling of (N, C, H, W) by ``size`` (h, w)."""

    def __init__(self, size: Sequence[int] = (2, 2), name=None):
        super().__init__(name)
        self.size = tuple(size)

    def forward(self, x):
        y = torch.repeat_interleave(x, self.size[0], dim=2)
        return torch.repeat_interleave(y, self.size[1], dim=3)


class Cropping2D(Module):
    """Crop rows and columns off a (N, C, H, W) tensor: ``height_crop``
    (top, bottom), ``width_crop`` (left, right)."""

    def __init__(self, height_crop=(0, 0), width_crop=(0, 0), name=None):
        super().__init__(name)
        self.hc = tuple(height_crop)
        self.wc = tuple(width_crop)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        return x[:, :, self.hc[0]:h - self.hc[1],
                 self.wc[0]:w - self.wc[1]]


class TemporalMaxPooling(Module):
    """1-D max pooling of (N, T, C) over T: windows of ``k_w`` steps every
    ``d_w`` (default ``k_w``)."""

    def __init__(self, k_w: int, d_w: Optional[int] = None, name=None):
        super().__init__(name)
        self.k = k_w
        self.d = d_w or k_w

    def forward(self, x):
        return F.max_pool1d(x.transpose(1, 2), self.k,
                            self.d).transpose(1, 2)

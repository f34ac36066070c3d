"""Volumetric (3-D) layers (port of ``bigdl_tpu/nn/volumetric.py``).

Layout NCDHW (batch, plane, time, height, width); constructor arguments
in the reference's order, kernel, stride and padding given as (T, W, H).
Each layer is one PyTorch op (``F.conv3d``, ``F.max_pool3d``,
``F.avg_pool3d``, ``F.conv_transpose3d``) with the reference's XLA
semantics: pooling windows run over the input padded explicitly (``-inf``
for the max, zeros for the average) and never past it (floor mode), so
any padding works, not only torch's ``pad <= kernel / 2``; the full
convolution computes the uncropped transposed convolution and cuts (or
zero-extends) it to ``(in - 1) * stride - 2 * pad + kernel + adj``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module


def _param(*shape):
    return torch.nn.Parameter(torch.zeros(*shape), requires_grad=False)


def _pads3d(pad, hi=(0, 0, 0)):
    """``F.pad``'s argument for (T, H, W) pads ``pad`` before and ``pad +
    hi`` after each axis (a negative value cuts)."""
    (pt, ph, pw), (at, ah, aw) = pad, hi
    return (pw, pw + aw, ph, ph + ah, pt, pt + at)


class VolumetricConvolution(Module):
    """3-D convolution: ``weight`` (out, in, kT, kH, kW), ``bias`` (out)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = _param(n_output_plane, n_input_plane, *self.kernel)
        self.bias = _param(n_output_plane) if with_bias else None

    def _fans(self):
        kt, kh, kw = self.kernel
        return (self.n_input_plane * kt * kh * kw,
                self.n_output_plane * kt * kh * kw)

    def reset_parameters(self, generator):
        fan_in, fan_out = self._fans()
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, fan_in, fan_out))
        if self.bias is not None:
            self.bias.data.copy_(self.bias_init.init(
                generator, self.bias.shape, fan_in, fan_out))

    def forward(self, x):
        y = F.conv3d(x, self.weight, stride=self.stride, padding=self.pad)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None, None]
        return y


class _VolPool(Module):
    def __init__(self, k_t: int, k_w: int, k_h: int,
                 d_t: Optional[int] = None, d_w: Optional[int] = None,
                 d_h: Optional[int] = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t or k_t, d_h or k_h, d_w or k_w)
        self.pad = (pad_t, pad_h, pad_w)


class VolumetricMaxPooling(_VolPool):
    """3-D max pooling over the ``-inf``-padded input."""

    def forward(self, x):
        if any(self.pad):
            x = F.pad(x, _pads3d(self.pad), value=float("-inf"))
        return F.max_pool3d(x, self.kernel, self.stride)


class VolumetricAveragePooling(_VolPool):
    """3-D average pooling: window sums over the zero-padded input divided
    by the window's size (``count_include_pad``, the default) or by the
    real positions it covers."""

    def __init__(self, *args, count_include_pad: bool = True, **kw):
        super().__init__(*args, **kw)
        self.count_include_pad = count_include_pad

    def _sums(self, x):
        if any(self.pad):
            x = F.pad(x, _pads3d(self.pad))
        return F.avg_pool3d(x, self.kernel, self.stride, divisor_override=1)

    def forward(self, x):
        summed = self._sums(x)
        if self.count_include_pad:
            kt, kh, kw = self.kernel
            return summed / float(kt * kh * kw)
        counts = self._sums(torch.ones_like(x[:1, :1]))
        return summed / torch.clamp(counts, min=1.0)


class VolumetricFullConvolution(Module):
    """Transposed 3-D convolution: ``weight`` (in, out, kT, kH, kW) as the
    reference stores it, ``bias`` (out); output size ``(in - 1) * stride
    - 2 * pad + kernel + adj`` a spatial axis."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 k_t: int, k_w: int, k_h: int,
                 d_t: int = 1, d_w: int = 1, d_h: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.adj = (adj_t, adj_h, adj_w)
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = _param(n_input_plane, n_output_plane, *self.kernel)
        self.bias = _param(n_output_plane) if with_bias else None

    reset_parameters = VolumetricConvolution.reset_parameters
    _fans = VolumetricConvolution._fans

    def forward(self, x):
        full = F.conv_transpose3d(x, self.weight, stride=self.stride)
        # cut ``pad`` off both ends, then extend the far end by ``adj``
        y = F.pad(full, _pads3d(tuple(-p for p in self.pad), self.adj))
        if self.bias is not None:
            y = y + self.bias[None, :, None, None, None]
        return y

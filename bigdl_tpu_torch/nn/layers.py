"""Core parameterized layers (port of ``bigdl_tpu/nn/layers.py``).

Convolution and batch-norm math is left to PyTorch's own operators, as
the reference leaves it to XLA.  Conventions follow the reference: dims
are 0-based with batch at axis 0, weights are OIHW, and activations are
NCHW.  The reference's ``format="NHWC"`` option is not ported yet: it
comes with the training slice (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal, RandomUniform)
from bigdl_tpu_torch.nn.module import Module


class Linear(Module):
    """Affine layer ``y = x W^T + b``; weight (out, in)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = torch.nn.Parameter(
            torch.zeros(output_size, input_size), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(output_size),
                                       requires_grad=False) \
            if with_bias else None

    def reset_parameters(self, generator):
        fan_in, fan_out = self.input_size, self.output_size
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, fan_in, fan_out))
        if self.bias is not None:
            self.bias.data.copy_(self.bias_init.init(
                generator, self.bias.shape, fan_in, fan_out))

    def forward(self, x):
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y


def same_pads(size: int, k: int, s: int, d: int) -> Tuple[int, int]:
    """(lo, hi) padding of XLA's "SAME" for one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def conv_pads(conv, hw) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) padding of a SpatialConvolution (or its
    quantized twin) on an input of spatial size ``hw``; ``pad=-1`` on
    either axis means "SAME"."""
    (ph, pw), (kh, kw) = conv.pad, conv.kernel
    if ph == -1 or pw == -1:
        t, b = same_pads(hw[0], kh, conv.stride[0], conv.dilation[0])
        l, r = same_pads(hw[1], kw, conv.stride[1], conv.dilation[1])
        return t, b, l, r
    return ph, ph, pw, pw


class SpatialConvolution(Module):
    """2-D convolution; weight OIHW (n_output, n_input/group, kh, kw)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 dilation_w: int = 1, dilation_h: int = 1,
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
        self.dilation = (dilation_h, dilation_w)
        self.weight_init = weight_init or RandomUniform()
        self.bias_init = bias_init or RandomUniform()
        self.weight = torch.nn.Parameter(torch.zeros(
            n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(n_output_plane),
                                       requires_grad=False) \
            if with_bias else None

    def reset_parameters(self, generator):
        kh, kw = self.kernel
        fan_in = self.n_input_plane // self.n_group * kh * kw
        fan_out = self.n_output_plane // self.n_group * kh * kw
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, fan_in, fan_out))
        if self.bias is not None:
            self.bias.data.copy_(self.bias_init.init(
                generator, self.bias.shape, fan_in, fan_out))

    def forward(self, x):
        t, b, l, r = conv_pads(self, x.shape[2:])
        if t != b or l != r:
            x = F.pad(x, (l, r, t, b))
            t = l = 0
        y = F.conv2d(x, self.weight, stride=self.stride, padding=(t, l),
                     dilation=self.dilation, groups=self.n_group)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


class _Pool2D(Module):
    def __init__(self, kernel_w: int, kernel_h: int,
                 stride_w: Optional[int] = None,
                 stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, name: Optional[str] = None):
        super().__init__(name)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h or kernel_h, stride_w or kernel_w)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = ceil_mode

    def _extra(self, i, size):
        """Trailing pad beyond ``pad[i]`` implementing Torch/BigDL ceil
        mode: keep the last partial window, but drop a window whose
        start lies beyond input+pad."""
        k, s, p = self.kernel[i], self.stride[i], self.pad[i]
        if self.ceil_mode:
            out = -(-(size + 2 * p - k) // s) + 1
            if (out - 1) * s >= size + p:
                out -= 1
        else:
            out = (size + 2 * p - k) // s + 1
        return max(0, (out - 1) * s + k - size - 2 * p)

    def _padded(self, x, value):
        """``x`` padded by (pad, pad + ceil-mode extra) with ``value``."""
        (ph, pw), (h, w) = self.pad, x.shape[2:]
        pads = (pw, pw + self._extra(1, w), ph, ph + self._extra(0, h))
        return F.pad(x, pads, value=value) if any(pads) else x


class SpatialMaxPooling(_Pool2D):
    """Max pooling; padding is -inf, so it never wins a window."""

    def forward(self, x):
        return F.max_pool2d(self._padded(x, float("-inf")), self.kernel,
                            self.stride)


class SpatialAveragePooling(_Pool2D):
    """Average pooling; ``count_include_pad`` (default True) divides by
    the window size, otherwise by the count of real elements."""

    def __init__(self, *args, count_include_pad: bool = True, **kw):
        super().__init__(*args, **kw)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        summed = F.avg_pool2d(self._padded(x, 0.0), self.kernel,
                              self.stride, divisor_override=1)
        if self.count_include_pad:
            return summed / (self.kernel[0] * self.kernel[1])
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        counts = F.avg_pool2d(self._padded(ones, 0.0), self.kernel,
                              self.stride, divisor_override=1)
        return summed / torch.clamp(counts, min=1.0)


class SpatialBatchNormalization(Module):
    """BatchNorm over the channel axis (axis 1), eval mode: running
    statistics folded into one ``x * scale + shift``, as the reference
    computes it.  Training mode is not ported yet."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(n_output),
                                             requires_grad=False)
            self.bias = torch.nn.Parameter(torch.zeros(n_output),
                                           requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "SpatialBatchNormalization training mode is not ported: it "
                "comes with the ROADMAP training-path slice; call .eval()")
        # 1/sqrt rather than rsqrt: both are correctly rounded on the CPU
        # and the card, so the folded scale is the same on either device
        inv = 1.0 / torch.sqrt(self.running_var + self.eps)
        scale, shift = inv, -self.running_mean * inv
        if self.affine:
            scale = scale * self.weight
            shift = shift * self.weight + self.bias
        shape = [1] * x.dim()
        shape[1] = self.n_output
        return x * scale.to(x.dtype).reshape(shape) \
            + shift.to(x.dtype).reshape(shape)


class Dropout(Module):
    """Inverted dropout: scales kept values by 1/(1-p) in training mode,
    identity in eval mode or at ``p == 0``.  The mask is drawn from
    ``self.generator``, a ``torch.Generator`` on the input's device that
    the caller (``LocalOptimizer`` for its training copy) sets; training
    with ``p > 0`` and no generator raises, as the reference raises
    without an rng."""

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p <= 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout in training mode needs a generator")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class LookupTable(Module):
    """Embedding lookup; weight (n_index, n_output).  Indices are 0-based
    (the Torch original is 1-based); ``padding_value``'s row is zeroed at
    initialization; ``max_norm`` renormalizes rows in the forward."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: Optional[int] = None,
                 max_norm: Optional[float] = None,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.weight_init = weight_init or RandomNormal(0.0, 1.0)
        self.weight = torch.nn.Parameter(torch.zeros(n_index, n_output),
                                         requires_grad=False)

    def reset_parameters(self, generator):
        w = self.weight_init.init(generator, self.weight.shape,
                                  self.n_index, self.n_output)
        if self.padding_value is not None:
            w[self.padding_value] = 0.0
        self.weight.data.copy_(w)

    def forward(self, x):
        w = self.weight
        if self.max_norm is not None:
            norms = torch.linalg.vector_norm(w, dim=1, keepdim=True)
            w = w * torch.clamp(self.max_norm / torch.clamp(norms, min=1e-7),
                                max=1.0)
        return F.embedding(x.long(), w)

"""Core parameterized layers (port of ``bigdl_tpu/nn/layers.py``).

Convolution and batch-norm math is left to PyTorch's own operators, as
the reference leaves it to XLA; the max pool's backward is the port's
first-match kernel (``ops/maxpool.py``).  Conventions follow the
reference: dims are 0-based with batch at axis 0, weights are OIHW in both
formats, and activations are NCHW unless a layer is built with
``format="NHWC"``.  An NHWC layer takes and returns ``(N, H, W, C)``
tensors, as the reference's does; inside, it works on the NCHW-indexed
view ``x.permute(0, 3, 1, 2)``, which is ``channels_last`` in memory and
costs no copy, and its conv weight is kept ``channels_last`` too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomNormal, RandomUniform)
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.maxpool import maxpool2d

FORMATS = ("NCHW", "NHWC")


def _check_format(fmt: str) -> str:
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; use 'NCHW' or 'NHWC'")
    return fmt


def nchw_view(x, fmt: str):
    """The NCHW-indexed view of an activation of format ``fmt`` (for
    NHWC a permutation: ``channels_last`` in memory, no copy)."""
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def from_nchw_view(y, fmt: str):
    """The inverse of :func:`nchw_view`."""
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


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
    """2-D convolution; weight OIHW (n_output, n_input/group, kh, kw) in
    both formats, stored ``channels_last`` for an NHWC layer."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, with_bias: bool = True,
                 dilation_w: int = 1, dilation_h: int = 1,
                 format: str = "NCHW",
                 weight_init: Optional[InitializationMethod] = None,
                 bias_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.format = _check_format(format)
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
        weight = torch.zeros(n_output_plane, n_input_plane // n_group,
                             kernel_h, kernel_w)
        if format == "NHWC":
            weight = weight.contiguous(memory_format=torch.channels_last)
        self.weight = torch.nn.Parameter(weight, requires_grad=False)
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
        x = nchw_view(x, self.format)
        t, b, l, r = conv_pads(self, x.shape[2:])
        if t != b or l != r:
            x = F.pad(x, (l, r, t, b))
            t = l = 0
        y = F.conv2d(x, self.weight, stride=self.stride, padding=(t, l),
                     dilation=self.dilation, groups=self.n_group)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return from_nchw_view(y, self.format)


class _Pool2D(Module):
    def __init__(self, kernel_w: int, kernel_h: int,
                 stride_w: Optional[int] = None,
                 stride_h: Optional[int] = None,
                 pad_w: int = 0, pad_h: int = 0,
                 ceil_mode: bool = False, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h or kernel_h, stride_w or kernel_w)
        self.pad = (pad_h, pad_w)
        self.ceil_mode = ceil_mode
        self.format = _check_format(format)

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

    def _pads(self, hw):
        """((h_lo, h_hi), (w_lo, w_hi)): pad, and pad plus the ceil-mode
        extra, on an input of spatial size ``hw``."""
        return tuple((self.pad[i], self.pad[i] + self._extra(i, hw[i]))
                     for i in (0, 1))

    def _padded(self, x, value):
        """NCHW-indexed ``x`` padded by :meth:`_pads` with ``value``."""
        (h_lo, h_hi), (w_lo, w_hi) = self._pads(x.shape[2:])
        pads = (w_lo, w_hi, h_lo, h_hi)
        return F.pad(x, pads, value=value) if any(pads) else x


class SpatialMaxPooling(_Pool2D):
    """Max pooling; padding is -inf, so it never wins a window.  The
    backward is first-match (``ops/maxpool.py``): the hand-written kernel
    on the card, its plain version on the CPU."""

    def forward(self, x):
        x = nchw_view(x, self.format)
        y = maxpool2d(x, self.kernel, self.stride, self._pads(x.shape[2:]))
        return from_nchw_view(y, self.format)


class SpatialAveragePooling(_Pool2D):
    """Average pooling; ``count_include_pad`` (default True) divides by
    the window size, otherwise by the count of real elements."""

    def __init__(self, *args, count_include_pad: bool = True, **kw):
        super().__init__(*args, **kw)
        self.count_include_pad = count_include_pad

    def forward(self, x):
        x = nchw_view(x, self.format)
        summed = F.avg_pool2d(self._padded(x, 0.0), self.kernel,
                              self.stride, divisor_override=1)
        if self.count_include_pad:
            y = summed / (self.kernel[0] * self.kernel[1])
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            counts = F.avg_pool2d(self._padded(ones, 0.0), self.kernel,
                                  self.stride, divisor_override=1)
            y = summed / torch.clamp(counts, min=1.0)
        return from_nchw_view(y, self.format)


class _Moments(torch.autograd.Function):
    """``(E[x], E[x^2])`` over ``dims``, in f32 from the f32 upcast of
    ``x``.  Only ``x`` is kept for the backward, which recomputes the
    upcast: for a bf16 activation, autograd through ``x.float()`` would
    keep a second, f32 copy of it (the reference rematerializes the cast
    for the same reason)."""

    @staticmethod
    def forward(ctx, x, dims):
        xf = x.float()
        ctx.save_for_backward(x)
        ctx.dims = dims
        return xf.mean(dims), (xf * xf).mean(dims)

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        shape = [1 if d in ctx.dims else s for d, s in enumerate(x.shape)]
        n = x.numel() / g_mean.numel()
        gx = (g_mean / n).reshape(shape) \
            + 2.0 * x.float() * (g_sq / n).reshape(shape)
        return gx.to(x.dtype), None


class SpatialBatchNormalization(Module):
    """BatchNorm over the channel axis (axis 1 for NCHW, the last for
    NHWC), computed as the reference computes it.  Training mode takes
    one-pass statistics in f32 (``E[x^2] - E[x]^2``, clamped at 0) from
    the f32 upcast of the input, normalizes with the biased variance, and
    updates the running statistics (f32 buffers) in place with
    ``running = (1 - momentum) * running + momentum * batch``, the running
    variance unbiased by ``n / (n - 1)``, ``n = N*H*W``.  Both modes end in
    one folded ``x * scale + shift`` in the input's dtype.  ``weight`` and
    ``bias`` are trainable parameters."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 format: str = "NCHW", name: Optional[str] = None):
        super().__init__(name)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.format = _check_format(format)
        if affine:
            self.weight = torch.nn.Parameter(torch.ones(n_output))
            self.bias = torch.nn.Parameter(torch.zeros(n_output))
        self.register_buffer("running_mean", torch.zeros(n_output))
        self.register_buffer("running_var", torch.ones(n_output))

    def _channel_axis(self, ndim: int) -> int:
        return 1 if self.format == "NCHW" else ndim - 1

    def forward(self, x):
        nd = x.dim()
        axis = self._channel_axis(nd)
        if self.training:
            dims = tuple(d for d in range(nd) if d != axis) if nd == 4 \
                else (0,)
            mean, sq = _Moments.apply(x, dims)
            var = torch.clamp(sq - mean * mean, min=0.0)
            n = x.numel() / self.n_output
            with torch.no_grad():
                unbiased = var * n / max(n - 1, 1)
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        # 1/sqrt rather than rsqrt: both are correctly rounded on the CPU
        # and the card, so the folded scale is the same on either device
        inv = 1.0 / torch.sqrt(var + self.eps)
        scale, shift = inv, -mean * inv
        if self.affine:
            scale = scale * self.weight
            shift = shift * self.weight + self.bias
        shape = [1] * nd
        shape[axis] = self.n_output
        return x * scale.to(x.dtype).reshape(shape) \
            + shift.to(x.dtype).reshape(shape)


class BatchNormalization(SpatialBatchNormalization):
    """1-D BatchNorm over ``(N, C)``."""


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


class SpatialCrossMapLRN(Module):
    """Local response normalization across channels:
    ``x / (k + alpha / size * sum of x^2 over a window of size channels)
    ^ beta``, the channel axis 1 (NCHW) or 3 (NHWC).  The window around
    channel c spans ``c - (size - 1) // 2`` to ``c + size // 2``, as the
    reference pads it; ``torch.nn.functional.local_response_norm`` pads
    the other way round, which differs for an even ``size``.  No weights:
    conv-era normalization (AlexNet, Inception v1)."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 k: float = 1.0, format: str = "NCHW",
                 name: Optional[str] = None):
        super().__init__(name)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.format = _check_format(format)

    def forward(self, x):
        axis = 1 if self.format == "NCHW" else 3
        sq = x * x
        lo = (self.size - 1) // 2
        hi = self.size - 1 - lo
        pads = [0, 0] * (x.dim() - 1 - axis) + [lo, hi]
        padded = F.pad(sq, pads)
        c = x.shape[axis]
        acc = padded.narrow(axis, 0, c)
        for i in range(1, self.size):
            acc = acc + padded.narrow(axis, i, c)
        denom = torch.pow(self.k + (self.alpha / self.size) * acc, self.beta)
        return x / denom


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

"""Extended spatial layers (port of ``bigdl_tpu/nn/spatial_extras.py``):
dilated, shared, separable, mapped and locally connected convolutions,
the classic normalizations, spatial dropouts, up-sampling, bilinear
resizing, crops and temporal max pooling.

NCHW (batch, channel, ...) like the reference, apart from the 1-D layers
(``LocallyConnected1D``, ``SpatialDropout1D``, ``UpSampling1D``,
``TemporalMaxPooling``), which take (N, T, C).  The spatial dropouts draw
their masks from ``self.generator`` (a ``torch.Generator`` on the input's
device, which ``LocalOptimizer`` sets for its training copy) and, like
the reference's and Torch's, do not rescale what they keep.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.layers import SpatialConvolution
from bigdl_tpu_torch.nn.module import Module, Stochastic


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


class SpatialDilatedConvolution(SpatialConvolution):
    """A dilated 2-D convolution; the base convolution takes the
    dilation, the class keeps the reference's argument order."""

    def __init__(self, n_input_plane, n_output_plane, kw, kh,
                 dw=1, dh=1, pad_w=0, pad_h=0, dilation_w=1, dilation_h=1,
                 **kwargs):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, dilation_w=dilation_w,
                         dilation_h=dilation_h, **kwargs)


class SpatialShareConvolution(SpatialConvolution):
    """The reference shares im2col buffers across replicas, a JVM memory
    optimization; it computes what ``SpatialConvolution`` computes."""


class SpatialConvolutionMap(Module):
    """Convolution over an explicit table of (input plane, output plane)
    connections, 0-based (LeNet-style partial connectivity): a dense
    ``weight`` (out, in, kh, kw) whose unconnected kernels a constant 0/1
    mask zeroes, at init and in every forward; ``bias`` (out, zeros)."""

    def __init__(self, conn_table, kw: int, kh: int, dw: int = 1,
                 dh: int = 1, pad_w: int = 0, pad_h: int = 0,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        tbl = np.asarray(conn_table, int)
        self.conn_table = tbl
        self.n_input = int(tbl[:, 0].max()) + 1
        self.n_output = int(tbl[:, 1].max()) + 1
        self.kernel = (kh, kw)
        self.stride = (dh, dw)
        self.pad = (pad_h, pad_w)
        self.weight_init = weight_init or RandomUniform()
        mask = np.zeros((self.n_output, self.n_input, 1, 1), np.float32)
        mask[tbl[:, 1], tbl[:, 0]] = 1.0
        self._mask = mask
        self.weight = _param(self.n_output, self.n_input, kh, kw)
        self.bias = _param(self.n_output)

    def _mask_on(self, w):
        return torch.as_tensor(self._mask, device=w.device, dtype=w.dtype)

    def reset_parameters(self, generator):
        kh, kw = self.kernel
        fan_in = self.n_input * kh * kw
        w = self.weight_init.init(generator, self.weight.shape, fan_in,
                                  fan_in)
        self.weight.data.copy_(w * self._mask_on(w))
        self.bias.data.zero_()

    def forward(self, x):
        y = F.conv2d(x, self.weight * self._mask_on(self.weight),
                     stride=self.stride, padding=self.pad)
        return y + self.bias[None, :, None, None]


class LocallyConnected2D(Module):
    """A convolution whose kernels are not shared: one per output
    position.  ``weight`` (oh, ow, out, in*kh*kw), its last axis in
    ``F.unfold``'s (channel, row, column) order; ``bias`` (out, oh, ow)."""

    def __init__(self, n_input_plane: int, input_width: int,
                 input_height: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input = n_input_plane
        self.n_output = n_output_plane
        self.in_hw = (input_height, input_width)
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.pad = (pad_h, pad_w)
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.out_hw = tuple(
            (self.in_hw[i] + 2 * self.pad[i] - self.kernel[i])
            // self.stride[i] + 1 for i in (0, 1))
        oh, ow = self.out_hw
        self.weight = _param(oh, ow, n_output_plane,
                             n_input_plane * kernel_h * kernel_w)
        self.bias = _param(n_output_plane, oh, ow) if with_bias else None

    def reset_parameters(self, generator):
        kh, kw = self.kernel
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.n_input * kh * kw,
            self.n_output))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        oh, ow = self.out_hw
        patches = F.unfold(x, self.kernel, padding=self.pad,
                           stride=self.stride)
        patches = patches.reshape(x.shape[0], -1, oh, ow)
        y = torch.einsum("nkhw,hwok->nohw", patches, self.weight)
        if self.bias is not None:
            y = y + self.bias[None]
        return y


class LocallyConnected1D(Module):
    """A 1-D locally connected layer over (N, T, C): ``weight`` (oT, out,
    kw*C), each window's (step, channel) order; ``bias`` (oT, out)."""

    def __init__(self, n_input_frame: int, input_frame_size: int,
                 output_frame_size: int, kernel_w: int, stride_w: int = 1,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input_frame = n_input_frame
        self.in_size = input_frame_size
        self.out_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.n_output_frame = (n_input_frame - kernel_w) // stride_w + 1
        self.weight = _param(self.n_output_frame, output_frame_size,
                             kernel_w * input_frame_size)
        self.bias = _param(self.n_output_frame, output_frame_size) \
            if with_bias else None

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.in_size * self.kernel_w,
            self.out_size))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        # (N, oT, C, kw) windows, then (N, oT, kw*C) in (step, channel)
        win = x[:, :(self.n_output_frame - 1) * self.stride_w
                + self.kernel_w].unfold(1, self.kernel_w, self.stride_w)
        win = win.transpose(2, 3).reshape(x.shape[0], self.n_output_frame,
                                          -1)
        y = torch.einsum("ntk,tok->nto", win, self.weight)
        if self.bias is not None:
            y = y + self.bias[None]
        return y


class SpatialWithinChannelLRN(Module):
    """Local response normalization over a spatial window within each
    channel: ``x / (1 + alpha / size^2 * window sum of x^2) ^ beta``."""

    def __init__(self, size: int = 5, alpha: float = 1.0,
                 beta: float = 0.75, name: Optional[str] = None):
        super().__init__(name)
        if size % 2 != 1:
            raise ValueError("LRN size must be odd")
        self.size = size
        self.alpha = alpha
        self.beta = beta

    def forward(self, x):
        s = self.size
        # window sums over each channel's zero-padded map
        summed = F.avg_pool2d(x * x, s, 1, s // 2, count_include_pad=True,
                              divisor_override=1)
        return x / (1.0 + (self.alpha / (s * s)) * summed) ** self.beta


def _gaussian_kernel2d(size: int, sigma: float = None):
    if sigma is None:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class SpatialSubtractiveNormalization(Module):
    """Subtract each position's weighted neighbourhood mean over all
    channels (default kernel: a 9x9 gaussian), normalized at the borders
    by the kernel mass the map covers."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.n_input = n_input_plane
        k = _gaussian_kernel2d(9) if kernel is None \
            else np.asarray(kernel, np.float32)
        self._kernel = k / (k.sum() * n_input_plane)

    def _local_mean(self, x):
        kh, kw = self._kernel.shape
        w = torch.as_tensor(self._kernel, device=x.device, dtype=x.dtype)
        w = w[None, None].repeat(1, self.n_input, 1, 1)
        pads = (kh // 2, kw // 2)
        mean = F.conv2d(x, w, padding=pads)
        ones = torch.ones((1, self.n_input) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        return mean / F.conv2d(ones, w, padding=pads)

    def forward(self, x):
        return x - self._local_mean(x)


class SpatialDivisiveNormalization(SpatialSubtractiveNormalization):
    """Divide by the neighbourhood standard deviation, held at least at
    its mean over the map (1 where both are under 1e-8)."""

    def forward(self, x):
        local_std = torch.sqrt(torch.clamp(self._local_mean(x * x),
                                           min=0.0))
        mean_std = local_std.mean(dim=(2, 3), keepdim=True)
        denom = torch.maximum(local_std, mean_std)
        denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)
        return x / denom


class SpatialContrastiveNormalization(Module):
    """Subtractive, then divisive normalization."""

    def __init__(self, n_input_plane: int = 1, kernel=None,
                 name: Optional[str] = None):
        super().__init__(name)
        # stateless parts, kept out of the tree as the reference keeps them
        object.__setattr__(self, "sub", SpatialSubtractiveNormalization(
            n_input_plane, kernel))
        object.__setattr__(self, "div", SpatialDivisiveNormalization(
            n_input_plane, kernel))

    def forward(self, x):
        return self.div(self.sub(x))


class _ChannelDropout(Stochastic):
    """Drops whole feature maps of (N, C, ...) in training mode: a mask of
    shape (N, C, 1, ...), no rescale of what is kept."""

    def __init__(self, init_p: float = 0.5, name: Optional[str] = None):
        super().__init__(name)
        self.p = init_p

    def _mask_shape(self, x):
        return tuple(x.shape[:2]) + (1,) * (x.dim() - 2)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError(f"{self.name} in training mode needs a "
                             f"generator")
        keep = torch.rand(self._mask_shape(x), generator=self.generator,
                          device=x.device) < 1.0 - self.p
        return x * keep.to(x.dtype)


class SpatialDropout1D(_ChannelDropout):
    """Drops channels (the last axis) of (N, T, C)."""

    def _mask_shape(self, x):
        return (x.shape[0], 1, x.shape[2])


class SpatialDropout2D(_ChannelDropout):
    """Drops channels of (N, C, H, W)."""


class SpatialDropout3D(_ChannelDropout):
    """Drops channels of (N, C, D, H, W)."""


class UpSampling1D(Module):
    """Repeat each step of (N, T, C) ``length`` times."""

    def __init__(self, length: int = 2, name=None):
        super().__init__(name)
        self.length = length

    def forward(self, x):
        return torch.repeat_interleave(x, self.length, dim=1)


class UpSampling3D(Module):
    """Nearest-neighbour upsampling of (N, C, D, H, W) by ``size``."""

    def __init__(self, size: Sequence[int] = (2, 2, 2), name=None):
        super().__init__(name)
        self.size = tuple(size)

    def forward(self, x):
        for ax, s in zip((2, 3, 4), self.size):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x


class ResizeBilinear(Module):
    """Bilinear resize of (N, C, H, W) to (out_height, out_width): source
    coordinates ``dst * in / out`` (TF1's, no half-pixel offset), or the
    corners aligned (``align_corners`` with both sizes above 1)."""

    def __init__(self, out_height: int, out_width: int,
                 align_corners: bool = False, name=None):
        super().__init__(name)
        self.out_hw = (out_height, out_width)
        self.align_corners = align_corners

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        oh, ow = self.out_hw
        f32 = dict(dtype=torch.float32, device=x.device)
        if self.align_corners and oh > 1 and ow > 1:
            ys = torch.linspace(0.0, h - 1.0, oh, **f32)
            xs = torch.linspace(0.0, w - 1.0, ow, **f32)
        else:
            ys = torch.arange(oh, **f32) * (h / oh)
            xs = torch.arange(ow, **f32) * (w / ow)
        y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (ys - y0).to(x.dtype)[None, None, :, None]
        wx = (xs - x0).to(x.dtype)[None, None, None, :]
        top, bot = x[:, :, y0], x[:, :, y1]
        top = top[..., x0] * (1 - wx) + top[..., x1] * wx
        bot = bot[..., x0] * (1 - wx) + bot[..., x1] * wx
        return top * (1 - wy) + bot * wy


class Cropping3D(Module):
    """Crop a (N, C, D, H, W) tensor: (before, after) a spatial axis."""

    def __init__(self, dim1_crop=(0, 0), dim2_crop=(0, 0),
                 dim3_crop=(0, 0), name=None):
        super().__init__(name)
        self.crops = (tuple(dim1_crop), tuple(dim2_crop), tuple(dim3_crop))

    def forward(self, x):
        d, h, w = x.shape[2:]
        (d0, d1), (h0, h1), (w0, w1) = self.crops
        return x[:, :, d0:d - d1, h0:h - h1, w0:w - w1]

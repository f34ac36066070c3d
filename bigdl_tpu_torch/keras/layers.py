"""Keras-1.2-named layer wrappers with deferred build and shape inference
(port of ``bigdl_tpu/keras/layers.py``).

A ``KerasLayer`` holds Keras-style hyper-parameters and builds the
underlying ``bigdl_tpu_torch.nn`` module only once the input shape is
known (at ``Sequential.build`` time).  Output shapes are not written per
layer: :func:`infer_output_shape` runs the built module on zeros of a
two-row batch on the CPU, in eval mode and without autograd, which plays
the part of the reference's ``jax.eval_shape`` trace.

Keras 1.2.2 conventions, as in the reference: images are channels-first
(``dim_ordering="th"``, NCHW) unless ``dim_ordering="tf"`` (NHWC), and
``input_shape`` excludes the batch dimension.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.maxpool import maxpool2d

_ACTIVATIONS = {
    "relu": nn.ReLU, "tanh": nn.Tanh, "sigmoid": nn.Sigmoid,
    "softmax": nn.SoftMax, "log_softmax": nn.LogSoftMax,
    "softplus": nn.SoftPlus, "softsign": nn.SoftSign, "linear": None,
    "hard_sigmoid": nn.HardSigmoid, "gelu": nn.GELU, "silu": nn.SiLU,
    "elu": nn.ELU,
}


def activation_module(name: Optional[str]) -> Optional[Module]:
    if name is None or name == "linear":
        return None
    try:
        cls = _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None
    return cls() if cls is not None else None


def infer_output_shape(module: torch.nn.Module,
                       input_shape: Tuple[int, ...],
                       batch: int = 2) -> Tuple[int, ...]:
    """Output shape (without the batch) of ``module`` on ``(batch,
    *input_shape)`` f32 zeros, run in eval mode under ``torch.no_grad()``
    on the device of its parameters (the CPU for a module without
    any)."""
    p = next(module.parameters(), None)
    device = p.device if p is not None else torch.device("cpu")
    x = torch.zeros((batch,) + tuple(input_shape), device=device)
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            out = module(x)
    finally:
        module.train(was_training)
    return tuple(out.shape[1:])


class KerasLayer:
    """Deferred layer: Keras hyper-parameters now, core module at build
    time."""

    def __init__(self, input_shape: Optional[Sequence[int]] = None,
                 name: Optional[str] = None):
        self.input_shape = None if input_shape is None else tuple(input_shape)
        self.name = name or type(self).__name__

    def build(self, input_shape: Tuple[int, ...]) -> Module:
        """The core module for inputs of ``input_shape`` (no batch)."""
        raise NotImplementedError(type(self).__name__)

    def output_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return infer_output_shape(self.build(input_shape), input_shape)


class InputLayer(KerasLayer):
    def __init__(self, input_shape: Sequence[int], name=None):
        super().__init__(input_shape=input_shape, name=name)

    def build(self, input_shape):
        return nn.Identity()


class _WithActivation(KerasLayer):
    """A core module with an optional trailing activation."""

    def _maybe_activate(self, core: Module) -> Module:
        act = activation_module(getattr(self, "activation", None))
        if act is None:
            return core
        return nn.Sequential(core, act)


class Dense(_WithActivation):
    """Keras ``Dense``: ``nn.Linear``."""

    def __init__(self, output_dim: int, activation: Optional[str] = None,
                 bias: bool = True, input_shape=None, input_dim=None,
                 name=None):
        if input_dim is not None:
            input_shape = (input_dim,)
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = output_dim
        self.activation = activation
        self.bias = bias

    def build(self, input_shape):
        return self._maybe_activate(
            nn.Linear(int(input_shape[-1]), self.output_dim,
                      with_bias=self.bias))


class Activation(KerasLayer):
    def __init__(self, activation: str, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.activation = activation

    def build(self, input_shape):
        return activation_module(self.activation) or nn.Identity()


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.p = p

    def build(self, input_shape):
        return nn.Dropout(self.p)


class Flatten(KerasLayer):
    def build(self, input_shape):
        return nn.Flatten()


class Reshape(KerasLayer):
    def __init__(self, target_shape: Sequence[int], input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.target_shape = tuple(target_shape)

    def build(self, input_shape):
        return nn.Reshape(self.target_shape)


class Convolution2D(_WithActivation):
    """Keras ``Convolution2D``: ``nn.SpatialConvolution``; ``border_mode=
    "same"`` is the core conv's SAME padding (``pad=-1``)."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", bias: bool = True,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.border_mode = border_mode
        self.subsample = subsample
        self.dim_ordering = dim_ordering
        self.bias = bias

    def build(self, input_shape):
        ch_axis = 0 if self.dim_ordering == "th" else -1
        in_ch = int(input_shape[ch_axis])
        pad = -1 if self.border_mode == "same" else 0
        return self._maybe_activate(nn.SpatialConvolution(
            in_ch, self.nb_filter, self.nb_col, self.nb_row,
            stride_w=self.subsample[1], stride_h=self.subsample[0],
            pad_w=pad, pad_h=pad, with_bias=self.bias,
            format="NCHW" if self.dim_ordering == "th" else "NHWC"))


class Convolution1D(_WithActivation):
    def __init__(self, nb_filter: int, filter_length: int,
                 activation: Optional[str] = None, subsample_length: int = 1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.activation = activation
        self.subsample_length = subsample_length

    def build(self, input_shape):
        return self._maybe_activate(nn.TemporalConvolution(
            int(input_shape[-1]), self.nb_filter, self.filter_length,
            stride_w=self.subsample_length))


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/Keras SAME padding of one axis: ceil(size/s) outputs, the odd
    cell at the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class _SamePool2D(Module):
    """Keras/TF ``border_mode="same"`` pooling: ceil(in/stride) outputs,
    asymmetric padding, padded cells excluded (max: ``-inf``, through the
    first-match pool of ``ops/maxpool.py``; average: divided by the count
    of real cells)."""

    def __init__(self, is_max: bool, pool_size, strides, fmt: str):
        super().__init__()
        self.is_max = is_max
        self.kernel = tuple(pool_size)
        self.stride = tuple(strides)
        self.format = fmt

    def forward(self, x):
        v = x.permute(0, 3, 1, 2) if self.format == "NHWC" else x
        pads = tuple(_same_pads(v.shape[2 + i], self.kernel[i],
                                self.stride[i]) for i in (0, 1))
        if self.is_max:
            y = maxpool2d(v, self.kernel, self.stride, pads)
        else:
            (h0, h1), (w0, w1) = pads
            total = F.avg_pool2d(F.pad(v, (w0, w1, h0, h1)), self.kernel,
                                 self.stride, divisor_override=1)
            ones = torch.ones((1, 1) + tuple(v.shape[2:]), dtype=v.dtype,
                              device=v.device)
            count = F.avg_pool2d(F.pad(ones, (w0, w1, h0, h1)),
                                 self.kernel, self.stride,
                                 divisor_override=1)
            y = total / count
        return y.permute(0, 2, 3, 1) if self.format == "NHWC" else y


class _Pooling2D(KerasLayer):
    core_cls: Any = None

    def __init__(self, pool_size: Tuple[int, int] = (2, 2),
                 strides: Optional[Tuple[int, int]] = None,
                 border_mode: str = "valid", dim_ordering: str = "th",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_size = pool_size
        self.strides = strides or pool_size
        self.border_mode = border_mode
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        fmt = "NCHW" if self.dim_ordering == "th" else "NHWC"
        if self.border_mode == "same":
            return _SamePool2D(self.core_cls is nn.SpatialMaxPooling,
                               self.pool_size, self.strides, fmt)
        return self.core_cls(
            self.pool_size[1], self.pool_size[0],
            self.strides[1], self.strides[0], 0, 0, format=fmt)


class MaxPooling2D(_Pooling2D):
    core_cls = nn.SpatialMaxPooling


class AveragePooling2D(_Pooling2D):
    core_cls = nn.SpatialAveragePooling


class GlobalAveragePooling2D(KerasLayer):
    def __init__(self, dim_ordering: str = "th", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return nn.Lambda(lambda x: torch.mean(x, dim=axes))


class GlobalMaxPooling2D(GlobalAveragePooling2D):
    def build(self, input_shape):
        axes = (2, 3) if self.dim_ordering == "th" else (1, 2)
        return nn.Lambda(lambda x: torch.amax(x, dim=axes))


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = padding
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        ph, pw = self.padding
        # F.pad lists the last axis first
        pads = (pw, pw, ph, ph) if self.dim_ordering == "th" \
            else (0, 0, pw, pw, ph, ph)
        return nn.Lambda(lambda x: F.pad(x, pads))


class BatchNormalization(KerasLayer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 dim_ordering: str = "th", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.epsilon = epsilon
        self.momentum = momentum
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        if len(input_shape) == 3:  # image: per-channel BN
            n = input_shape[0 if self.dim_ordering == "th" else -1]
            return nn.SpatialBatchNormalization(
                int(n), eps=self.epsilon, momentum=1.0 - self.momentum,
                format="NCHW" if self.dim_ordering == "th" else "NHWC")
        return nn.BatchNormalization(int(input_shape[-1]), eps=self.epsilon,
                                     momentum=1.0 - self.momentum)


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int, input_shape=None,
                 input_length=None, name=None):
        if input_length is not None:
            input_shape = (input_length,)
        super().__init__(input_shape=input_shape, name=name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def build(self, input_shape):
        return nn.LookupTable(self.input_dim, self.output_dim)


def _last_step(x):
    return x[:, -1]


class _Recurrent(KerasLayer):
    cell_cls: Any = None

    def __init__(self, output_dim: int, return_sequences: bool = False,
                 go_backwards: bool = False, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = output_dim
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards

    def build(self, input_shape):
        cell = self.cell_cls(int(input_shape[-1]), self.output_dim)
        rec = nn.Recurrent(cell, reverse=self.go_backwards)
        if self.return_sequences:
            return rec
        return nn.Sequential(rec, nn.Lambda(_last_step))


class SimpleRNN(_Recurrent):
    cell_cls = nn.RnnCell


class LSTM(_Recurrent):
    cell_cls = nn.LSTM


class GRU(_Recurrent):
    cell_cls = nn.GRU


class Bidirectional(KerasLayer):
    def __init__(self, layer: _Recurrent, merge_mode: str = "concat",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape or layer.input_shape,
                         name=name)
        self.layer = layer
        self.merge_mode = merge_mode

    def build(self, input_shape):
        fwd = self.layer.cell_cls(int(input_shape[-1]),
                                  self.layer.output_dim)
        bwd = self.layer.cell_cls(int(input_shape[-1]),
                                  self.layer.output_dim)
        rec = nn.BiRecurrent(fwd, bwd, merge=self.merge_mode)
        if self.layer.return_sequences:
            return rec
        return nn.Sequential(rec, nn.Lambda(_last_step))


class TimeDistributed(KerasLayer):
    def __init__(self, layer: KerasLayer, input_shape=None, name=None):
        super().__init__(input_shape=input_shape or layer.input_shape,
                         name=name)
        self.layer = layer

    def build(self, input_shape):
        inner = self.layer.build(tuple(input_shape[1:]))
        return nn.TimeDistributed(inner)


class RepeatVector(KerasLayer):
    """(N, D) -> (N, n, D)."""

    def __init__(self, n: int, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.n = n

    def build(self, input_shape):
        n = self.n
        return nn.Lambda(lambda x: torch.repeat_interleave(x[:, None], n,
                                                           dim=1))


class Permute(KerasLayer):
    """Permute the non-batch dims, 1-based as in Keras."""

    def __init__(self, dims, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.dims = tuple(dims)

    def build(self, input_shape):
        perm = (0,) + tuple(d for d in self.dims)
        return nn.Lambda(lambda x: x.permute(perm))


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering="th",
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.cropping = cropping
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        (t, b), (left, r) = self.cropping
        if self.dim_ordering == "th":
            return nn.Cropping2D((t, b), (left, r))
        return nn.Lambda(lambda x: x[:, t:x.shape[1] - b,
                                     left:x.shape[2] - r, :])


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), dim_ordering="th", input_shape=None,
                 name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.size = tuple(size)
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        if self.dim_ordering != "th":
            sh, sw = self.size
            return nn.Lambda(lambda x: torch.repeat_interleave(
                torch.repeat_interleave(x, sh, dim=1), sw, dim=2))
        return nn.UpSampling2D(self.size)


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.padding = padding

    def build(self, input_shape):
        p = self.padding
        return nn.Lambda(lambda x: F.pad(x, (0, 0, p, p)))


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride=None,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.pool_length = pool_length
        self.stride = stride or pool_length

    def build(self, input_shape):
        return nn.TemporalMaxPooling(self.pool_length, self.stride)


class GlobalMaxPooling1D(KerasLayer):
    def build(self, input_shape):
        return nn.Lambda(lambda x: torch.amax(x, dim=1))


class GlobalAveragePooling1D(KerasLayer):
    def build(self, input_shape):
        return nn.Lambda(lambda x: torch.mean(x, dim=1))


class Highway(KerasLayer):
    def __init__(self, activation=None, input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.activation = activation

    def build(self, input_shape):
        # nn.Highway takes the g function itself (the bound forward, so
        # that the activation is no child module with a key of its own)
        act = activation_module(self.activation)
        return nn.Highway(int(input_shape[-1]),
                          activation=None if act is None else act.forward)


class MaxoutDense(KerasLayer):
    def __init__(self, output_dim: int, nb_feature: int = 4,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.output_dim = output_dim
        self.nb_feature = nb_feature

    def build(self, input_shape):
        return nn.Maxout(int(input_shape[-1]), self.output_dim,
                         self.nb_feature)


class SeparableConvolution2D(_WithActivation):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation=None, depth_multiplier: int = 1,
                 dim_ordering="th", input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.activation = activation
        self.depth_multiplier = depth_multiplier
        self.dim_ordering = dim_ordering

    def build(self, input_shape):
        if self.dim_ordering != "th":
            raise NotImplementedError(
                "SeparableConvolution2D supports dim_ordering='th' only "
                "(the core module is NCHW); transpose inputs or use "
                "nn.SpatialSeparableConvolution directly")
        ch = int(input_shape[0])
        return self._maybe_activate(nn.SpatialSeparableConvolution(
            ch, self.nb_filter, self.depth_multiplier,
            self.nb_col, self.nb_row))


class Merge(KerasLayer):
    """Merge a list of inputs.  Use its ``.build(...)`` module on a table
    of tensors or in an ``nn.Graph``, NOT inside a Keras ``Sequential``
    (its layers are single-tensor; shape inference raises there)."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 input_shape=None, name=None):
        super().__init__(input_shape=input_shape, name=name)
        self.mode = mode
        self.concat_axis = concat_axis

    def output_shape(self, input_shape):
        raise TypeError(
            "Merge cannot appear in a Keras Sequential (single-tensor "
            "pipeline); apply its .build(...) module to a table of "
            "tensors or use nn.Graph")

    def build(self, input_shape):
        if self.mode == "sum":
            return nn.CAddTable()
        if self.mode == "mul":
            return nn.CMulTable()
        if self.mode == "max":
            return nn.CMaxTable()
        if self.mode == "concat":
            return nn.JoinTable(self.concat_axis)
        if self.mode == "ave":
            return nn.CAveTable()
        raise ValueError(f"unknown merge mode {self.mode!r}")

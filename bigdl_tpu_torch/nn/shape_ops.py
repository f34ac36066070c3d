"""Tensor-manipulation and table layers (port of
``bigdl_tpu/nn/shape_ops.py``).

Dims are 0-based with the batch at axis 0, as in the reference.  A table
is a tuple (or list) of tensors.  Where the reference's gradient at a tie
differs from PyTorch's usual operator, the layer is written so that it
takes the reference's: ``Max``/``Min`` reduce with ``amax``/``amin``
(tied extremes share the gradient evenly, ``torch.max(x, dim)`` gives it
to one of them), and ``Clamp`` is ``minimum(maximum(x, lo), hi)`` on
tensor bounds (half the gradient at a bound, where ``torch.clamp`` passes
all of it and ``F.hardtanh`` none); ``Abs`` is :func:`right_abs`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


def right_abs(x):
    """``|x|`` whose gradient at 0 is 1, the reference's (``torch.abs``
    gives 0 there)."""
    return torch.where(x >= 0, x, -x)


class Reshape(Module):
    """Reshape keeping the batch axis (``batch_mode=True``), or to
    ``size`` as a whole."""

    def __init__(self, size: Sequence[int], batch_mode: bool = True,
                 name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.size)
        return x.reshape(self.size)


class View(Reshape):
    """Alias of :class:`Reshape` (-1 infers one size)."""


class Flatten(Module):
    """Flatten every axis but the batch's."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Squeeze(Module):
    """Drop axis ``dim`` (of size 1), or every axis of size 1 (None)."""

    def __init__(self, dim: Optional[int] = None, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        if self.dim is None:
            return x.squeeze()
        if x.shape[self.dim] != 1:
            raise ValueError(f"cannot squeeze axis {self.dim} of size "
                             f"{x.shape[self.dim]}")
        return x.squeeze(self.dim)


class Unsqueeze(Module):
    def __init__(self, pos: int, name=None):
        super().__init__(name)
        self.pos = pos

    def forward(self, x):
        return x.unsqueeze(self.pos)


class Transpose(Module):
    """Swap each listed pair of axes, in order."""

    def __init__(self, permutations: Sequence[tuple], name=None):
        super().__init__(name)
        self.permutations = list(permutations)

    def forward(self, x):
        for a, b in self.permutations:
            x = x.transpose(a, b)
        return x


class Contiguous(Module):
    """Values unchanged, in a contiguous layout."""

    def forward(self, x):
        return x.contiguous()


class Narrow(Module):
    """``length`` elements from ``offset`` (0-based) along ``dim``; a
    negative ``length`` counts from the end (-1 keeps the rest)."""

    def __init__(self, dim: int, offset: int, length: int, name=None):
        super().__init__(name)
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        n = self.length if self.length >= 0 \
            else x.shape[self.dim] - self.offset + self.length + 1
        return x.narrow(self.dim, self.offset, n)


class Select(Module):
    """Element ``index`` along ``dim``, the axis dropped."""

    def __init__(self, dim: int, index: int, name=None):
        super().__init__(name)
        self.dim, self.index = dim, index

    def forward(self, x):
        return x.select(self.dim, self.index)


def wrap_negative(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` with each id in [-n, 0) moved up by n, numpy-style."""
    return torch.where(idx < 0, idx + n, idx)


class Index(Module):
    """Gather along ``dim`` by an index tensor: input ``(x, indices)``;
    the indices' shape replaces axis ``dim``.  An index in [-n, 0) counts
    from the end, as ``jnp.take`` reads it; one at or above n raises."""

    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, xs):
        x, idx = xs
        dim = self.dim % x.dim()
        idx = wrap_negative(torch.as_tensor(idx, device=x.device).long(),
                            x.shape[dim])
        out = x.index_select(dim, idx.reshape(-1))
        return out.reshape(x.shape[:dim] + idx.shape + x.shape[dim + 1:])


class Padding(Module):
    """``abs(pad)`` entries of ``value`` on one side of ``dim``: after the
    end for ``pad > 0``, before the start for ``pad < 0``."""

    def __init__(self, dim: int, pad: int, value: float = 0.0, name=None):
        super().__init__(name)
        self.dim, self.pad, self.value = dim, pad, value

    def forward(self, x):
        pads = [0, 0] * (x.dim() - 1 - self.dim % x.dim())
        pads += [-self.pad, 0] if self.pad < 0 else [0, self.pad]
        return F.pad(x, pads, value=self.value)


class SpatialZeroPadding(Module):
    """Zeros around H and W of an NCHW input."""

    def __init__(self, pad_left: int, pad_right: int, pad_top: int,
                 pad_bottom: int, name=None):
        super().__init__(name)
        self.cfg = (pad_left, pad_right, pad_top, pad_bottom)

    def forward(self, x):
        return F.pad(x, self.cfg)


class JoinTable(Module):
    """Concatenate a table along ``dimension``."""

    def __init__(self, dimension: int, n_input_dims: int = -1, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, xs):
        return torch.cat(list(xs), self.dimension)


class SplitTable(Module):
    """Split along ``dimension`` into a table, the axis dropped."""

    def __init__(self, dimension: int, name=None):
        super().__init__(name)
        self.dimension = dimension

    def forward(self, x):
        return tuple(torch.unbind(x, self.dimension))


class CAddTable(Module):
    """Elementwise sum of a table (the ResNet shortcut join)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class CMulTable(Module):
    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out


class CSubTable(Module):
    def forward(self, xs):
        return xs[0] - xs[1]


class CDivTable(Module):
    def forward(self, xs):
        return xs[0] / xs[1]


class CMaxTable(Module):
    """Elementwise maximum of a table (ties share the gradient)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out


class CMinTable(Module):
    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out


class FlattenTable(Module):
    """A nested table as one flat tuple, depth first."""

    def forward(self, xs):
        flat = []

        def rec(t):
            if isinstance(t, (tuple, list)):
                for e in t:
                    rec(e)
            else:
                flat.append(t)

        rec(xs)
        return tuple(flat)


class SelectTable(Module):
    def __init__(self, index: int, name=None):
        super().__init__(name)
        self.index = index

    def forward(self, xs):
        return xs[self.index]


class MulConstant(Module):
    def __init__(self, scalar: float, name=None):
        super().__init__(name)
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar


class AddConstant(Module):
    def __init__(self, constant_scalar: float, name=None):
        super().__init__(name)
        self.constant_scalar = constant_scalar

    def forward(self, x):
        return x + self.constant_scalar


class Power(Module):
    """``(shift + scale * x) ^ power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0,
                 name=None):
        super().__init__(name)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return torch.pow(self.shift + self.scale * x, self.power)


class Sqrt(Module):
    def forward(self, x):
        return torch.sqrt(x)


class Square(Module):
    def forward(self, x):
        return x * x


class Abs(Module):
    def forward(self, x):
        return right_abs(x)


class Exp(Module):
    def forward(self, x):
        return torch.exp(x)


class Log(Module):
    def forward(self, x):
        return torch.log(x)


class Clamp(Module):
    """``x`` limited to ``[min_v, max_v]``; at a bound the gradient is
    halved, as the reference's ``clip`` gives it."""

    def __init__(self, min_v: float, max_v: float, name=None):
        super().__init__(name)
        self.min_v, self.max_v = min_v, max_v

    def forward(self, x):
        lo = torch.tensor(self.min_v, dtype=x.dtype, device=x.device)
        hi = torch.tensor(self.max_v, dtype=x.dtype, device=x.device)
        return torch.minimum(torch.maximum(x, lo), hi)


class Mean(Module):
    """Mean over ``dimension``, the axis dropped unless ``squeeze=False``."""

    def __init__(self, dimension: int = 0, squeeze: bool = True, name=None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.mean(self.dimension, keepdim=not self.squeeze)


class Sum(Module):
    def __init__(self, dimension: int = 0, squeeze: bool = True, name=None):
        super().__init__(name)
        self.dimension, self.squeeze = dimension, squeeze

    def forward(self, x):
        return x.sum(self.dimension, keepdim=not self.squeeze)


class Max(Module):
    """Largest value along ``dim``; tied maxima share the gradient."""

    def __init__(self, dim: int = 0, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.amax(self.dim)


class Min(Module):
    """Smallest value along ``dim``; tied minima share the gradient."""

    def __init__(self, dim: int = 0, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.amin(self.dim)


class Replicate(Module):
    """A new axis ``dim`` of ``n_features`` copies."""

    def __init__(self, n_features: int, dim: int = 0, name=None):
        super().__init__(name)
        self.n_features, self.dim = n_features, dim

    def forward(self, x):
        out = x.unsqueeze(self.dim)
        reps = [1] * out.dim()
        reps[self.dim] = self.n_features
        return out.repeat(reps)


class Pack(Module):
    """Stack a table along a new axis ``dim``."""

    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, xs):
        return torch.stack(list(xs), self.dim)


class Scale(Module):
    """``CMul`` then ``CAdd`` of one shape (children ``mul`` and
    ``add``, the reference's parameter tree)."""

    def __init__(self, size: Sequence[int], name=None):
        super().__init__(name)
        from bigdl_tpu_torch.nn.layers import CAdd, CMul
        self.mul = CMul(size)
        self.add = CAdd(size)

    def forward(self, x):
        return self.add(self.mul(x))


class Masking(Module):
    """Zero the time steps (last-axis rows) whose every entry equals
    ``mask_value``."""

    def __init__(self, mask_value: float = 0.0, name=None):
        super().__init__(name)
        self.mask_value = mask_value

    def forward(self, x):
        keep = (x != self.mask_value).any(-1, keepdim=True)
        return torch.where(keep, x, torch.zeros_like(x))

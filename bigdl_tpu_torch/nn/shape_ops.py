"""Shape and table layers (port of ``bigdl_tpu/nn/shape_ops.py``, this
slice's part)."""

from __future__ import annotations

from typing import Sequence

from bigdl_tpu_torch.nn.module import Module


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


class CAddTable(Module):
    """Elementwise sum of a table (the ResNet shortcut join)."""

    def forward(self, xs):
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out

"""Table and gating layers (port of ``bigdl_tpu/nn/tensor_extras.py``,
these parts: ``Maxout``, ``Highway``, ``CAveTable``, the layers the Keras
wrappers build).  Tables are Python tuples or lists.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module


def _param(*shape):
    return torch.nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Maxout(Module):
    """A Linear layer of ``pool`` pieces an output, then the max over the
    pieces: weight (pool*out, in), its rows grouped (pool, out); bias
    (pool*out, zeros)."""

    def __init__(self, input_size: int, output_size: int, pool: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.pool = pool
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.weight = _param(pool * output_size, input_size)
        self.bias = _param(pool * output_size) if with_bias else None

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.input_size,
            self.output_size))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        y = y.reshape(y.shape[0], self.pool, self.output_size)
        return torch.amax(y, dim=1)  # ties share the gradient, as jnp.max


class Highway(Module):
    """Highway block ``t * g(x W^T + b) + (1 - t) * x`` with the gate
    ``t = sigmoid(x Wg^T + bg)``; ``g`` is ``activation`` (tanh by
    default).  Biases start at zero."""

    def __init__(self, size: int, with_bias: bool = True, activation=None,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.size = size
        self.with_bias = with_bias
        self.activation = activation or torch.tanh
        self.weight_init = weight_init or RandomUniform()
        self.gate_weight = _param(size, size)
        self.weight = _param(size, size)
        self.gate_bias = _param(size) if with_bias else None
        self.bias = _param(size) if with_bias else None

    def reset_parameters(self, generator):
        for w in (self.gate_weight, self.weight):
            w.data.copy_(self.weight_init.init(generator, w.shape,
                                               self.size, self.size))
        if self.with_bias:
            self.gate_bias.data.zero_()
            self.bias.data.zero_()

    def forward(self, x):
        t = x @ self.gate_weight.T
        h = x @ self.weight.T
        if self.with_bias:
            t = t + self.gate_bias
            h = h + self.bias
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1 - t) * x


class CAveTable(Module):
    """Elementwise average of a table's entries."""

    def forward(self, x):
        return sum(x) / len(x)

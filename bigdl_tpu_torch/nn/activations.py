"""Activation layers (port of ``bigdl_tpu/nn/activations.py``, this slice's
part)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    def forward(self, x):
        return torch.relu(x)


class LogSoftMax(Module):
    """log-softmax over the last axis."""

    def forward(self, x):
        return torch.log_softmax(x, dim=-1)

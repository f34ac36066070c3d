"""Mixed precision (port of ``bigdl_tpu/utils/precision.py``: the compute
dtype of training).

Parameters, optimizer state and the update stay f32; the forward and the
backward compute in the compute dtype (bf16 for the tensor cores); the
criterion's math is f32.  bf16 keeps f32's exponent range, so no loss
scaling is needed.  The reference's ``stochastic_round`` (and SGD's bf16
``state_dtype`` that uses it) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import functional_call


def cast_floating(tree, dtype: torch.dtype):
    """Cast only the floating tensors of a tensor, or of a dict, list or
    tuple of them, to ``dtype``; others pass through.  A
    :class:`~bigdl_tpu_torch.nn.sparse.COOBatch` is walked as the
    reference's pytree registration walks it: its ``values`` are cast, its
    ``row``, ``col`` and ``dense_shape`` kept.  The cast is
    differentiable: the gradient of a downcast comes back in the original
    dtype."""
    # imported here: nn/ imports utils/, so a module-level import cycles
    from bigdl_tpu_torch.nn.sparse import COOBatch
    if isinstance(tree, COOBatch):
        return dataclasses.replace(
            tree, values=cast_floating(tree.values, dtype))
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def mixed_precision_loss_fn(model: torch.nn.Module, criterion,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> Callable:
    """``loss_fn(params, x, y)``: the forward of ``model`` with its
    parameters ``params`` (f32 master copies, by name) and the input cast
    to ``compute_dtype``, its output cast back to f32 for the criterion.
    ``loss_fn(...).backward()`` leaves f32 gradients on ``params``.
    Buffers (BatchNorm's running statistics) are the module's own and
    stay f32."""

    def loss_fn(params, x, y):
        out = functional_call(model, cast_floating(params, compute_dtype),
                              (cast_floating(x, compute_dtype),))
        return criterion.apply(cast_floating(out, torch.float32), y)

    return loss_fn

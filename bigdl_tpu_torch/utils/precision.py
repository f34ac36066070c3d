"""Mixed precision (port of ``bigdl_tpu/utils/precision.py``: the compute
dtype of training and the unbiased downcast).

Parameters, optimizer state and the update stay f32; the forward and the
backward compute in the compute dtype (bf16 for the tensor cores); the
criterion's math is f32.  bf16 keeps f32's exponent range, so no loss
scaling is needed.

:func:`stochastic_round` is the shared unbiased downcast of the gradient
wire (``parallel/grad_sync.py``).  Its arithmetic is
:func:`stochastic_round_bits`, which takes the noise as an argument, so
the same 32-bit noise words give the reference's bits exactly; the
wrapper draws them from an explicit ``torch.Generator`` (PyTorch's Philox
stream cannot reproduce JAX's threefry words).  SGD's bf16 ``state_dtype``
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import functional_call


def stochastic_round_bits(x: torch.Tensor, dtype: torch.dtype,
                          noise: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to ``dtype``; f32 to bf16 unbiased: the low 16 bits of
    ``noise`` (an int32 or uint32 tensor of ``x``'s shape, uniform words)
    are added to ``x``'s bits, then the low 16 bits are cut (bf16 is the
    top half of f32).  Its expectation is ``x``; plain round-to-nearest
    would drop every update under half a bf16 ulp.  Any other pair of
    dtypes rounds to nearest (f16's ulp is 64x finer than bf16's); the
    same dtype returns ``x`` itself."""
    if x.dtype == dtype:
        return x
    if dtype != torch.bfloat16 or x.dtype != torch.float32:
        return x.to(dtype)
    if noise.dtype == torch.uint32:
        noise = noise.view(torch.int32)
    # int32 adds wrap as the reference's uint32 adds do; -65536 is
    # 0xFFFF0000
    bits = (x.view(torch.int32) + (noise & 0xFFFF)) & -65536
    return bits.view(torch.float32).to(torch.bfloat16)


def stochastic_round(x: torch.Tensor, dtype: torch.dtype,
                     generator: torch.Generator) -> torch.Tensor:
    """:func:`stochastic_round_bits` with noise drawn from ``generator``
    (on ``x``'s device); no draw when the round is not f32 to bf16."""
    if x.dtype != torch.float32 or dtype != torch.bfloat16:
        return x if x.dtype == dtype else x.to(dtype)
    noise = torch.randint(0, 1 << 16, x.shape, dtype=torch.int32,
                          device=x.device, generator=generator)
    return stochastic_round_bits(x, dtype, noise)


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

"""COO embedding-bag / segment-sum (port of ``bigdl_tpu/ops/pallas_embed.py``).

:func:`embedding_bag_coo` computes ``out[r] += values[k] * table[cols[k]]``
for every non-zero ``k`` with ``rows[k] == r``, over an unsorted COO stream,
accumulating in f32 and returning the promoted dtype of ``(table,
values)``.  Unsorted rows, duplicate ``(row, col)`` pairs, padding entries
``(0, 0, 0.0)`` and empty rows (an exact 0) all come out as in the
reference.  It is differentiable: the table's gradient ``d_table[c] +=
values[k] * g[rows[k]]`` is the same kernel with the roles of rows and cols
swapped; the values' gradient ``sum_d g[rows[k]] * table[cols[k]]`` is plain
PyTorch, as the reference leaves it to XLA; rows and cols get none.  Each
cotangent is cast to its primal's dtype.

Order and rounding: each row adds its entries in nnz order, one
single-rounding FMA ``acc = fma(v, t, acc)`` each, into an f32 accumulator
that starts at 0.  That is what the reference's Pallas kernel does under the
interpreter on the CPU (XLA contracts its ``acc + v * t``), so the kernel,
the plain version and the reference agree bitwise.  The kernel gets the
order from a stable sort of ``rows`` and CSR row offsets built from it
(:func:`row_index`: index bookkeeping on library calls, no float math).

The device of the tensor picks the version.  A CUDA tensor launches the
hand-written Hopper kernel (``csrc/embed_bag.cu``, :func:`launch`) or
raises; a CPU tensor runs the plain version
:func:`embedding_bag_coo_reference`.  There is no ``impl`` knob, no
``supported()`` gate and no fallback: the kernel takes any D (ragged
included), f32 and bf16 tables and values, and 64-bit offsets where
``V * D`` or ``n_rows * D`` reaches 2^31.  The reference's 128-lane and
VMEM-budget limits are TPU facts and are not copied.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.int8_gemm import fma_f32

#: kernel launches since the last reset (a plain int; reset by assigning 0)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None  # the C entry point, see _kernel_fn


def row_index(rows: torch.Tensor, n_rows: int):
    """``(perm, offsets)``: a stable sort of ``rows`` (entries of one row
    keep their nnz order) and the CSR bounds of row r in it,
    ``offsets[r] .. offsets[r + 1]`` (int64, ``n_rows + 1``).  Entries whose
    row lies outside ``[0, n_rows)`` fall outside every bound.  Library
    calls with no host sync (``searchsorted``, not ``bincount``, whose CUDA
    version reads the largest row back to the host)."""
    sorted_rows, perm = torch.sort(rows, stable=True)
    bounds = torch.arange(n_rows + 1, device=rows.device, dtype=rows.dtype)
    return perm, torch.searchsorted(sorted_rows, bounds)


def embedding_bag_coo_reference(rows, cols, values, table, n_rows: int):
    """Plain version of the kernel: the same terms in the same order with
    the same single rounding (:func:`~bigdl_tpu_torch.ops.int8_gemm.fma_f32`),
    vectorised over the rows and looping over the slot j of each row's
    segment."""
    out_dtype = torch.result_type(table, values)
    perm, offsets = row_index(rows, n_rows)
    counts = offsets[1:] - offsets[:-1]
    vals = values.float()[perm]
    idx = cols.long()[perm]
    acc = torch.zeros((n_rows, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    active = torch.nonzero(counts > 0).flatten()
    j = 0
    while active.numel():
        k = offsets[active] + j
        acc[active] = fma_f32(vals[k][:, None], table[idx[k]].float(),
                              acc[active])
        j += 1
        active = active[counts[active] > j]
    return acc.to(out_dtype)


def _kernel_fn():
    """The kernel's C entry point with its ctypes signature, resolved on
    first use (that builds the libraries) and kept."""
    global _fn
    if _fn is None:
        fn = _build.load("embed_bag").bigdl_embed_bag
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        _fn = fn
    return _fn


def launch(rows, cols, values, table, n_rows: int):
    """Launch the kernel (what :func:`embedding_bag_coo_reference` takes
    and returns).  Raises on anything the kernel does not take: tensors off
    CUDA or on different cards, rows or cols not int32, values or table not
    f32/bf16, a table that is not a contiguous (V, D), streams of unequal
    length or not contiguous."""
    global launches
    dev = table.device
    if dev.type != "cuda":
        raise RuntimeError(f"the embedding-bag kernel runs on CUDA, not {dev}")
    for name, t in (("rows", rows), ("cols", cols), ("values", values)):
        if t.device != dev:
            raise RuntimeError(f"{name} is on {t.device}, the table on {dev}")
        if t.dim() != 1 or t.shape != rows.shape or not t.is_contiguous():
            raise ValueError(f"rows, cols and values must be contiguous 1-D "
                             f"streams of one length; {name} is "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"rows and cols must be int32, got {rows.dtype} and "
                        f"{cols.dtype}")
    if values.dtype not in _DTYPE_CODE or table.dtype not in _DTYPE_CODE:
        raise TypeError(f"values and table must be f32 or bf16, got "
                        f"{values.dtype} and {table.dtype}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"the table must be a contiguous (V, D), got "
                         f"{tuple(table.shape)} strides {table.stride()}")
    n_rows = int(n_rows)
    V, D = table.shape
    out = torch.empty((n_rows, D), dtype=torch.result_type(table, values),
                      device=dev)
    if out.numel() == 0:
        return out
    perm, offsets = row_index(rows, n_rows)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODE[table.dtype], _DTYPE_CODE[values.dtype],
                 offsets.data_ptr(), perm.data_ptr(), cols.data_ptr(),
                 values.data_ptr(), table.data_ptr(), out.data_ptr(), n_rows,
                 V, D, stream)
    if err != 0:
        raise RuntimeError(f"embedding-bag kernel launch failed: cudaError "
                           f"{err} (nnz {rows.numel()}, n_rows {n_rows}, "
                           f"table {tuple(table.shape)} {table.dtype})")
    launches += 1
    return out


def embed_bag(rows, cols, values, table, n_rows: int):
    """The bag sum, not differentiable: the kernel for a CUDA table, the
    plain version for a CPU one."""
    if table.device.type == "cuda":
        return launch(rows, cols, values, table, n_rows)
    if table.device.type == "cpu":
        return embedding_bag_coo_reference(rows, cols, values, table, n_rows)
    raise RuntimeError(f"the embedding bag has no version for {table.device}")


class _EmbeddingBagCOO(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cols, values, table, n_rows):
        ctx.save_for_backward(rows, cols, values, table)
        return embed_bag(rows, cols, values, table, n_rows)

    @staticmethod
    def backward(ctx, g):
        rows, cols, values, table = ctx.saved_tensors
        gf = g.float().contiguous()
        d_values = d_table = None
        if ctx.needs_input_grad[2]:
            d_values = (gf[rows.long()] * table[cols.long()].float()).sum(1) \
                .to(values.dtype)
        if ctx.needs_input_grad[3]:
            # B3 with the roles of rows and cols swapped: every row of the
            # dense (V, D) gradient is written, zeros included
            d_table = embed_bag(cols, rows, values, gf, table.shape[0]) \
                .to(table.dtype)
        return None, None, d_values, d_table, None


def embedding_bag_coo(rows, cols, values, table, n_rows: int):
    """Differentiable COO embedding-bag, the twin of the reference's
    ``embedding_bag_coo``: ``rows``, ``cols`` (nnz,) integer, ``values``
    (nnz,) f32/bf16, ``table`` (V, D) f32/bf16; returns ``(n_rows, D)`` in
    ``result_type(table, values)``."""
    return _EmbeddingBagCOO.apply(rows.to(torch.int32).contiguous(),
                                  cols.to(torch.int32).contiguous(),
                                  values.contiguous(), table.contiguous(),
                                  int(n_rows))

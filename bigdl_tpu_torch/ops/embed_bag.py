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
order from a stable sort of ``rows`` and CSR row offsets built from it:
on the card from three hand-written passes of a two-digit counting sort
over the known row range (:func:`group_index`, sized by
:func:`group_plan`; no library kernel, no host read-back), in the plain
version from library calls (:func:`row_index`).  Both give the same
``offsets`` and the same ``perm`` over every row's bounds; they differ only
in how they order the entries whose row lies outside ``[0, n_rows)``,
which no bound covers (:func:`group_index`).

The device of the tensor picks the version.  A CUDA tensor launches the
hand-written Hopper kernel (``csrc/embed_bag.cu``, :func:`launch`) or
raises; a CPU tensor runs the plain version
:func:`embedding_bag_coo_reference`.  There is no ``impl`` knob, no
``supported()`` gate and no fallback: the kernel takes any D (ragged
included), f32, bf16 and f16 tables and values, and 64-bit offsets where
``V * D`` or ``n_rows * D`` reaches 2^31.  The reference's 128-lane and
VMEM-budget limits are TPU facts and are not copied.

``launches`` counts calls of the kernel, one a :func:`launch` whatever
the number of passes it launches (never plain-version calls), so a run can
show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.int8_gemm import fma_f32

#: kernel calls since the last reset (a plain int; reset by assigning 0)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns = {}  # the C entry points, see _kernel_fn

# the grouping passes' sizes, as csrc/embed_bag.cu has them
TILE = 1024          # entries a block of passes 1 and 2 takes at a time
MAX_CHUNKS = 128     # a chunk grows by whole tiles beyond this many
COARSE_BITS = 8      # at most 256 coarse buckets
MAX_KEYS = 2 ** 31   # every int32 key >= 0 lies below it


class GroupPlan(NamedTuple):
    """The sizes of :func:`group_index` for ``nnz`` keys in ``[0,
    n_keys)`` (:func:`group_plan`)."""
    shift: int            # fine bits: coarse bucket = domain key >> shift
    buckets: int          # coarse buckets
    chunk: int            # entries a block of passes 1 and 2 (whole tiles)
    chunks: int           # blocks of passes 1 and 2
    index_dtype: torch.dtype  # of perm and offsets: int32 below 2^31 entries
    scratch_bytes: int    # passes 1-3's scratch, one buffer


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def group_plan(nnz: int, n_keys: int) -> GroupPlan:
    """Sizes of the grouping passes, from the shapes alone.  Keys map to
    the domain ``[0, n_keys + 2)`` (below 0 -> 0, k -> k + 1, n_keys and
    above -> n_keys + 1); its top ``COARSE_BITS`` bits are the coarse
    digit, the rest the fine one.  The scratch holds, each region on a
    256-byte boundary: the chunks x buckets histogram, the bucket starts
    (buckets + 1) and the coarse-ordered entries (a domain key and a
    stream index each, in the index dtype's width)."""
    if nnz < 0 or not 1 <= n_keys <= MAX_KEYS:
        raise ValueError(f"the grouping takes nnz >= 0 and 1 <= n_keys <= "
                         f"2^31, got nnz {nnz}, n_keys {n_keys}")
    bits = (n_keys + 1).bit_length()  # of the largest domain key, n_keys + 1
    shift = max(0, bits - COARSE_BITS)
    buckets = ((n_keys + 1) >> shift) + 1
    chunk = TILE * max(1, -(-nnz // (TILE * MAX_CHUNKS)))
    chunks = max(1, -(-nnz // chunk))
    wide = nnz >= 2 ** 31
    es = 8 if wide else 4
    scratch = sum(_align256(n) for n in (chunks * buckets * es,
                                         (buckets + 1) * es, nnz * 2 * es))
    return GroupPlan(shift, buckets, chunk, chunks,
                     torch.int64 if wide else torch.int32, scratch)


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


_ARGTYPES = {
    # wide, keys, nnz, n_keys, shift, buckets, chunk, chunks, scratch,
    # scratch_bytes, perm, offsets, stream
    "bigdl_embed_bag_group": (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
        + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3),
    # table dtype, values dtype, wide, offsets, perm, cols, values, table,
    # out, n_rows, n_table, D, stream
    "bigdl_embed_bag": ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
                        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]),
}


def _kernel_fn(name: str):
    """A C entry point with its ctypes signature, resolved on first use
    (that builds the libraries) and kept."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("embed_bag"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _fns[name] = fn
    return fn


def group_index(keys: torch.Tensor, n_keys: int):
    """The hand-written passes 1-3 of ``csrc/embed_bag.cu`` on the card:
    ``(perm, offsets)`` in ``group_plan(...).index_dtype`` (int32 below 2^31
    entries).  ``offsets`` equals :func:`row_index`'s, and so does ``perm``
    over ``[offsets[0], offsets[n_keys])``, the span the bag walk reads.
    Keys below 0 fill ``perm``'s head and keys at or above ``n_keys`` its
    tail, each side in nnz order (``row_index`` orders them by key).  ``keys``
    is a contiguous int32 CUDA stream.  Allocates with ``torch.empty``
    only: no library kernel, no host sync.  Not counted in ``launches``
    (:func:`launch` counts its calls)."""
    dev = keys.device
    if dev.type != "cuda":
        raise RuntimeError(f"the grouping passes run on CUDA, not {dev}")
    if keys.dtype != torch.int32 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise TypeError(f"keys must be a contiguous 1-D int32 stream, got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    nnz, n_keys = keys.numel(), int(n_keys)
    plan = group_plan(nnz, n_keys)
    perm = torch.empty(nnz, dtype=plan.index_dtype, device=dev)
    offsets = torch.empty(n_keys + 1, dtype=plan.index_dtype, device=dev)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn("bigdl_embed_bag_group")(
            int(plan.index_dtype == torch.int64), keys.data_ptr(), nnz,
            n_keys, plan.shift, plan.buckets, plan.chunk, plan.chunks,
            scratch.data_ptr(), plan.scratch_bytes, perm.data_ptr(),
            offsets.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"embedding-bag grouping launch failed: cudaError "
                           f"{err} (nnz {nnz}, n_keys {n_keys}, {plan})")
    return perm, offsets


def launch(rows, cols, values, table, n_rows: int):
    """Launch the kernel: the grouping passes, then the bag walk (what
    :func:`embedding_bag_coo_reference` takes and returns).  Raises on
    anything the kernel does not take: tensors off CUDA or on different
    cards, rows or cols not int32, values or table not f32/bf16/f16, a table
    that is not a contiguous (V, D), streams of unequal length or not
    contiguous."""
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
        raise TypeError(f"kernel B3 (the embedding bag) has no form for "
                        f"{values.dtype} values and a {table.dtype} table: "
                        f"values and table must be f32, bf16 or f16")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"the table must be a contiguous (V, D), got "
                         f"{tuple(table.shape)} strides {table.stride()}")
    n_rows = int(n_rows)
    V, D = table.shape
    out = torch.empty((n_rows, D), dtype=torch.result_type(table, values),
                      device=dev)
    if out.numel() == 0:
        return out
    perm, offsets = group_index(rows, n_rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel_fn("bigdl_embed_bag")(
            _DTYPE_CODE[table.dtype], _DTYPE_CODE[values.dtype],
            int(perm.dtype == torch.int64), offsets.data_ptr(),
            perm.data_ptr(), cols.data_ptr(), values.data_ptr(),
            table.data_ptr(), out.data_ptr(), n_rows, V, D, stream)
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
    (nnz,) f32/bf16/f16, ``table`` (V, D) f32/bf16/f16; returns
    ``(n_rows, D)`` in ``result_type(table, values)``."""
    return _EmbeddingBagCOO.apply(rows.to(torch.int32).contiguous(),
                                  cols.to(torch.int32).contiguous(),
                                  values.contiguous(), table.contiguous(),
                                  int(n_rows))

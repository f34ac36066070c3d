"""Sparse layers for recommender workloads (port of ``bigdl_tpu/nn/sparse.py``).

Two sparse representations, as in the reference:

1. **Fixed-width id bags**: ids ``(N, B)`` with ``-1`` padding, optionally
   with per-id weights ``(N, B)``; a sparse feature vector becomes a
   weighted embedding-bag sum (one gather and a batched reduction).
2. **Batch COO** (:class:`COOBatch`): the whole batch's non-zeros as one
   flat ``row``/``col``/``values`` stream of a fixed length (host batching
   pads it to an nnz bucket with ``(0, 0, 0.0)`` entries,
   ``dataset/sample.py`` ``batch_sparse_samples``).  Rows may come in any
   order.  Every COO product goes through kernel B3
   (:func:`~bigdl_tpu_torch.ops.embed_bag.embedding_bag_coo`): on a CUDA
   tensor the hand-written Hopper kernel, on a CPU tensor its plain
   version.

Both forms feed :class:`SparseLinear` and :class:`LookupTableSparse`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.initialization import RandomNormal, RandomUniform
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.embed_bag import embedding_bag_coo


@dataclass(frozen=True)
class COOBatch:
    """A batch-COO sparse matrix of shape ``dense_shape`` = (N, D):
    ``values[k]`` sits at (``row[k]``, ``col[k]``).  Padding entries carry
    ``row = col = 0, value = 0`` and contribute nothing.  ``dense_shape`` is
    static metadata; ``row``, ``col`` and ``values`` are tensors (int32,
    int32, float) and may carry leading axes when batches are stacked."""

    row: torch.Tensor
    col: torch.Tensor
    values: torch.Tensor
    dense_shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.dense_shape[0]

    def to(self, device, non_blocking: bool = False) -> "COOBatch":
        return COOBatch(*(t.to(device, non_blocking=non_blocking)
                          for t in (self.row, self.col, self.values)),
                        self.dense_shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_((self.row.long(), self.col.long()),
                              self.values, accumulate=True)


def coo_spmm(coo: COOBatch, dense: torch.Tensor) -> torch.Tensor:
    """Sparse x dense product ``(N, D) @ (D, O) -> (N, O)``: the fused
    gather, scale and segment sum of kernel B3."""
    return embedding_bag_coo(coo.row, coo.col, coo.values, dense,
                             coo.n_rows)


def coo_row_reduce(coo: COOBatch, values: torch.Tensor) -> torch.Tensor:
    """Per-row sum of ``values`` (one scalar per non-zero): B3 over a
    one-entry table of 1, so the sum is taken in nnz order, deterministic
    on the card, with no float atomics."""
    ones = torch.ones((1, 1), dtype=torch.float32, device=values.device)
    return embedding_bag_coo(coo.row, torch.zeros_like(coo.col), values,
                             ones, coo.n_rows)[:, 0]


def dense_to_bags(dense: np.ndarray, bag_size: Optional[int] = None):
    """A dense batch (N, D) with few non-zeros as ``(ids, weights)``
    fixed-width bags (a host-side helper; reference ``DenseToSparse``)."""
    N, D = dense.shape
    nnz = (dense != 0)
    width = bag_size or int(nnz.sum(axis=1).max())
    ids = np.full((N, width), -1, np.int32)
    weights = np.zeros((N, width), np.float32)
    for n in range(N):
        idx = np.nonzero(nnz[n])[0][:width]
        ids[n, :len(idx)] = idx
        weights[n, :len(idx)] = dense[n, idx]
    return ids, weights


class DenseToSparse(Module):
    """Dense input (N, D) to ``(ids, weights)`` bags of a fixed
    ``bag_size``: the ``bag_size`` largest-|value| entries, ties to the
    lower index (``lax.top_k``'s order), the rest padded with id ``-1`` and
    weight 0."""

    def __init__(self, bag_size: int, name: Optional[str] = None):
        super().__init__(name)
        self.bag_size = bag_size

    def forward(self, x):
        mag, idx = torch.sort(x.abs(), dim=-1, descending=True, stable=True)
        mag, idx = mag[..., :self.bag_size], idx[..., :self.bag_size]
        weights = torch.gather(x, -1, idx)
        keep = mag > 0
        ids = torch.where(keep, idx, torch.full_like(idx, -1)).to(torch.int32)
        return ids, torch.where(keep, weights, torch.zeros_like(weights))


def _bag_combine(weight, ids, weights, combiner: str):
    """The id-bag path of :class:`LookupTableSparse`: a weighted sum of
    the bag's rows of ``weight``, then the combiner's division."""
    ids = ids.long()
    mask = ids >= 0
    emb = weight[torch.where(mask, ids, torch.zeros_like(ids))]  # (N, B, O)
    w = mask.to(emb.dtype)
    if weights is not None:
        w = w * weights.to(emb.dtype)
    summed = torch.einsum("nbo,nb->no", emb, w)
    if combiner == "sum":
        return summed
    if combiner == "sqrtn":
        denom = torch.clamp(torch.sqrt(torch.sum(w * w, dim=1, keepdim=True)),
                            min=1e-12)
    else:  # mean: the raw weight sum (reference LookupTableSparse.scala:123)
        denom = torch.sum(w, dim=1, keepdim=True)
        denom = torch.where(denom.abs() < 1e-12,
                            torch.full_like(denom, 1e-12), denom)
    return summed / denom


class LookupTableSparse(Module):
    """Embedding bag with a combiner, ``sum``, ``mean`` or ``sqrtn``, over
    each sample's ids with optional per-id weights.  Input: ids (N, B) with
    ``-1`` padding, an ``(ids, weights)`` pair, or a :class:`COOBatch`
    (rows = samples, cols = ids, values = weights).  Output:
    (N, n_output).  Weight (n_index, n_output), N(0, 0.05) by default."""

    def __init__(self, n_index: int, n_output: int, combiner: str = "sum",
                 weight_init=None, name: Optional[str] = None):
        super().__init__(name)
        assert combiner in ("sum", "mean", "sqrtn")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner
        self.weight_init = weight_init or RandomNormal(0.0, 0.05)
        self.weight = torch.nn.Parameter(torch.zeros(n_index, n_output),
                                         requires_grad=False)

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.n_index, self.n_output))

    def _coo(self, coo: COOBatch):
        summed = coo_spmm(coo, self.weight)
        if self.combiner == "sum":
            return summed
        w = coo.values
        if self.combiner == "mean":
            # reference LookupTableSparse.scala:123-133 sums the RAW
            # weights, so negative weights stay signed; only exact zeros
            # are guarded
            denom = coo_row_reduce(coo, w)
            denom = torch.where(denom.abs() < 1e-12,
                                torch.full_like(denom, 1e-12), denom)
        else:  # sqrtn
            denom = torch.clamp(torch.sqrt(coo_row_reduce(coo, w * w)),
                                min=1e-12)
        return summed / denom[:, None]

    def forward(self, x):
        if isinstance(x, COOBatch):
            return self._coo(x)
        ids, weights = x if isinstance(x, (tuple, list)) else (x, None)
        return _bag_combine(self.weight, ids, weights, self.combiner)


class SparseLinear(Module):
    """Affine layer on sparse rows of width ``input_size``: ``(ids,
    values)`` bags or a :class:`COOBatch`, computed as a weighted bag sum
    over the weight's rows plus the bias.  The weight is stored
    (input_size, output_size), the transpose of a dense Linear's, as in
    the reference; weight and bias are U(-1/sqrt(input_size),
    1/sqrt(input_size))."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight = torch.nn.Parameter(
            torch.zeros(input_size, output_size), requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(output_size),
                                       requires_grad=False) \
            if with_bias else None

    def reset_parameters(self, generator):
        fan_in, fan_out = self.input_size, self.output_size
        self.weight.data.copy_(RandomUniform().init(
            generator, self.weight.shape, fan_in, fan_out))
        if self.bias is not None:
            self.bias.data.copy_(RandomUniform().init(
                generator, self.bias.shape, fan_in, fan_out))

    def forward(self, x):
        if isinstance(x, COOBatch):
            y = coo_spmm(x, self.weight)
        else:
            ids, weights = x
            y = _bag_combine(self.weight, ids, weights, "sum")
        if self.bias is not None:
            y = y + self.bias
        return y


class SparseJoinTable(Module):
    """Concatenate sparse features along dim 1: a sequence of ``(ids,
    weights)`` bags or of :class:`COOBatch` es, each one's ids offset by
    the sizes of those before it (``sizes`` given at construction).  The
    joined COO stream keeps its parts one after another, so its rows are
    not sorted."""

    def __init__(self, sizes, name: Optional[str] = None):
        super().__init__(name)
        self.sizes = list(sizes)

    def forward(self, x):
        if all(isinstance(t, COOBatch) for t in x):
            n = x[0].n_rows
            if any(coo.n_rows != n for coo in x):
                raise ValueError(
                    "SparseJoinTable inputs disagree on batch size: "
                    f"{[coo.n_rows for coo in x]}")
            cols, offset = [], 0
            for coo, size in zip(x, self.sizes):
                cols.append(coo.col + offset)
                offset += size
            return COOBatch(torch.cat([coo.row for coo in x]),
                            torch.cat(cols),
                            torch.cat([coo.values for coo in x]),
                            (n, offset))
        ids_out, offset = [], 0
        for (ids, _), size in zip(x, self.sizes):
            ids_out.append(torch.where(ids >= 0, ids + offset,
                                       torch.full_like(ids, -1)))
            offset += size
        return (torch.cat(ids_out, dim=1),
                torch.cat([w for _, w in x], dim=1))

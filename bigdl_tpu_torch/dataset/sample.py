"""Sample and MiniBatch (port of ``bigdl_tpu/dataset/sample.py``).
Host-side data is numpy; the training driver stages it on the device.
Sparse samples batch into one batch-COO :class:`SparseMiniBatch` whose
``COOBatch`` holds CPU tensors.  Samples of different lengths batch under
a :class:`PaddingParam`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


class Sample:
    """One training example: a feature array and an optional label."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    @staticmethod
    def from_ndarray(feature, label=None) -> "Sample":
        """A sample of numpy arrays (``np.asarray`` of each)."""
        return Sample(np.asarray(feature),
                      None if label is None else np.asarray(label))

    def feature_size(self):
        return np.shape(self.feature)

    def label_size(self):
        return None if self.label is None else np.shape(self.label)

    def __repr__(self):
        ls = None if self.label is None else np.shape(self.label)
        return f"Sample(feature={np.shape(self.feature)}, label={ls})"


class MiniBatch:
    """Batched input/target arrays with a leading batch axis."""

    __slots__ = ("input", "target")

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        leaf = self.input
        while isinstance(leaf, (tuple, list, dict)):
            leaf = next(iter(leaf.values())) if isinstance(leaf, dict) \
                else leaf[0]
        return leaf.shape[0]

    def slice(self, offset: int, length: int) -> "MiniBatch":
        """The sub-batch ``[offset, offset + length)`` of every array
        (nested tuples, lists and dicts are cut leaf by leaf)."""

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(cut(e) for e in x)
            return x[offset:offset + length]

        return MiniBatch(cut(self.input),
                         None if self.target is None else cut(self.target))

    def __repr__(self):
        return f"MiniBatch(size={self.size()})"


@dataclass
class PaddingParam:
    """How samples of different lengths (axis 0) batch: each is padded
    with ``padding_value`` to the batch's longest, or to ``fixed_length``;
    with ``buckets`` (and no ``fixed_length``) to the smallest listed
    length that holds the longest, so that a run's batches take at most
    ``len(buckets)`` shapes."""

    padding_value: float = 0.0
    fixed_length: Optional[int] = None
    buckets: Optional[Sequence[int]] = None


def _stack_padded(arrays: Sequence[np.ndarray],
                  param: Optional[PaddingParam]) -> np.ndarray:
    """``arrays`` stacked; without ``param`` they must share a shape."""
    shapes = {a.shape for a in arrays}
    if len(shapes) == 1 and param is None:
        return np.stack(arrays)
    if param is None:
        raise ValueError(
            f"ragged samples {sorted(shapes)} need a PaddingParam")
    max_len = param.fixed_length or max(a.shape[0] for a in arrays)
    if param.buckets is not None and param.fixed_length is None:
        fitting = [b for b in sorted(param.buckets) if b >= max_len]
        if not fitting:
            raise ValueError(
                f"sequence length {max_len} exceeds the largest bucket "
                f"{max(param.buckets)}")
        max_len = fitting[0]
    out = np.full((len(arrays), max_len) + arrays[0].shape[1:],
                  param.padding_value, dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
    return out


def batch_samples(samples: Sequence[Sample],
                  feature_padding: Optional[PaddingParam] = None,
                  label_padding: Optional[PaddingParam] = None) -> MiniBatch:
    """Stack samples into a MiniBatch, features and labels each padded by
    their :class:`PaddingParam` when given."""
    feats = _stack_padded([np.asarray(s.feature) for s in samples],
                          feature_padding)
    if samples[0].label is None:
        return MiniBatch(feats, None)
    return MiniBatch(feats, _stack_padded([np.asarray(s.label)
                                           for s in samples], label_padding))


class SparseSample:
    """One example whose feature is a sparse 1-D vector in COO form
    (reference ``Sample`` over ``SparseTensor``): ``indices[k]`` holds
    ``values[k]``, dense width ``size``.  ``dense`` optionally carries
    dense feature arrays alongside (the Wide&Deep layout)."""

    __slots__ = ("indices", "values", "size", "dense", "label")

    def __init__(self, indices, values, size: int, dense=None, label=None):
        self.indices = np.asarray(indices, np.int32).reshape(-1)
        self.values = np.asarray(values, np.float32).reshape(-1)
        assert self.indices.shape == self.values.shape
        self.size = int(size)
        if dense is not None and not isinstance(dense, (list, tuple)):
            dense = [dense]  # one dense side-feature, not a list of parts
        self.dense = dense
        self.label = None if label is None else np.asarray(label)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def __repr__(self):
        return (f"SparseSample(nnz={self.nnz}, size={self.size}, "
                f"dense={None if self.dense is None else 'yes'})")


class SparseMiniBatch(MiniBatch):
    """MiniBatch whose ``input`` is a batch-COO ``COOBatch``, or ``(coo,
    *dense_parts)`` when the samples carried dense features (reference
    ``SparseMiniBatch``).  ``slice`` raises: a flat COO stream has no
    per-sample alignment."""

    def size(self) -> int:
        coo = self.input[0] if isinstance(self.input, tuple) else self.input
        return coo.dense_shape[0]

    def slice(self, offset, length):
        raise TypeError("SparseMiniBatch does not support slice(); "
                        "shard the batch instead")


def batch_sparse_samples(samples: Sequence[SparseSample],
                         nnz_buckets: Optional[Sequence[int]] = None
                         ) -> SparseMiniBatch:
    """Collate sparse samples into one batch-COO ``SparseMiniBatch``.

    The flat non-zero stream is padded to a fixed length, the smallest
    fitting value of ``nnz_buckets`` or else the next power of two, so
    that consecutive batches share a shape and stack into one block; the
    padding entries are (row 0, col 0, value 0) and add nothing."""
    import torch

    from bigdl_tpu_torch.nn.sparse import COOBatch

    n = len(samples)
    total = sum(s.nnz for s in samples)
    if nnz_buckets is not None:
        fitting = [b for b in sorted(nnz_buckets) if b >= total]
        if not fitting:
            raise ValueError(f"batch nnz {total} exceeds the largest "
                             f"bucket {max(nnz_buckets)}")
        cap = fitting[0]
    else:
        cap = 1 if total == 0 else 1 << (total - 1).bit_length()
    row = np.zeros(cap, np.int32)
    col = np.zeros(cap, np.int32)
    val = np.zeros(cap, np.float32)
    pos = 0
    width = samples[0].size
    for i, s in enumerate(samples):
        assert s.size == width, "all sparse samples must share a width"
        row[pos:pos + s.nnz] = i
        col[pos:pos + s.nnz] = s.indices
        val[pos:pos + s.nnz] = s.values
        pos += s.nnz
    coo = COOBatch(torch.from_numpy(row), torch.from_numpy(col),
                   torch.from_numpy(val), (n, width))
    if samples[0].dense is not None:
        dense = [np.stack([np.asarray(s.dense[i]) for s in samples])
                 for i in range(len(samples[0].dense))]
        inp = (coo, *dense)
    else:
        inp = coo
    label = None
    if samples[0].label is not None:
        label = np.stack([s.label for s in samples])
    return SparseMiniBatch(inp, label)

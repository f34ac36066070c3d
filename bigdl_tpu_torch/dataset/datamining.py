"""Tabular rows to named arrays, and the feature-column ops (port of
``bigdl_tpu/dataset/datamining.py``).

A :class:`RowTransformer` turns CSV-like rows into named numpy columns;
the categorical columns (:class:`CategoricalColHashBucket`,
:class:`CategoricalColVocaList`, :class:`CrossCol`, :class:`Kv2Tensor` in
sparse mode) emit a :class:`~bigdl_tpu_torch.nn.sparse.COOBatch` of CPU
tensors (row = sample, col = id) that ``SparseLinear``,
``LookupTableSparse`` and :class:`IndicatorCol` take as it is: the wide-column
layout of Wide&Deep.  All of it is host-side numpy and the standard library.

Hashing: bucket ids come from blake2s (8-byte digest, little-endian, mod
the bucket count), as in ``bigdl_tpu``, so the two packages give the same
ids for the same strings.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer


def _hash_bucket(s: str, n: int) -> int:
    d = hashlib.blake2s(s.encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(d, "little") % n


# ---------------------------------------------------------------- schemas
class RowTransformSchema:
    """One named extraction from a row (reference
    ``RowTransformSchema``): ``key`` names the output, ``fields``
    (names or indices) select columns, :meth:`transform` maps the
    selected values to an array."""

    def __init__(self, key: str, fields: Optional[Sequence] = None):
        self.key = key
        self.fields = list(fields) if fields is not None else None

    def transform(self, values: List) -> np.ndarray:
        raise NotImplementedError


class ColToTensor(RowTransformSchema):
    """Single column, passed through (reference ``ColToTensor``)."""

    def __init__(self, key: str, field):
        super().__init__(key, [field])

    def transform(self, values):
        return np.asarray(values[0])


class ColsToNumeric(RowTransformSchema):
    """Group of columns → one float vector (reference
    ``ColsToNumeric``)."""

    def __init__(self, key: str, fields: Sequence, dtype=np.float32):
        super().__init__(key, fields)
        self.dtype = dtype

    def transform(self, values):
        return np.asarray([float(v) for v in values], self.dtype)


class ColToSchema(RowTransformSchema):
    """Custom function schema: ``fn(values) -> array``."""

    def __init__(self, key: str, fields: Sequence, fn: Callable):
        super().__init__(key, fields)
        self.fn = fn

    def transform(self, values):
        return np.asarray(self.fn(values))


class RowTransformer(Transformer):
    """rows → dict of named arrays (reference ``RowTransformer``:
    Row → Table keyed by schema keys).

    Rows may be dicts, or tuples/lists paired with ``field_names``.
    Duplicate schema keys are rejected, like the reference."""

    def __init__(self, schemas: Sequence[RowTransformSchema],
                 field_names: Optional[Sequence[str]] = None):
        keys = [s.key for s in schemas]
        if len(set(keys)) != len(keys):
            raise ValueError(f"replicated schema keys in {keys}")
        self.schemas = list(schemas)
        self.field_names = list(field_names) if field_names else None

    @staticmethod
    def atomic(field_names: Sequence[str]) -> "RowTransformer":
        """One pass-through schema per column, keyed by column name
        (reference ``RowTransformer.atomic``)."""
        return RowTransformer([ColToTensor(f, f) for f in field_names],
                              field_names=list(field_names))

    @staticmethod
    def numeric(key: str, field_names: Sequence[str],
                all_field_names: Optional[Sequence[str]] = None
                ) -> "RowTransformer":
        """The named columns into one numeric vector (reference
        ``RowTransformer.numeric``).  ``all_field_names`` gives the
        row's full column order when it differs from the selection."""
        return RowTransformer(
            [ColsToNumeric(key, field_names)],
            field_names=list(all_field_names or field_names))

    @property
    def field_names(self):
        return self._field_names

    @field_names.setter
    def field_names(self, value):
        self._field_names = list(value) if value else None
        self._field_index = ({f: i for i, f in
                              enumerate(self._field_names)}
                             if self._field_names else None)

    def _select(self, row, fields):
        if isinstance(row, dict):
            return [row[f] for f in fields]
        if self._field_index is not None and fields and \
                isinstance(fields[0], str):
            return [row[self._field_index[f]] for f in fields]
        return [row[int(f)] for f in fields]

    def transform_row(self, row) -> Dict[str, np.ndarray]:
        out = {}
        for schema in self.schemas:
            if schema.fields is None:
                values = (list(row.values()) if isinstance(row, dict)
                          else list(row))
            else:
                values = self._select(row, schema.fields)
            out[schema.key] = schema.transform(values)
        return out

    def __call__(self, it):
        for row in it:
            yield self.transform_row(row)


# --------------------------------------------------- feature-column ops
class BucketizedCol:
    """Discretize numeric columns by boundaries (reference
    ``BucketizedCol.scala``: buckets (-inf,b0), [b0,b1), …,
    [bn,+inf))."""

    def __init__(self, boundaries: Sequence[float]):
        if len(boundaries) < 1:
            raise ValueError("need at least one boundary")
        self.boundaries = np.asarray(sorted(boundaries), np.float64)

    def __call__(self, x) -> np.ndarray:
        return np.searchsorted(self.boundaries, np.asarray(x, np.float64),
                               side="right").astype(np.int32)


def _to_coo(rows, cols, n, n_ids, vals=None):
    """A COOBatch of CPU tensors from accumulated (row, col) id pairs; a
    NON-empty batch with no ids keeps one zero-valued placeholder entry
    (an EMPTY batch keeps empty streams: it has no row 0)."""
    import torch

    from bigdl_tpu_torch.nn.sparse import COOBatch
    if not rows and n > 0:
        rows, cols, vals = [0], [0], [0.0]
    elif vals is None:
        vals = [1.0] * len(rows)
    return COOBatch(torch.from_numpy(np.asarray(rows, np.int32)),
                    torch.from_numpy(np.asarray(cols, np.int32)),
                    torch.from_numpy(np.asarray(vals, np.float32)),
                    (n, n_ids))


class _CategoricalBase:
    """Shared string → id-list machinery; subclasses map one string
    token to an id (or None to drop)."""

    def __init__(self, n_ids: int, delimiter: str = ","):
        self.n_ids = n_ids
        self.delimiter = delimiter

    def token_id(self, tok: str) -> Optional[int]:
        raise NotImplementedError

    def row_ids(self, s) -> List[int]:
        toks = [t for t in str(s).split(self.delimiter) if t != ""]
        out = []
        for t in toks:
            i = self.token_id(t)
            if i is not None:
                out.append(i)
        return out

    def __call__(self, column: Sequence):
        """batch of strings → COOBatch (row, col=id, value=1) of shape
        (N, n_ids) — directly consumable by SparseLinear /
        LookupTableSparse / IndicatorCol."""
        rows, cols = [], []
        for r, s in enumerate(column):
            for i in self.row_ids(s):
                rows.append(r)
                cols.append(i)
        return _to_coo(rows, cols, len(column), self.n_ids)


class CategoricalColHashBucket(_CategoricalBase):
    """String feature → hashed bucket ids (reference
    ``CategoricalColHashBucket.scala``; multi-value via delimiter,
    missing = empty string)."""

    def __init__(self, hash_bucket_size: int, delimiter: str = ","):
        if hash_bucket_size <= 1:
            raise ValueError("hash_bucket_size must be > 1")
        super().__init__(hash_bucket_size, delimiter)

    def token_id(self, tok):
        return _hash_bucket(tok, self.n_ids)


class CategoricalColVocaList(_CategoricalBase):
    """String feature → vocabulary ids (reference
    ``CategoricalColVocaList.scala``): OOV dropped by default, or sent
    to the default id len(vocab), or hashed into ``num_oov_buckets``
    (the two OOV modes are mutually exclusive, like the reference)."""

    def __init__(self, vocabulary: Sequence[str], delimiter: str = ",",
                 is_set_default: bool = False, num_oov_buckets: int = 0):
        if num_oov_buckets < 0:
            raise ValueError("num_oov_buckets must be >= 0")
        if num_oov_buckets and is_set_default:
            raise ValueError("num_oov_buckets cannot be combined with "
                             "is_set_default")
        self.vocab = {v: i for i, v in enumerate(vocabulary)}
        self.is_set_default = is_set_default
        self.num_oov_buckets = num_oov_buckets
        n = len(self.vocab) + (1 if is_set_default else num_oov_buckets)
        super().__init__(n, delimiter)

    def token_id(self, tok):
        if tok in self.vocab:
            return self.vocab[tok]
        if self.is_set_default:
            return len(self.vocab)
        if self.num_oov_buckets:
            return len(self.vocab) + _hash_bucket(tok,
                                                  self.num_oov_buckets)
        return None


class CrossCol:
    """Hashed cartesian product of >=2 categorical string columns
    (reference ``CrossCol.scala``): per row, every combination of the
    columns' (multi-)values hashes into one bucket id."""

    def __init__(self, hash_bucket_size: int, delimiter: str = ","):
        if hash_bucket_size <= 1:
            raise ValueError("hash_bucket_size must be > 1")
        self.n_ids = hash_bucket_size
        self.delimiter = delimiter

    def __call__(self, columns: Sequence[Sequence]):
        if len(columns) < 2:
            raise ValueError("CrossCol needs at least 2 columns")
        n = len(columns[0])
        rows, cols = [], []
        for r in range(n):
            combos = [""]
            for col in columns:
                toks = [t for t in str(col[r]).split(self.delimiter)
                        if t != ""]
                combos = [c + "\x1f" + t for c in combos for t in toks]
            for c in combos:
                rows.append(r)
                cols.append(_hash_bucket(c, self.n_ids))
        return _to_coo(rows, cols, n, self.n_ids)


class Kv2Tensor:
    """Parse "k:v" string columns into a dense matrix or COOBatch
    (reference ``nn/ops/Kv2Tensor.scala:46`` — ``transType=0`` dense,
    ``1`` sparse; key = integer column index into ``fea_len``).

    A host-side feature column like its siblings above: dense ``(N,
    fea_len)`` float32 or a ``COOBatch`` with that dense shape."""

    def __init__(self, kv_delimiter: str = ",", item_delimiter: str = ":",
                 trans_type: int = 0):
        if trans_type not in (0, 1):
            raise ValueError("trans_type must be 0 (dense) or 1 (sparse)")
        self.kv_delimiter = kv_delimiter
        self.item_delimiter = item_delimiter
        self.trans_type = trans_type

    def __call__(self, column: Sequence, fea_len: int):
        rows, cols, vals = [], [], []
        for r, s in enumerate(column):
            for kv in str(s).split(self.kv_delimiter):
                if kv == "":
                    continue
                try:
                    k_str, v_str = kv.split(self.item_delimiter, 1)
                    k, v = int(k_str), float(v_str)
                except ValueError as e:
                    raise ValueError(
                        f"Kv2Tensor: malformed entry {kv!r} in row {r} "
                        f"({s!r}) — expected "
                        f"'<int>{self.item_delimiter}<float>'") from e
                if not 0 <= k < fea_len:
                    raise ValueError(
                        f"key {k} out of range for fea_len={fea_len}")
                rows.append(r)
                cols.append(k)
                vals.append(v)
        if self.trans_type == 0:
            out = np.zeros((len(column), fea_len), np.float32)
            # duplicate keys accumulate, matching the reference's
            # SparseTensor→dense semantics
            np.add.at(out, (rows, cols), vals)
            return out
        return _to_coo(rows, cols, len(column), fea_len, vals)


class IndicatorCol:
    """COO categorical batch → dense multi-hot/count matrix (reference
    ``IndicatorCol.scala``; ``is_count=False`` clips to 0/1)."""

    def __init__(self, fea_len: int, is_count: bool = True):
        self.fea_len = fea_len
        self.is_count = is_count

    def __call__(self, coo) -> np.ndarray:
        n = coo.n_rows
        out = np.zeros((n, self.fea_len), np.float32)
        np.add.at(out, (np.asarray(coo.row), np.asarray(coo.col)),
                  np.asarray(coo.values, np.float32))
        if not self.is_count:
            out = np.minimum(out, 1.0)
        return out

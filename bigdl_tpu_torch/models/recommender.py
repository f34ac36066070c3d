"""Wide&Deep (port of ``bigdl_tpu/models/recommender.py``, its
``WideAndDeep``; ``NeuralCF`` is not ported yet).

Wide&Deep (Cheng et al. 2016): the wide part is a :class:`SparseLinear`
over crossed-feature ids, as a batch-COO :class:`COOBatch` (kernel B3 on
the card) or as ``(ids, weights)`` bags; the deep part concatenates one
embedding per categorical field and the dense features and runs them
through an MLP; the two logits are summed and pass through a sigmoid.

Parameter names follow the reference's tree: ``wide.weight`` (wide_dim, 1),
``wide.bias``, ``embed{i}.weight``, ``deep.{j}.weight|bias``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch.nn.activations import ReLU
from bigdl_tpu_torch.nn.layers import Linear, LookupTable
from bigdl_tpu_torch.nn.module import Module, Sequential
from bigdl_tpu_torch.nn.sparse import SparseLinear


class WideAndDeep(Module):
    """Input ``(wide, deep_ids, dense)``: ``wide`` a :class:`COOBatch` of
    shape (N, wide_dim) or ``(ids, weights)`` bags, ``deep_ids`` (N,
    n_fields) integer, ``dense`` (N, dense_dim) float (ignored when
    ``dense_dim`` is 0).  Output: the sigmoid score (N, 1)."""

    def __init__(self, wide_dim: int, deep_field_counts: Sequence[int],
                 dense_dim: int = 0, embed_dim: int = 16,
                 hidden: Sequence[int] = (100, 50),
                 name: Optional[str] = None):
        super().__init__(name or "WideAndDeep")
        # registration order is the reference's init order: wide, the
        # embeddings, deep
        self.wide = SparseLinear(wide_dim, 1)
        self.deep_field_counts = list(deep_field_counts)
        for i, c in enumerate(self.deep_field_counts):
            self.add_module(f"embed{i}", LookupTable(c, embed_dim))
        deep = Sequential()
        prev = embed_dim * len(self.deep_field_counts) + dense_dim
        for h in hidden:
            deep.add(Linear(prev, h)).add(ReLU())
            prev = h
        deep.add(Linear(prev, 1))
        self.deep = deep
        self.dense_dim = dense_dim

    @property
    def embeds(self):
        return [getattr(self, f"embed{i}")
                for i in range(len(self.deep_field_counts))]

    def forward(self, x):
        wide_in, deep_ids, dense = x
        parts = [e(deep_ids[:, i]) for i, e in enumerate(self.embeds)]
        if self.dense_dim:
            parts.append(dense)
        deep_logit = self.deep(torch.cat(parts, dim=-1))
        return torch.sigmoid(self.wide(wide_in) + deep_logit)

"""Recommender models: NeuralCF and Wide&Deep (port of
``bigdl_tpu/models/recommender.py``).

NeuralCF (He et al. 2017): user and item ids through two embedding pairs;
the GMF branch multiplies one pair, the MLP branch runs the concatenated
other pair through ``Linear``/``ReLU`` layers; a ``Linear`` head over
both and a sigmoid give the (N, 1) score.  Parameter names follow the
reference's tree: ``user_gmf.weight``, ``item_gmf.weight``,
``user_mlp.weight``, ``item_mlp.weight``, ``mlp.{j}.weight|bias``,
``head.weight|bias``.

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


class NeuralCF(Module):
    """Input ``(user_ids, item_ids)``, each (N,) integer; output the
    sigmoid score (N, 1).  ``mlp_dims`` are the MLP branch's widths."""

    def __init__(self, user_count: int, item_count: int,
                 embed_dim: int = 16, mlp_dims: Sequence[int] = (64, 32, 16),
                 name: Optional[str] = None):
        super().__init__(name or "NeuralCF")
        self.user_count, self.item_count = user_count, item_count
        self.embed_dim = embed_dim
        # registration order is the reference's init order
        self.user_gmf = LookupTable(user_count, embed_dim)
        self.item_gmf = LookupTable(item_count, embed_dim)
        self.user_mlp = LookupTable(user_count, embed_dim)
        self.item_mlp = LookupTable(item_count, embed_dim)
        mlp = Sequential()
        prev = 2 * embed_dim
        for d in mlp_dims:
            mlp.add(Linear(prev, d)).add(ReLU())
            prev = d
        self.mlp = mlp
        self.head = Linear(embed_dim + prev, 1)

    def forward(self, x):
        users, items = x
        gmf = self.user_gmf(users) * self.item_gmf(items)
        mlp = self.mlp(torch.cat([self.user_mlp(users),
                                  self.item_mlp(items)], dim=-1))
        return torch.sigmoid(self.head(torch.cat([gmf, mlp], dim=-1)))


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

"""Tree-structured LSTMs (port of ``bigdl_tpu/nn/tree.py``): ``TreeLSTM``
and the constituency ``BinaryTreeLSTM`` of Tai et al. 2015.

A tree is a tensor of rows ``[left, right, leaf]`` (1-based, 0 for none):
a row with ``left`` 0 and ``leaf`` above 0 is a leaf, which reads
embedding ``leaf``; a row with ``left`` above 0 is a composer of the
states of nodes ``left`` and ``right`` (``right`` 0 reads zeros); any
other row, padding included, is zeros.  The reference scans the rows in
order, computing both updates at every row and keeping one, so a child
index that does not point to an earlier row reads zeros there.

The port computes the same function in fewer launches: it reads the
trees once on the host, takes every leaf of the batch in one product,
then the composers level by level (a level's children all lie in lower
levels), each level one product over all its nodes; a child that points
to no earlier row is read as zeros, as the scan reads it.  All leaves
share one set of weights and all composers another, the reference's
weight sharing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module

_GATES = ("i", "lf", "rf", "u", "o")


class _Affine(Module):
    """``x @ w + b``: ``w`` (in, out) Xavier, ``b`` (out) zeros."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__("Affine")
        self.w = torch.nn.Parameter(torch.zeros(n_in, n_out),
                                    requires_grad=False)
        self.b = torch.nn.Parameter(torch.zeros(n_out), requires_grad=False)

    def reset_parameters(self, generator):
        i, o = self.w.shape
        self.w.data.copy_(Xavier().init(generator, (i, o), i, o))
        self.b.data.zero_()


class TreeLSTM(Module):
    """Base of the tree LSTMs: their sizes."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size = input_size
        self.hidden_size = hidden_size


def tree_plan(trees: np.ndarray, n_leaves: int
              ) -> Tuple[np.ndarray, np.ndarray, List[Tuple[np.ndarray, ...]]]:
    """The schedule of a batch of trees ``(B, n_nodes, 3)``: (the buffer
    slots of the leaves, the embedding rows they read, and for each level
    of composers above them (its slots, its left children's slots, its
    right children's slots)).  Slot ``b * (n_nodes + 1) + k`` holds node
    k (1-based) of tree b; slot ``b * (n_nodes + 1)`` is tree b's zeros."""
    trees = np.asarray(trees).astype(np.int64)
    B, n = trees.shape[:2]
    level = np.zeros((B, n + 1), np.int64)
    leaf_slots, leaf_rows, nodes = [], [], []

    def child(b, c, i):
        # the reference's buffer read: index c of n + 1 slots (negative
        # indices wrap, the rest clamp), a node not yet computed at row i
        # reads as zeros
        s = c + n + 1 if c < 0 else c
        s = min(max(s, 0), n)
        return s if 0 < s <= i else 0

    for b in range(B):
        for i in range(n):
            left, right, leaf = trees[b, i]
            slot = b * (n + 1) + i + 1
            if left == 0 and leaf > 0:
                leaf_slots.append(slot)
                leaf_rows.append(b * n_leaves + min(leaf - 1, n_leaves - 1))
                level[b, i + 1] = 0
            elif left > 0:
                lc, rc = child(b, left, i), child(b, right, i)
                lvl = 1 + max(level[b, lc], level[b, rc])
                level[b, i + 1] = lvl
                nodes.append((lvl, slot, b * (n + 1) + lc, b * (n + 1) + rc))
    levels = []
    for lvl in sorted({t[0] for t in nodes}):
        rows = np.array([t[1:] for t in nodes if t[0] == lvl], np.int64)
        levels.append((rows[:, 0], rows[:, 1], rows[:, 2]))
    return (np.array(leaf_slots, np.int64), np.array(leaf_rows, np.int64),
            levels)


class BinaryTreeLSTM(TreeLSTM):
    """Constituency Tree-LSTM.  Input ``(embeddings (B, n_leaves,
    input_size), trees (B, n_nodes, 3))``; output ``(B, n_nodes,
    hidden_size)``, the hidden state of every node.  Weights as the
    reference's tree: ``leaf_c``, ``leaf_o`` (input_size, hidden) and
    ``comp_{i,lf,rf,u,o}_{l,r}`` (hidden, hidden), each ``{w, b}``."""

    def __init__(self, input_size: int, hidden_size: int,
                 gate_output: bool = True, name: Optional[str] = None):
        super().__init__(input_size, hidden_size, name)
        self.gate_output = gate_output
        D, H = input_size, hidden_size
        self.leaf_c = _Affine(D, H)
        self.leaf_o = _Affine(D, H)
        for g in _GATES:
            for side in ("l", "r"):
                self.add_module(f"comp_{g}_{side}", _Affine(H, H))

    def _leaves(self, x):
        w = torch.cat([self.leaf_c.w, self.leaf_o.w], 1)
        b = torch.cat([self.leaf_c.b, self.leaf_o.b])
        z = torch.addmm(b, x, w)
        c, zo = z.split(self.hidden_size, 1)
        if self.gate_output:
            return c, torch.sigmoid(zo) * torch.tanh(c)
        return c, torch.tanh(c)

    def _compose(self, lc, lh, rc, rh):
        mods = [getattr(self, f"comp_{g}_{s}") for s in ("l", "r")
                for g in _GATES]
        w = torch.cat([torch.cat([m.w for m in mods[:5]], 1),
                       torch.cat([m.w for m in mods[5:]], 1)], 0)
        b = torch.cat([mods[k].b + mods[5 + k].b for k in range(5)])
        z = torch.addmm(b, torch.cat([lh, rh], 1), w)
        i, lf, rf, u, o = z.split(self.hidden_size, 1)
        c = torch.sigmoid(i) * torch.tanh(u) + torch.sigmoid(lf) * lc \
            + torch.sigmoid(rf) * rc
        if self.gate_output:
            return c, torch.sigmoid(o) * torch.tanh(c)
        return c, torch.tanh(c)

    def forward(self, x):
        emb, trees = x
        B, n = trees.shape[:2]
        n_leaves = emb.shape[1]
        leaf_slots, leaf_rows, levels = tree_plan(
            trees.detach().cpu().numpy(), n_leaves)
        dev, H = emb.device, self.hidden_size

        def on(a):
            return torch.from_numpy(a).to(dev)

        c = emb.new_zeros((B * (n + 1), H))
        h = emb.new_zeros((B * (n + 1), H))
        if len(leaf_slots):
            cl, hl = self._leaves(emb.reshape(B * n_leaves, -1)[
                on(leaf_rows)])
            dst = on(leaf_slots)
            c, h = c.index_put((dst,), cl), h.index_put((dst,), hl)
        for dst, left, right in levels:
            dst, left, right = on(dst), on(left), on(right)
            cn, hn = self._compose(c[left], h[left], c[right], h[right])
            c, h = c.index_put((dst,), cn), h.index_put((dst,), hn)
        return h.reshape(B, n + 1, H)[:, 1:]

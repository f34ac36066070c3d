"""Attention layers (port of ``bigdl_tpu/nn/attention.py``).

BigDL v0.x predates transformers; the reference carries attention as core
nn surface and computes it with plain array ops (einsum, mask, f32
softmax), which the port computes with the matching PyTorch operators.

Layout: (N, T, D) batch-major, heads split internally to (N, H, T, Dh).
Projection weights are stored ``(in, out)`` and used as ``x @ W``, the
reference's layout, so its parameter trees load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module


class LayerNorm(Module):
    """Layer normalization over the last dim; statistics in f32 (bf16
    inputs are normalized in f32 and cast back)."""

    def __init__(self, normalized_size: int, eps: float = 1e-5,
                 name: Optional[str] = None):
        super().__init__(name)
        self.size = normalized_size
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(normalized_size),
                                         requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(normalized_size),
                                       requires_grad=False)

    def reset_parameters(self, generator):
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def masked_softmax(scores: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim of the f32 ``scores`` where ``keep`` is
    True, as ``softmax(where(keep, scores, -inf))``, except that a row
    with nothing kept gives zeros where the reference gives NaN: such a
    row belongs to no live query (an idle decode slot), and a NaN there
    must not reach a NaN guard."""
    s = scores.masked_fill(~keep, float("-inf"))
    any_kept = keep.any(-1, keepdim=True)
    w = torch.softmax(s.masked_fill(~any_kept, 0.0), dim=-1)
    return w.masked_fill(~any_kept, 0.0)


def dot_product_attention(q, k, v, *, causal: bool = False,
                          mask: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None):
    """Softmax attention.  q, k, v: (N, H, Tq, Dh) / (N, H, Tk, Dh).
    Softmax statistics in f32.  ``causal`` cuts at the query's position
    counted from the END of the keys (``Tk - Tq`` offset: a query tail
    of the sequence); ``mask`` (broadcastable to the scores) keeps the
    positions where it is True."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("nhqd,nhkd->nhqk", q, k).float() * scale
    Tq, Tk = scores.shape[-2], scores.shape[-1]
    keep = torch.ones((Tq, Tk), dtype=torch.bool, device=scores.device)
    if causal:
        qi = torch.arange(Tq, device=scores.device)[:, None] + (Tk - Tq)
        ki = torch.arange(Tk, device=scores.device)[None, :]
        keep = ki <= qi
    if mask is not None:
        keep = keep & mask.to(torch.bool)
    w = masked_softmax(scores, keep.expand(scores.shape)).to(v.dtype)
    return torch.einsum("nhqk,nhkd->nhqd", w, v)


class MultiHeadAttention(Module):
    """Multi-head self/cross attention.  Input: a tensor (N, T, D) for
    self-attention, or a (query, kv) pair for cross-attention.

    Parameters ``wq``, ``wk``, ``wv``, ``wo`` (D, D) stored ``(in, out)``
    and drawn with Xavier in that order, and (``with_bias``) the zero
    biases ``bq``, ``bk``, ``bv``, ``bo``.  Attention dropout in training
    mode draws from ``self.generator`` (a ``torch.Generator`` the caller
    sets) and raises without one, as the reference raises without an
    rng.

    ``shard=True`` (tensor parallelism, the Megatron split): ``wq``,
    ``wk``, ``wv`` and their biases are split on the output dim, which is
    contiguous blocks of heads, ``wo`` on its input dim; ``bo`` stays
    whole.  Placed by ``parallel.shard_module`` on a model group of m
    devices, device r computes the queries, keys and values of its H/m
    heads, their attention and its partial product with ``wo``, and the
    partial sums are added at home in rank order.  Where m does not
    divide the heads, the projections are still computed by slices, but
    gathered at home, where attention runs over all heads before the
    row-split ``wo``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 causal: bool = False, with_bias: bool = True,
                 dropout: float = 0.0, shard: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.causal = causal
        self.with_bias = with_bias
        self.dropout = dropout
        self.shard = shard
        self.generator: Optional[torch.Generator] = None
        D = embed_dim
        for n in ("wq", "wk", "wv", "wo"):
            setattr(self, n, torch.nn.Parameter(torch.zeros(D, D),
                                                requires_grad=False))
        for n in ("bq", "bk", "bv", "bo"):
            setattr(self, n, torch.nn.Parameter(torch.zeros(D),
                                                requires_grad=False)
                    if with_bias else None)

    def param_specs(self):
        """The weights are stored (in, out) and used as ``x @ W``, so the
        output-dim split is dim 1 (dim 0 for Linear's (out, in))."""
        if not self.shard:
            return None
        from bigdl_tpu_torch.parallel.tensor_parallel import (REPLICATED,
                                                              Spec)
        sp = {"wq": Spec(None, "model"), "wk": Spec(None, "model"),
              "wv": Spec(None, "model"), "wo": Spec("model", None)}
        if self.with_bias:
            sp.update({"bq": Spec("model"), "bk": Spec("model"),
                       "bv": Spec("model"), "bo": REPLICATED})
        return sp

    def reset_parameters(self, generator):
        D = self.embed_dim
        xav = Xavier()
        for n in ("wq", "wk", "wv", "wo"):
            getattr(self, n).data.copy_(xav.init(generator, (D, D), D, D))
        if self.with_bias:
            for n in ("bq", "bk", "bv", "bo"):
                getattr(self, n).data.zero_()

    @property
    def model_devices(self) -> Optional[tuple]:
        """The model group the layer is placed on, or None."""
        return None if isinstance(self.wq, torch.Tensor) \
            else self.wq.devices

    @property
    def heads_split(self) -> bool:
        """Whether each device of the group holds whole heads (placed, and
        the group's size divides the heads)."""
        devs = self.model_devices
        return devs is not None and self.num_heads % len(devs) == 0

    def split_heads(self, x, heads: Optional[int] = None):
        N, T, _ = x.shape
        heads = heads or self.num_heads
        return x.reshape(N, T, heads, self.head_dim).transpose(1, 2)

    @staticmethod
    def merge_heads(o):
        N, H, T, Dh = o.shape
        return o.transpose(1, 2).reshape(N, T, H * Dh)

    def project(self, x, name: str):
        y = x @ getattr(self, "w" + name)
        if self.with_bias:
            y = y + getattr(self, "b" + name)
        return y

    def _project_slice(self, x, name: str, r: int):
        """Slice r of the q/k/v projection, on device r."""
        y = x.to(getattr(self, "w" + name).devices[r]) \
            @ getattr(self, "w" + name)[r]
        if self.with_bias:
            y = y + getattr(self, "b" + name)[r]
        return y

    def qkv(self, xq, xkv):
        """The queries, keys and values split into heads, as a list of
        ``(q, k, v)`` triples (N, h, T, Dh): one on the input's device
        unplaced or with the heads gathered home; one a device, its H/m
        heads, when the heads are split."""
        devs = self.model_devices
        if devs is None:
            return [tuple(self.split_heads(self.project(x, n))
                          for x, n in ((xq, "q"), (xkv, "k"), (xkv, "v")))]
        m = len(devs)
        if self.heads_split:
            h = self.num_heads // m
            return [tuple(self.split_heads(self._project_slice(x, n, r), h)
                          for x, n in ((xq, "q"), (xkv, "k"), (xkv, "v")))
                    for r in range(m)]
        home = xq.device
        return [tuple(self.split_heads(torch.cat(
            [self._project_slice(x, n, r).to(home) for r in range(m)], -1))
            for x, n in ((xq, "q"), (xkv, "k"), (xkv, "v")))]

    def out_proj(self, os, home):
        """The attention outputs ``os`` (the :meth:`qkv` split) through
        ``wo`` and ``bo``, the result on ``home``."""
        devs = self.model_devices
        if devs is None:
            return self.project(self.merge_heads(os[0]), "o")
        from bigdl_tpu_torch.parallel.tensor_parallel import row_sum
        if self.heads_split:
            merged = [self.merge_heads(o) for o in os]
        else:
            merged = self.merge_heads(os[0]).chunk(len(devs), -1)
        y = row_sum((merged[r].to(dev) @ self.wo[r]
                     for r, dev in enumerate(devs)), home)
        return y + self.bo if self.with_bias else y

    def _dropout(self, os):
        """One mask over all heads, drawn at home as the unsharded layer
        draws it, cut to each part's heads."""
        if self.generator is None:
            raise ValueError("attention dropout needs a generator")
        keep = 1.0 - self.dropout
        N, _, T, Dh = os[0].shape
        full = torch.rand((N, self.num_heads, T, Dh),
                          generator=self.generator,
                          device=self.generator.device) < keep
        masks = full.chunk(len(os), 1)
        return [torch.where(mk.to(o.device), o / keep, torch.zeros_like(o))
                for o, mk in zip(os, masks)]

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            xq, xkv = x
        else:
            xq = xkv = x
        os = [dot_product_attention(q, k, v, causal=self.causal)
              for q, k, v in self.qkv(xq, xkv)]
        if self.dropout > 0 and self.training:
            os = self._dropout(os)
        return self.out_proj(os, xq.device)


__all__ = ["LayerNorm", "MultiHeadAttention", "dot_product_attention",
           "masked_softmax"]

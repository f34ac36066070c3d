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
    rng.  ``shard=True`` (tensor-parallel heads) waits for the port's
    ``parallel/tensor_parallel.py`` and raises."""

    def __init__(self, embed_dim: int, num_heads: int,
                 causal: bool = False, with_bias: bool = True,
                 dropout: float = 0.0, shard: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        if shard:
            raise NotImplementedError(
                "MultiHeadAttention(shard=True) needs tensor parallelism, "
                "which the port has not ported yet (parallel/"
                "tensor_parallel.py)")
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

    def reset_parameters(self, generator):
        D = self.embed_dim
        xav = Xavier()
        for n in ("wq", "wk", "wv", "wo"):
            getattr(self, n).data.copy_(xav.init(generator, (D, D), D, D))
        if self.with_bias:
            for n in ("bq", "bk", "bv", "bo"):
                getattr(self, n).data.zero_()

    def split_heads(self, x):
        N, T, _ = x.shape
        return x.reshape(N, T, self.num_heads, self.head_dim) \
                .transpose(1, 2)

    def project(self, x, name: str):
        y = x @ getattr(self, "w" + name)
        if self.with_bias:
            y = y + getattr(self, "b" + name)
        return y

    def forward(self, x):
        if isinstance(x, (tuple, list)):
            xq, xkv = x
        else:
            xq = xkv = x
        q = self.split_heads(self.project(xq, "q"))
        k = self.split_heads(self.project(xkv, "k"))
        v = self.split_heads(self.project(xkv, "v"))
        o = dot_product_attention(q, k, v, causal=self.causal)
        if self.dropout > 0 and self.training:
            if self.generator is None:
                raise ValueError("attention dropout needs a generator")
            keep = 1.0 - self.dropout
            m = torch.rand(o.shape, generator=self.generator,
                           device=o.device) < keep
            o = torch.where(m, o / keep, torch.zeros_like(o))
        N, H, T, Dh = o.shape
        return self.project(o.transpose(1, 2).reshape(N, T, H * Dh), "o")


__all__ = ["LayerNorm", "MultiHeadAttention", "dot_product_attention",
           "masked_softmax"]

"""Transformer language model (port of ``bigdl_tpu/models/transformer.py``).

BigDL predates transformers; the reference carries a decoder-only LM and
the KV-cache carry its decode engine (``serving/decode.py``) runs.  The
layers and the tree layout are the reference's, so its parameter trees
load unchanged (``interop.load_jax_params``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.attention import (LayerNorm, MultiHeadAttention,
                                          masked_softmax)


def transformer_block(embed_dim: int, num_heads: int, mlp_dim: int,
                      dropout: float = 0.0, causal: bool = True,
                      shard: bool = False) -> nn.Sequential:
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x)).  With ``shard``,
    the heads split over the ``model`` axis and the MLP is column- then
    row-parallel (one partial sum a block, Megatron)."""
    attn = (nn.Sequential()
            .add(LayerNorm(embed_dim))
            .add(MultiHeadAttention(embed_dim, num_heads, causal=causal,
                                    dropout=dropout, shard=shard)))
    mlp = (nn.Sequential()
           .add(LayerNorm(embed_dim))
           .add(nn.Linear(embed_dim, mlp_dim,
                          shard="column" if shard else None))
           .add(nn.GELU())
           .add(nn.Linear(mlp_dim, embed_dim,
                          shard="row" if shard else None)))
    return (nn.Sequential()
            .add(nn.Sequential()
                 .add(nn.ConcatTable().add(attn).add(nn.Identity()))
                 .add(nn.CAddTable()))
            .add(nn.Sequential()
                 .add(nn.ConcatTable().add(mlp).add(nn.Identity()))
                 .add(nn.CAddTable())))


class LearnedPositionalEmbedding(nn.Module):
    """Adds a learned row per position: ``x + weight[:T]``; weight
    (max_len, embed_dim), drawn N(0, 0.02^2)."""

    def __init__(self, max_len: int, embed_dim: int, name=None):
        super().__init__(name)
        self.max_len, self.embed_dim = max_len, embed_dim
        self.weight = torch.nn.Parameter(torch.zeros(max_len, embed_dim),
                                         requires_grad=False)

    def reset_parameters(self, generator):
        self.weight.data.copy_(0.02 * torch.randn(
            (self.max_len, self.embed_dim), generator=generator))

    def forward(self, x):
        T = x.shape[1]
        return x + self.weight[:T].to(x.dtype)


def transformer_lm(vocab_size: int = 32000, embed_dim: int = 512,
                   num_heads: int = 8, num_layers: int = 6,
                   mlp_dim: Optional[int] = None, max_len: int = 2048,
                   dropout: float = 0.0, shard: bool = False):
    """Decoder-only LM: tokens (N, T) → log-probs (N, T, V)."""
    mlp_dim = mlp_dim or 4 * embed_dim
    m = (nn.Sequential(name="TransformerLM")
         .add(nn.LookupTable(vocab_size, embed_dim))
         .add(LearnedPositionalEmbedding(max_len, embed_dim)))
    for _ in range(num_layers):
        m.add(transformer_block(embed_dim, num_heads, mlp_dim, dropout,
                                causal=True, shard=shard))
    m.add(LayerNorm(embed_dim))
    m.add(nn.TimeDistributed(nn.Linear(embed_dim, vocab_size)))
    m.add(nn.LogSoftMax())
    return m


# --------------------------------------------------------------- decode path
#
# KV-cache carry for autoregressive serving (``serving/decode.py``).  The
# functions below re-run the per-layer math of the modules built by
# :func:`transformer_lm` with the same weights and f32 softmax/LN
# statistics, but carry per-layer K/V caches so a decode step touches one
# token instead of the whole context.  Equality with the full-context
# forward is tight-allclose, not bitwise: the attention GEMMs run at other
# shapes (Tq=1 against Tq=T), so their reduction order differs.
#
# Cache layout: k/v each ``(L, S, H, T_max, Dh)`` f32 — L layers, S slots,
# H heads.  ``lengths[s]`` tokens are valid in slot ``s``; positions at or
# past ``lengths[s]`` hold leftovers and are never attended, because the
# causal mask cuts at the query's absolute position.  A model placed on a
# model group whose size m divides the heads keeps each cache split on its
# heads (:class:`ShardedKV`: part r, (L, S, H/m, T_max, Dh), on device r,
# beside the heads' weights); under any other placement the cache is one
# tensor on the home device, where the heads are gathered.
#
# Index clamping, as the reference's XLA ops clamp: a K/V write of T
# tokens starts at ``min(max(pos, 0), T_max - T)`` (``dynamic_update_
# slice``), and the positional row of a position past the table is the
# table's last row (an out-of-range gather).  Both matter only for an idle
# slot whose stale write head sits at ``max_seq_len``: its lane computes
# discarded values and must not index out of bounds on the card.

def lm_layout(model):
    """Structural handles into a :func:`transformer_lm` Sequential:
    ``(embed, pos, blocks, final_ln, head, mha0)``.  Raises if ``model``
    does not have the transformer_lm layout."""
    mods = list(model.children())
    if len(mods) < 6:
        raise ValueError("not a transformer_lm: too few modules")
    embed, pos = mods[0], mods[1]
    blocks = mods[2:len(mods) - 3]
    final_ln, head = mods[-3], mods[-2]
    if not isinstance(embed, nn.LookupTable) or not blocks:
        raise ValueError("not a transformer_lm layout")
    # block = Seq[Seq[ConcatTable[attn_seq, Id], CAdd], Seq[...mlp...]]
    mha0 = blocks[0][0][0][0][1]
    if not isinstance(mha0, MultiHeadAttention):
        raise ValueError("not a transformer_lm layout (no MHA in block)")
    return embed, pos, blocks, final_ln, head, mha0


def kv_cache_spec(model, slots: int, max_len: int):
    """(shape, dtype) of ONE of the k/v caches for ``model``:
    ``(L, slots, H, max_len, Dh)`` f32.  ``serving/decode.py`` prices its
    KV budget as exactly two of these."""
    _, _, blocks, _, _, mha = lm_layout(model)
    return ((len(blocks), slots, mha.num_heads, max_len, mha.head_dim),
            torch.float32)


class ShardedKV:
    """A k or v cache (L, S, H, T_max, Dh) split on its heads over a
    model group: ``parts[r]`` holds heads ``r*H/m .. (r+1)*H/m - 1`` on
    device r.  Indexing takes a layer (views: writes land in the
    cache)."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self):
        L, S, h, T, Dh = self.parts[0].shape
        return (L, S, h * len(self.parts), T, Dh)

    @property
    def part_nbytes(self) -> int:
        """Bytes of one part (one device's share)."""
        p = self.parts[0]
        return p.numel() * p.element_size()

    def __getitem__(self, i):
        return ShardedKV([p[i] for p in self.parts])

    def zero_(self):
        for p in self.parts:
            p.zero_()
        return self


def init_kv_cache(model, slots: int, max_len: int, device=None):
    """Zeroed (k, v) cache pair sized by :func:`kv_cache_spec`: on
    ``device`` (default: the model's home), or, for a model whose heads
    are split over its model group, :class:`ShardedKV` pairs on the
    group."""
    shape, dtype = kv_cache_spec(model, slots, max_len)
    mha = lm_layout(model)[5]
    if mha.heads_split:
        devs = mha.model_devices
        L, S, H, T, Dh = shape
        part = (L, S, H // len(devs), T, Dh)
        return tuple(ShardedKV(torch.zeros(part, dtype=dtype, device=d)
                               for d in devs) for _ in range(2))
    if device is None:
        device = next(model.parameters()).device
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def splice_kv(cache, src, slot: int) -> None:
    """Write a one-slot prefill cache ``src`` (L, 1, H, Tb, Dh) into
    ``cache``'s ``slot`` at positions 0..Tb-1, in place; both plain
    tensors or both :class:`ShardedKV` of the same group."""
    dst = cache.parts if isinstance(cache, ShardedKV) else [cache]
    new = src.parts if isinstance(src, ShardedKV) else [src]
    if len(dst) != len(new):
        raise ValueError(f"a cache of {len(dst)} parts and a prefill of "
                         f"{len(new)}: the layouts differ")
    for d, n in zip(dst, new):
        d[:, slot, :, :n.shape[3]] = n[:, 0]


def write_kv(cache: torch.Tensor, new: torch.Tensor,
             start: torch.Tensor) -> None:
    """Write ``new`` (S, H, T, Dh) into ``cache`` (S, H, Tmax, Dh) in
    place, slot ``s`` at positions ``start[s] .. start[s] + T - 1``, with
    the start clamped to ``[0, Tmax - T]`` as ``dynamic_update_slice``
    clamps it."""
    S, H, T, Dh = new.shape
    s0 = start.clamp(0, cache.shape[2] - T)
    idx = s0[:, None] + torch.arange(T, device=cache.device)
    cache.scatter_(2, idx[:, None, :, None].expand(S, H, T, Dh), new)


def _cached_attention(q, k, v, k_cache, v_cache, pos_ids):
    """Write the new tokens' ``k``/``v`` (S, h, T, Dh) into the (S, h,
    Tmax, Dh) caches in place and attend the queries over the caches with
    a causal cut at each query's absolute position."""
    Dh = q.shape[-1]
    # positions within one call are consecutive by construction
    write_kv(k_cache, k, pos_ids[:, 0])
    write_kv(v_cache, v, pos_ids[:, 0])
    scores = torch.einsum("shqd,shkd->shqk", q, k_cache).float() \
        * (1.0 / Dh ** 0.5)
    # causal over ABSOLUTE positions: a query at position p sees cache
    # positions <= p; everything past the write head is masked
    ki = torch.arange(k_cache.shape[2], device=q.device)
    keep = ki[None, None, None, :] <= pos_ids[:, None, :, None]
    w = masked_softmax(scores, keep.expand(scores.shape)).to(v_cache.dtype)
    return torch.einsum("shqk,shkd->shqd", w, v_cache)


def _block_attn(mha: MultiHeadAttention, h, k_cache, v_cache, pos_ids):
    """Cached multi-head attention for one block.  ``h`` (S, T, D) are
    the post-LN hiddens of the T NEW tokens at absolute positions
    ``pos_ids`` (S, T); their k/v are written into the (S, H, Tmax, Dh)
    caches in place (a head-split layer's into its :class:`ShardedKV`
    parts, each on its device), and the queries attend over the caches
    with a causal cut at each query's absolute position."""
    parts = mha.qkv(h, h)
    kc = k_cache.parts if isinstance(k_cache, ShardedKV) else [k_cache]
    vc = v_cache.parts if isinstance(v_cache, ShardedKV) else [v_cache]
    if len(kc) != len(parts):
        raise ValueError(f"a KV cache of {len(kc)} parts for attention "
                         f"computed in {len(parts)}: the cache layout "
                         f"does not match the model's placement")
    os = []
    for (q, k, v), kr, vr in zip(parts, kc, vc):
        os.append(_cached_attention(q, k, v, kr, vr,
                                    pos_ids.to(q.device)))
    return mha.out_proj(os, h.device)


def decode_forward(model, tokens, pos_ids, k_caches, v_caches):
    """Cached forward of a :func:`transformer_lm` with its own weights:
    the T tokens per slot are NEW tokens at absolute positions
    ``pos_ids`` (S, T) — prefill passes the whole prompt with positions
    0..T-1 over empty caches, a decode step one token at its write
    position.  Returns ``(log_probs (S, T, V), k_caches, v_caches)``, the
    new tokens' K/V written into the caches in place."""
    embed, pos, blocks, final_ln, head, _ = lm_layout(model)
    x = embed(tokens)
    # the positional row per token's absolute position (the full-context
    # forward's [:T] slice is the pos_ids == arange(T) case)
    rows = pos_ids.clamp(0, pos.max_len - 1)
    x = x + pos.weight[rows].to(x.dtype)
    for i, block in enumerate(blocks):
        attn_seq = block[0][0][0]   # LN, MHA
        mlp_seq = block[1][0][0]    # LN, Linear, GELU, Linear
        o = _block_attn(attn_seq[1], attn_seq[0](x), k_caches[i],
                        v_caches[i], pos_ids)
        x = x + o
        x = x + mlp_seq(x)
    lp = torch.log_softmax(head(final_ln(x)), dim=-1)
    return lp, k_caches, v_caches


def transformer_lm_prefill(model, tokens):
    """Prefill ``tokens`` (S, T) from position 0: returns
    ``(log_probs (S, T, V), k, v)`` with caches sized (L, S, H, T, Dh) —
    the prompt's K/V, ready to be spliced into a serving cache.  Rows
    padded past their true length give unused log-probs and cache
    entries at the padded positions (the caller reads the last valid
    position, and decode overwrites pad positions before attending
    them)."""
    S, T = tokens.shape
    pos_ids = torch.arange(T, dtype=torch.int64,
                           device=tokens.device)[None, :].expand(S, T)
    k0, v0 = init_kv_cache(model, S, T, device=tokens.device)
    return decode_forward(model, tokens, pos_ids, k0, v0)


def transformer_lm_decode_step(model, tokens, lengths, k_caches, v_caches):
    """One decode step over a slot batch: ``tokens`` (S,) are the last
    emitted token per slot, ``lengths`` (S,) the number of cached
    positions per slot.  Writes each token's K/V at position
    ``lengths[s]`` (clamped) and returns ``(log_probs (S, V), k, v)``.
    Idle slots compute values the caller discards; their writes land at
    their stale write head and are overwritten by the next prefill."""
    pos_ids = lengths.to(torch.int64)[:, None]  # (S, 1)
    lp, nk, nv = decode_forward(model, tokens[:, None], pos_ids,
                                k_caches, v_caches)
    return lp[:, 0], nk, nv


__all__ = ["LearnedPositionalEmbedding", "ShardedKV", "decode_forward",
           "init_kv_cache", "kv_cache_spec", "lm_layout", "splice_kv",
           "transformer_block", "transformer_lm",
           "transformer_lm_decode_step", "transformer_lm_prefill",
           "write_kv"]

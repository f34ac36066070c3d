"""Bucketed, compressed gradient synchronization with ZeRO-1 updates (port
of ``bigdl_tpu/parallel/grad_sync.py``, the reference's
``AllReduceParameter`` + ``FP16CompressedTensor``).

Each step, on every process of the ``data`` axis:

1. the local gradients are flattened into size-capped f32 buckets
   (``Config.grad_bucket_bytes``), each padded to a multiple of the world
   size n and pre-scaled by 1/n (each process differentiated its
   local-batch mean);
2. each bucket is cast to the wire dtype (``Config.grad_wire_dtype``: f32,
   bf16 with unbiased stochastic rounding, or f16 saturating at
   +-65504/n) and reduce-scattered (``dist.reduce_scatter_tensor``, one
   asynchronous call a bucket), which hands every process the f32 sum of
   the 1/n slice it owns;
3. the optimizer updates the owned slices of the f32 master buckets
   (``gs_state["master"]``) and its own state over them, elementwise
   (ZeRO-1);
4. the updated slices are cast to the wire dtype and all-gathered
   (``dist.all_gather_into_tensor``) into full buckets, whose views are
   the parameters of the next forward.  With a sub-f32 wire the
   parameters carry wire precision; the masters stay exact f32.

With the f32 wire a step equals an f32 all-reduce of g/n and the full
update on every process, bit for bit, where the collective adds in the
same order (two processes).

Leaf order: a plan takes the parameters in the order of the reference's
``jax.tree_util.tree_flatten`` over its pytree layout
(``interop.jax_tree``: dict keys sorted as strings, so child ``"10"``
before ``"2"`` and ``bias`` before ``weight``), never in
``named_parameters()`` order, so a bucket holds the same elements at the
same offsets in both packages and a snapshot's flat state reads the same
in both.  The functions here take and return those leaves as lists in
that order (:func:`tree_leaves` of a tree in the reference's layout).

The wire's noise comes from a ``torch.Generator`` seeded from (salt
``0x77e1``, step, bucket, rank): Philox cannot reproduce JAX's threefry
words, so a bf16 wire matches the reference in distribution, not bits.
The collectives take tensors on the card under NCCL and under gloo alike
(gloo moves them through host memory itself).  Each phase runs under a ``torch.profiler.record_function`` range
named ``grad_sync.<phase>``, so a profiled step reports the sync's device
time by phase.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from bigdl_tpu_torch.checkpoint.schema import leaves_with_path
from bigdl_tpu_torch.utils.precision import stochastic_round

# grad_wire_dtype values (Config.grad_wire_dtype, DistriOptimizer's
# grad_wire_dtype=); f32 is the identity wire
WIRE_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
}

# the wire noise's seed salt; step, bucket and rank are folded in so no two
# casts of a run share noise
_WIRE_KEY_SALT = 0x77e1


def resolve_wire_dtype(name) -> torch.dtype:
    """``"bf16"``/``"f32"``/``"f16"`` (or a ``torch.dtype``; None is f32)
    -> ``torch.dtype``."""
    if name is None:
        return torch.float32
    if isinstance(name, torch.dtype):
        if name not in WIRE_DTYPES.values():
            raise ValueError(f"unsupported grad wire dtype {name}")
        return name
    try:
        return WIRE_DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown grad wire dtype {name!r}; expected one of "
            f"{sorted(set(WIRE_DTYPES))}") from None


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The dtype's numpy name (``"bfloat16"``), as the reference's
    snapshot schema writes it."""
    return str(dtype).replace("torch.", "")


def tree_leaves(tree) -> list:
    """The leaves of a tree in the reference's layout, in
    ``jax.tree_util.tree_flatten`` order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


class BucketPlan:
    """Which leaves land in which bucket, and each bucket's size padded to
    a multiple of ``n_shard``.  A pure function of the parameter tree and
    ``grad_bucket_bytes``: every process derives the same plan."""

    __slots__ = ("n_shard", "leaf_meta", "buckets", "bucket_sizes", "paths")

    def __init__(self, n_shard: int, leaf_meta, buckets, bucket_sizes,
                 paths):
        self.n_shard = n_shard
        self.leaf_meta = leaf_meta        # [(shape, size, dtype)]
        self.buckets = buckets            # [[leaf index, ...], ...]
        self.bucket_sizes = bucket_sizes  # padded, % n_shard == 0
        self.paths = paths                # leaf paths, keystr form

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def slice_size(self, b: int) -> int:
        return self.bucket_sizes[b] // self.n_shard


def build_plan(params, n_shard: int, bucket_bytes: int) -> BucketPlan:
    """Greedy size-capped bucketing of ``params`` (a tree in the
    reference's layout) in leaf order.  A leaf larger than the cap gets a
    bucket of its own; no leaf is split."""
    pairs = list(leaves_with_path(params))
    if not pairs:
        raise ValueError("grad_sync: model has no parameters")
    leaf_meta = [(tuple(leaf.shape), int(np.prod(leaf.shape, dtype=np.int64)),
                  leaf.dtype) for _, leaf in pairs]
    cap = max(1, int(bucket_bytes) // 4)  # f32 elements a bucket
    buckets: List[List[int]] = []
    sizes: List[int] = []
    cur: List[int] = []
    cur_n = 0
    for i, (_, size, _) in enumerate(leaf_meta):
        if cur and cur_n + size > cap:
            buckets.append(cur)
            sizes.append(cur_n)
            cur, cur_n = [], 0
        cur.append(i)
        cur_n += size
    buckets.append(cur)
    sizes.append(cur_n)
    padded = [-(-s // n_shard) * n_shard for s in sizes]
    return BucketPlan(n_shard, leaf_meta, buckets, padded,
                      [p for p, _ in pairs])


def _flat_bucket(plan: BucketPlan, b: int,
                 leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    parts = [leaves[i].reshape(-1).float() for i in plan.buckets[b]]
    pad = plan.bucket_sizes[b] - sum(p.numel() for p in parts)
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def flatten_to_buckets(plan: BucketPlan,
                       leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Leaves (plan order) -> padded flat f32 buckets, zeros in the tail
    padding."""
    return [_flat_bucket(plan, b, leaves) for b in range(plan.num_buckets)]


def unflatten_from_buckets(plan: BucketPlan,
                           buckets: Sequence[torch.Tensor]) -> list:
    """Inverse of :func:`flatten_to_buckets`: the leaves (plan order), in
    their shapes and dtypes (views of the buckets where the dtype is the
    bucket's)."""
    leaves: List[Optional[torch.Tensor]] = [None] * len(plan.leaf_meta)
    for b, idxs in enumerate(plan.buckets):
        off = 0
        for i in idxs:
            shape, size, dtype = plan.leaf_meta[i]
            leaves[i] = buckets[b][off:off + size].view(shape).to(dtype)
            off += size
    return leaves


def state_leaves(tree):
    """The tensors of a state tree (dicts, lists), in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from state_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from state_leaves(v)
    elif tree is not None:
        yield tree


def init_state(plan: BucketPlan, params: Sequence[torch.Tensor],
               optim_method) -> dict:
    """The grad_sync optimizer state: the full f32 master buckets and the
    optimizer's own state over them.  Only an elementwise optimizer
    qualifies: each of its state leaves must mirror a master bucket, so
    the state splits into per-process slices."""
    masters = flatten_to_buckets(plan, params)
    inner = optim_method.init_state(masters)
    master_shapes = {tuple(m.shape) for m in masters}
    for leaf in state_leaves(inner):
        if tuple(leaf.shape) not in master_shapes:
            raise ValueError(
                f"grad_sync requires an elementwise optimizer whose "
                f"state leaves mirror the parameter buckets; "
                f"{type(optim_method).__name__} created a "
                f"{tuple(leaf.shape)}-shaped state leaf (buckets: "
                f"{sorted(master_shapes)}).  Use parameter_sharding="
                f"False for this method.")
    return {"master": masters, "opt": inner}


def _map_buckets(fn, tree, b=None):
    """``fn(leaf, bucket index)`` over a grad_sync state tree; a leaf's
    bucket is the innermost list index on its path."""
    if isinstance(tree, dict):
        return {k: _map_buckets(fn, v, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_buckets(fn, v, i) for i, v in enumerate(tree))
    if b is None:
        raise ValueError("grad_sync: a state leaf has no bucket index — not "
                         "a grad_sync state layout")
    return fn(tree, b)


def owned_state(plan: BucketPlan, gs_state: dict, rank: int) -> dict:
    """The slices of a full-bucket state that process ``rank`` owns
    (copies)."""
    def take(leaf, b):
        n = plan.slice_size(b)
        return leaf[rank * n:(rank + 1) * n].clone()
    return _map_buckets(take, gs_state)


def gather_state(plan: BucketPlan, gs_state: dict, group=None) -> dict:
    """Every process's owned slices of a grad_sync state -> the full
    buckets (a collective: every process calls it)."""
    def gather(leaf, b):
        full = leaf.new_empty(plan.bucket_sizes[b])
        dist.all_gather_into_tensor(full, leaf, group=group)
        return full
    return _map_buckets(gather, gs_state)


def bucket_content_sizes(plan: BucketPlan) -> List[int]:
    """Unpadded element count of each bucket: invariant under the world
    size (only the tail padding follows ``n_shard``)."""
    return [sum(plan.leaf_meta[i][1] for i in idxs) for idxs in plan.buckets]


def reshard_state(plan: BucketPlan, gs_state: dict) -> dict:
    """Re-pad a grad_sync state (host arrays, full buckets) for a new world
    size: each bucket cut to its content and zero-padded to the plan's
    size.  Padding holds zeros and an elementwise optimizer maps zeros to
    zeros, so nothing is lost."""
    content = bucket_content_sizes(plan)

    def repad(leaf, b):
        if b >= len(content):
            raise ValueError(
                f"grad_sync reshard: state has a bucket #{b} but the new "
                f"plan only has {plan.num_buckets} — param tree or "
                f"grad_bucket_bytes changed, not just the world size")
        arr = np.asarray(leaf)
        if arr.ndim != 1 or arr.shape[0] < content[b]:
            raise ValueError(
                f"grad_sync reshard: bucket #{b} holds {arr.shape} "
                f"elements but the plan needs {content[b]} — param tree "
                f"or grad_bucket_bytes changed, not just the world size")
        out = np.zeros((plan.bucket_sizes[b],), dtype=arr.dtype)
        out[:content[b]] = arr[:content[b]]
        return out

    return _map_buckets(repad, gs_state)


def wire_seed(step: int, tag: int, rank: int) -> int:
    """Seed of the wire noise of cast ``tag`` (bucket b's reduce-scatter:
    b; its all-gather: buckets + b) at ``step`` on ``rank``."""
    seed = (((_WIRE_KEY_SALT << 24) + int(step)) << 16) + int(tag)
    return ((seed << 12) + int(rank)) & (2 ** 63 - 1)


def wire_cast(x: torch.Tensor, wire_dtype: torch.dtype,
              generator: Optional[torch.Generator], n_sum: int = 1
              ) -> torch.Tensor:
    """One bucket cast to the wire dtype with the unbiased rounding
    (``x`` itself for the f32 wire).  The f16 wire saturates first, at
    +-65504/``n_sum``: the collective sums ``n_sum`` such values, and
    even a coherent spike on every process stays finite."""
    if wire_dtype == torch.float32:
        return x
    with record_function("grad_sync.wire_cast"):
        if wire_dtype == torch.float16:
            lim = float(torch.finfo(torch.float16).max) / max(1, int(n_sum))
            x = torch.clamp(x, -lim, lim)
        return stochastic_round(x, wire_dtype, generator)


def _seeded(generator, step, tag, rank):
    if generator is not None:
        generator.manual_seed(wire_seed(step, tag, rank))
    return generator


def reduce_scatter_grads(plan: BucketPlan, grads: Sequence[torch.Tensor], *,
                         wire_dtype: torch.dtype, group=None, step: int = 0,
                         generator: Optional[torch.Generator] = None
                         ) -> List[torch.Tensor]:
    """Local gradients (plan order) -> this process's owned f32 slices of
    the global MEAN gradient.  The rank is folded into the noise seed:
    the processes' gradients are alike, and shared noise would round them
    the same way, so the errors would add up instead of cancelling."""
    n = plan.n_shard
    rank = dist.get_rank(group)
    owned, works = [], []
    for b in range(plan.num_buckets):
        with record_function("grad_sync.flatten"):
            flat = _flat_bucket(plan, b, grads) / n
        w = wire_cast(flat, wire_dtype, _seeded(generator, step, b, rank),
                      n_sum=n)
        with record_function("grad_sync.reduce_scatter"):
            o = w.new_empty(plan.slice_size(b))
            works.append(dist.reduce_scatter_tensor(o, w, group=group,
                                                    async_op=True))
        owned.append(o)
    with record_function("grad_sync.reduce_scatter"):
        for work in works:
            work.wait()
        return [o.float() for o in owned]


def all_gather_params(plan: BucketPlan, masters: Sequence[torch.Tensor], *,
                      wire_dtype: torch.dtype, group=None, step: int = 0,
                      generator: Optional[torch.Generator] = None) -> list:
    """Owned f32 master slices -> the full parameters (plan order) through
    the wire dtype: views of the gathered f32 buckets."""
    rank = dist.get_rank(group)
    gathered, works = [], []
    for b, mslice in enumerate(masters):
        w = wire_cast(mslice, wire_dtype,
                      _seeded(generator, step, plan.num_buckets + b, rank))
        with record_function("grad_sync.all_gather"):
            g = w.new_empty(plan.bucket_sizes[b])
            works.append(dist.all_gather_into_tensor(g, w, group=group,
                                                     async_op=True))
        gathered.append(g)
    with record_function("grad_sync.all_gather"):
        for work in works:
            work.wait()
        gathered = [g.float() for g in gathered]
    return unflatten_from_buckets(plan, gathered)


def clip_slices(owned: List[torch.Tensor], clip_spec, group=None
                ) -> List[torch.Tensor]:
    """Clipping on the owned slices of the REDUCED gradient, the same
    function as clipping the whole reduced gradient: value clipping is
    elementwise; the global L2 norm is the all-reduced sum of the slices'
    square sums (the slices partition the flat vector)."""
    if clip_spec is None:
        return owned
    kind = clip_spec[0]
    if kind == "value":
        _, lo, hi = clip_spec
        return [torch.clamp(o, lo, hi) for o in owned]
    if kind == "norm":
        _, max_norm = clip_spec
        sq = sum(torch.sum(o.float() ** 2) for o in owned).reshape(1)
        all_reduce_sum_(sq, group)
        norm = torch.sqrt(sq[0])
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return [o * scale for o in owned]
    raise ValueError(f"unknown clip spec {clip_spec!r}")


def sync_and_update(plan: BucketPlan, grads: Sequence[torch.Tensor],
                    gs_state: dict, optim_method, lr: float, step: int, *,
                    wire_dtype: torch.dtype, group=None, clip_spec=None,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[list, dict]:
    """One AllReduceParameter round: reduce-scatter the wire-cast
    gradients, clip, update the owned master slices (in place), all-gather
    them through the wire.  Returns the new parameters (plan order) and
    ``gs_state``."""
    owned = reduce_scatter_grads(plan, grads, wire_dtype=wire_dtype,
                                 group=group, step=step, generator=generator)
    owned = clip_slices(owned, clip_spec, group)
    with record_function("grad_sync.update"):
        optim_method.update(owned, gs_state["master"], gs_state["opt"], lr,
                            step)
    params = all_gather_params(plan, gs_state["master"],
                               wire_dtype=wire_dtype, group=group, step=step,
                               generator=generator)
    return params, gs_state


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the processes, in place (gloo has no AVG)."""
    dist.all_reduce(t, group=group)
    return t


def sync_model_state(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average the floating tensors of ``tensors`` over the processes, in
    place, with one all-reduce (BatchNorm's running statistics become the
    mean of the per-process statistics, as the reference's per-partition
    statistics); integer tensors (counters) advance alike everywhere and
    are left alone."""
    floats = [t for t in tensors if t.is_floating_point()]
    if not floats:
        return
    n = dist.get_world_size(group)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1).float() for t in floats])
        all_reduce_sum_(flat, group)
        flat = flat / n
        off = 0
        for t in floats:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()

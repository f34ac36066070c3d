"""Load the reference package's weights into a port module.

The reference keeps weights in nested ``params``/``state`` dicts keyed by
child index; the port's modules use the same names, so a dict path
``["1"]["0"]["weight"]`` is the ``state_dict`` key ``"1.0.weight"``.  The
one difference is the recurrent wrappers: the reference's ``Recurrent`` and
``TimeDistributed`` hold their inner module's tree as their own, while the
port's hold it as a child (``cell``, ``layer``).  The functions here skip
that child's name both ways, so JAX ``params["2"]["0"]["weight"]`` (layer 0
of a ``Recurrent(MultiRNNCell)``) is the port's ``"2.cell.0.weight"``;
``MultiRNNCell``, like the reference's, keeps no state of its own.  A
model with named parts keys them by name in both: ``WideAndDeep``'s
``params["wide"]["weight"]`` (the ``SparseLinear`` weight, (wide_dim, 1)),
``params["embed0"]["weight"]`` and ``params["deep"]["0"]["bias"]`` are the
port's ``wide.weight``, ``embed0.weight`` and ``deep.0.bias``.
A ``transformer_lm`` keeps the reference's tree too: ``MultiHeadAttention``'s
``wq``, ``wk``, ``wv``, ``wo`` (stored ``(in, out)``) and its four biases,
``LayerNorm``'s and ``LearnedPositionalEmbedding``'s ``weight``/``bias``,
under ``params["0"]`` (the embedding), ``["1"]["weight"]`` (positions),
``[str(2 + i)]["0"]["0"]["0"]`` (block i's attention) and so on, the head's
``TimeDistributed`` skipped as above.
A ``GPipe`` of S stages keeps the reference's stacked tree: its stage's
tree with every leaf stacked on a leading (S, ...) axis, slice s its
child ``"s"`` (``to_jax_params`` stacks the stages' tensors,
``load_jax_params`` and ``from_jax_tree`` unstack them); a
``MicrobatchedSequential`` is a container like ``Sequential``.  A
quantized recurrent cell's int8 panels, scales and biases are buffers of
the cell, so they cross as the state of its ``Recurrent``
(``state["1"]["fwd"]["wq"]``), bitwise, its params empty.
The last layers keep the reference's trees as they are: a ``While``'s
children under ``body`` (and ``cond``), a ``Cond``'s under ``true``,
``false`` (and ``pred``), ``BinaryTreeLSTM``'s ``leaf_c``, ``leaf_o`` and
``comp_{i,lf,rf,u,o}_{l,r}`` each ``{w, b}``, a ``DynamicGraph``'s by
node index as a ``Graph``'s; ``Bottle`` and ``MapTable`` hold their inner
module's tree as their own (``nn.module.Wrapper``, as ``Remat``).
A model placed for tensor parallelism (``parallel.shard_module``) keeps
the unsharded tree: a parameter split into ``Shards`` answers under its
unsharded name, reassembled on the way out and cut into its slices on the
way in.
The dicts hold numpy arrays (convert JAX arrays with ``np.asarray``) or
CPU tensors (bf16 ones too): this module imports neither JAX nor the
reference package.  :func:`jax_tree` and :func:`from_jax_tree` carry any
dict keyed by the port's parameter names (an optimizer's momentum) to
and from the same layout; snapshots use them (``checkpoint/``).  An
optimizer state entry keyed by no parameter name (LBFGS's flat
``(history, n)`` matrices over the reference's leaf order, its int32
counters) crosses as it is.

A ``DistriOptimizer``'s grad_sync state, ``{"master": [bucket, ...],
"opt": {"velocity": [bucket, ...]}}`` (:func:`is_grad_sync_state`), is in
the reference's layout already: flat f32 buckets over the parameters in
the reference's leaf order (``parallel/grad_sync.py``), keyed by no
parameter name, so it crosses packages as it is, without
:func:`jax_tree`/:func:`from_jax_tree`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _wrapped(m):
    """The inner module whose tree a reference wrapper holds as its own,
    or None."""
    from bigdl_tpu_torch.nn.recurrent import (Recurrent, RecurrentDecoder,
                                              TimeDistributed)
    if isinstance(m, (Recurrent, RecurrentDecoder)):
        return m.cell
    if isinstance(m, TimeDistributed):
        return m.layer
    return None


def _is_gpipe(m) -> bool:
    from bigdl_tpu_torch.parallel.pipeline import GPipe
    return isinstance(m, GPipe)


def _gpipe_prefixes(model: torch.nn.Module) -> Dict[str, int]:
    """{dotted reference path of each ``GPipe`` in ``model``: its stage
    count}, with the path walk of :func:`_jax_names`."""
    out = {}

    def walk(m, jprefix):
        inner = _wrapped(m)
        if inner is not None:
            return walk(inner, jprefix)
        if _is_gpipe(m):
            out[jprefix] = m.num_stages
            return
        for k, c in m.named_children():
            if not _is_shards(c):
                walk(c, f"{jprefix}{k}.")

    walk(model, "")
    return out


def _unstacked(model: torch.nn.Module, flat: Dict[str, object]
               ) -> Dict[str, object]:
    """``flat`` (dotted reference paths) with every ``GPipe`` leaf, (S,
    ...) stacked, cut into its S slices under ``<path>.<s>.``."""
    pipes = _gpipe_prefixes(model)
    if not pipes:
        return flat
    out = {}
    for key, v in flat.items():
        pre = next((p for p in pipes if key.startswith(p)), None)
        if pre is None:
            out[key] = v
            continue
        if v.shape[0] != pipes[pre]:
            raise ValueError(f"{key}: {tuple(v.shape)} is no stack of "
                             f"{pipes[pre]} stages")
        for s in range(pipes[pre]):
            out[f"{pre}{s}.{key[len(pre):]}"] = v[s]
    return out


def _stacked(trees):
    """The stages' trees as one, each leaf stacked on a new axis 0; ``{}``
    where no leaf is (the reference's state of a stateless stage)."""
    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        if isinstance(ts[0], torch.Tensor):
            return torch.stack(ts)
        return np.stack(ts)

    def has_leaf(t):
        return any(has_leaf(v) for v in t.values()) \
            if isinstance(t, dict) else True

    return stack(trees) if has_leaf(trees[0]) else {}


def _is_shards(m) -> bool:
    from bigdl_tpu_torch.parallel.tensor_parallel import Shards
    return isinstance(m, Shards)


def _jax_names(model: torch.nn.Module, kind: str) -> Dict[str, str]:
    """{dotted reference path: port name} of ``model``'s parameters
    (``kind="params"``) or buffers (``"state"``); a sharded parameter by
    its unsharded name."""
    out = {}

    def walk(m, tprefix, jprefix):
        inner = _wrapped(m)
        if inner is not None:
            name = next(k for k, c in m.named_children() if c is inner)
            return walk(inner, f"{tprefix}{name}.", jprefix)
        own = m.named_parameters(recurse=False) if kind == "params" \
            else m.named_buffers(recurse=False)
        for k, _ in own:
            out[f"{jprefix}{k}"] = f"{tprefix}{k}"
        for k, c in m.named_children():
            if _is_shards(c):
                if kind == "params":
                    out[f"{jprefix}{k}"] = f"{tprefix}{k}"
                continue
            walk(c, f"{tprefix}{k}.", f"{jprefix}{k}.")

    walk(model, "", "")
    return out


def load_jax_params(model: torch.nn.Module, params: dict,
                    state: dict = None) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters and ``state`` into its
    buffers, in place.  Every parameter of ``model`` must be covered and
    every array must land on a tensor of the same shape; raises
    ``KeyError``/``ValueError`` otherwise.  Returns ``model``."""
    from bigdl_tpu_torch.parallel.tensor_parallel import _shard_paths
    targets = {"params": {**dict(model.named_parameters()),
                          **_shard_paths(model)},
               "state": dict(model.named_buffers())}
    sources = {"params": _unstacked(model, _flatten(params)),
               "state": _unstacked(model, _flatten(state or {}))}
    covered = set()
    for kind in ("params", "state"):
        names = _jax_names(model, kind)
        for key, arr in sources[kind].items():
            if key not in names:
                raise KeyError(f"{kind} key {key!r} has no counterpart in "
                               f"{type(model).__name__}")
            dst = targets[kind][names[key]]
            if tuple(dst.shape) != tuple(arr.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} does not "
                                 f"fit {tuple(dst.shape)}")
            src = arr if isinstance(arr, torch.Tensor) \
                else torch.from_numpy(np.array(arr))
            if _is_shards(dst):
                dst.load_(src)
                covered.update(f"{names[key]}.{r}" for r in range(len(dst)))
            else:
                with torch.no_grad():
                    dst.copy_(src)
            covered.add(names[key])
    missing = sorted(k for k, v in targets["params"].items()
                     if k not in covered and not _is_shards(v))
    if missing:
        raise KeyError(f"params missing for {missing}")
    return model


def jax_tree(model: torch.nn.Module, named: Dict[str, object],
             kind: str = "params") -> dict:
    """``named`` (values keyed by the port's parameter names, ``kind=
    "params"``, or buffer names, ``"state"``) as a nested dict in the
    reference's layout of ``model``: containers keyed by child index, a
    layer's own entries under their names, ``{}`` for a layer without
    any."""
    from bigdl_tpu_torch.nn.module import Container
    from bigdl_tpu_torch.nn.recurrent import MultiRNNCell

    def walk(m, prefix):
        inner = _wrapped(m)
        if inner is not None:
            name = next(k for k, c in m.named_children() if c is inner)
            return walk(inner, f"{prefix}{name}.")
        if _is_gpipe(m):
            return _stacked([walk(c, f"{prefix}{k}.")
                             for k, c in m.named_children()])
        if isinstance(m, (Container, MultiRNNCell)):
            if isinstance(m, MultiRNNCell) and kind == "state":
                return {}
            return {str(i): walk(c, f"{prefix}{k}.")
                    for i, (k, c) in enumerate(m.named_children())}
        own = m.named_parameters(recurse=False) if kind == "params" \
            else m.named_buffers(recurse=False)
        out = {k: named[f"{prefix}{k}"] for k, _ in own}
        # a model with named parts (WideAndDeep: wide, embed{i}, deep); a
        # sharded parameter is a leaf under its unsharded name
        for k, c in m.named_children():
            if _is_shards(c):
                if kind == "params":
                    out[k] = named[f"{prefix}{k}"]
                continue
            out[k] = walk(c, f"{prefix}{k}.")
        return out

    return walk(model, "")


def from_jax_tree(model: torch.nn.Module, tree: dict,
                  kind: str = "params") -> Dict[str, object]:
    """The inverse of :func:`jax_tree`: ``{port name: leaf}``.  Raises
    ``KeyError`` for a path ``model`` does not have."""
    names = _jax_names(model, kind)
    out = {}
    for key, leaf in _unstacked(model, _flatten(tree)).items():
        if key not in names:
            raise KeyError(f"{kind} key {key!r} has no counterpart in "
                           f"{type(model).__name__}")
        out[names[key]] = leaf
    return out


def is_grad_sync_state(tree) -> bool:
    """Whether an optimizer state tree is the grad_sync layout (flat master
    buckets and the optimizer's state over them)."""
    return (isinstance(tree, dict) and set(tree) == {"master", "opt"}
            and isinstance(tree.get("master"), list))


def to_jax_params(model: torch.nn.Module):
    """The inverse of :func:`load_jax_params`: ``(params, state)`` nested
    dicts of numpy arrays in the reference's layout — containers keyed by
    child index, a layer's own parameters in ``params`` and its buffers in
    ``state``, ``{}`` for a layer without them."""
    from bigdl_tpu_torch.parallel.tensor_parallel import logical_parameters

    # copies: the arrays must not alias weights trained in place later
    def host(named):
        return {k: v.detach().cpu().numpy().copy() for k, v in named}

    return (jax_tree(model, host(logical_parameters(model).items()),
                     "params"),
            jax_tree(model, host(model.named_buffers()), "state"))

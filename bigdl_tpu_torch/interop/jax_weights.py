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
The dicts hold numpy arrays (convert JAX arrays with ``np.asarray``) or
CPU tensors (bf16 ones too): this module imports neither JAX nor the
reference package.  :func:`jax_tree` and :func:`from_jax_tree` carry any
dict keyed by the port's parameter names (an optimizer's momentum) to
and from the same layout; snapshots use them (``checkpoint/``).

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
    from bigdl_tpu_torch.nn.recurrent import Recurrent, TimeDistributed
    if isinstance(m, Recurrent):
        return m.cell
    if isinstance(m, TimeDistributed):
        return m.layer
    return None


def _jax_names(model: torch.nn.Module, kind: str) -> Dict[str, str]:
    """{dotted reference path: port name} of ``model``'s parameters
    (``kind="params"``) or buffers (``"state"``)."""
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
            walk(c, f"{tprefix}{k}.", f"{jprefix}{k}.")

    walk(model, "", "")
    return out


def load_jax_params(model: torch.nn.Module, params: dict,
                    state: dict = None) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters and ``state`` into its
    buffers, in place.  Every parameter of ``model`` must be covered and
    every array must land on a tensor of the same shape; raises
    ``KeyError``/``ValueError`` otherwise.  Returns ``model``."""
    targets = {"params": dict(model.named_parameters()),
               "state": dict(model.named_buffers())}
    sources = {"params": _flatten(params), "state": _flatten(state or {})}
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
            with torch.no_grad():
                dst.copy_(src)
            covered.add(names[key])
    missing = sorted(set(targets["params"]) - covered)
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
        if isinstance(m, (Container, MultiRNNCell)):
            if isinstance(m, MultiRNNCell) and kind == "state":
                return {}
            return {str(i): walk(c, f"{prefix}{k}.")
                    for i, (k, c) in enumerate(m.named_children())}
        own = m.named_parameters(recurse=False) if kind == "params" \
            else m.named_buffers(recurse=False)
        out = {k: named[f"{prefix}{k}"] for k, _ in own}
        # a model with named parts (WideAndDeep: wide, embed{i}, deep)
        for k, c in m.named_children():
            out[k] = walk(c, f"{prefix}{k}.")
        return out

    return walk(model, "")


def from_jax_tree(model: torch.nn.Module, tree: dict,
                  kind: str = "params") -> Dict[str, object]:
    """The inverse of :func:`jax_tree`: ``{port name: leaf}``.  Raises
    ``KeyError`` for a path ``model`` does not have."""
    names = _jax_names(model, kind)
    out = {}
    for key, leaf in _flatten(tree).items():
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
    # copies: the arrays must not alias weights trained in place later
    def host(named):
        return {k: v.detach().cpu().numpy().copy() for k, v in named}

    return (jax_tree(model, host(model.named_parameters()), "params"),
            jax_tree(model, host(model.named_buffers()), "state"))

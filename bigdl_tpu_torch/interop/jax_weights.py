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
The dicts hold numpy arrays (convert JAX arrays with ``np.asarray``):
this module imports neither JAX nor the reference package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
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
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{key}: shape {arr.shape} does not fit "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(arr)))
            covered.add(names[key])
    missing = sorted(set(targets["params"]) - covered)
    if missing:
        raise KeyError(f"params missing for {missing}")
    return model


def to_jax_params(model: torch.nn.Module):
    """The inverse of :func:`load_jax_params`: ``(params, state)`` nested
    dicts of numpy arrays in the reference's layout — containers keyed by
    child index, a layer's own parameters in ``params`` and its buffers in
    ``state``, ``{}`` for a layer without them."""
    from bigdl_tpu_torch.nn.module import Container
    from bigdl_tpu_torch.nn.recurrent import MultiRNNCell

    def walk(m):
        inner = _wrapped(m)
        if inner is not None:
            return walk(inner)
        if isinstance(m, (Container, MultiRNNCell)):
            pairs = [walk(c) for c in m.children()]
            params = {str(i): p for i, (p, _) in enumerate(pairs)}
            if isinstance(m, MultiRNNCell):
                return params, {}
            return params, {str(i): s for i, (_, s) in enumerate(pairs)}
        # copies: the arrays must not alias weights trained in place later
        params = {k: v.detach().cpu().numpy().copy()
                  for k, v in m.named_parameters(recurse=False)}
        state = {k: v.detach().cpu().numpy().copy()
                 for k, v in m.named_buffers(recurse=False)}
        # a model with named parts (WideAndDeep: wide, embed{i}, deep)
        for k, c in m.named_children():
            params[k], state[k] = walk(c)
        return params, state

    return walk(model)

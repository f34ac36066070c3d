"""Load the reference package's weights into a port module.

The reference keeps weights in nested ``params``/``state`` dicts keyed by
child index; the port's modules use the same names, so a dict path
``["1"]["0"]["weight"]`` is the ``state_dict`` key ``"1.0.weight"``.
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


def load_jax_params(model: torch.nn.Module, params: dict,
                    state: dict = None) -> torch.nn.Module:
    """Copy ``params`` into ``model``'s parameters and ``state`` into its
    buffers, in place.  Every parameter of ``model`` must be covered and
    every array must land on a tensor of the same shape; raises
    ``KeyError``/``ValueError`` otherwise.  Returns ``model``."""
    targets = {"params": dict(model.named_parameters()),
               "state": dict(model.named_buffers())}
    sources = {"params": _flatten(params), "state": _flatten(state or {})}
    for kind in ("params", "state"):
        have = targets[kind]
        for key, arr in sources[kind].items():
            if key not in have:
                raise KeyError(f"{kind} key {key!r} has no counterpart in "
                               f"{type(model).__name__}")
            dst = have[key]
            if tuple(dst.shape) != arr.shape:
                raise ValueError(f"{key}: shape {arr.shape} does not fit "
                                 f"{tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(arr)))
    missing = sorted(set(targets["params"]) - set(sources["params"]))
    if missing:
        raise KeyError(f"params missing for {missing}")
    return model


def to_jax_params(model: torch.nn.Module):
    """The inverse of :func:`load_jax_params`: ``(params, state)`` nested
    dicts of numpy arrays in the reference's layout — containers keyed by
    child index, a layer's own parameters in ``params`` and its buffers in
    ``state``, ``{}`` for a layer without them."""
    from bigdl_tpu_torch.nn.module import Container

    def walk(m):
        if isinstance(m, Container):
            pairs = [walk(c) for c in m.children()]
            return ({str(i): p for i, (p, _) in enumerate(pairs)},
                    {str(i): s for i, (_, s) in enumerate(pairs)})
        return ({k: v.detach().cpu().numpy()
                 for k, v in m.named_parameters(recurse=False)},
                {k: v.detach().cpu().numpy()
                 for k, v in m.named_buffers(recurse=False)})

    return walk(model)

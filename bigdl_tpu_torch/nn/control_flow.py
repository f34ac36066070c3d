"""Control-flow modules for hand-built graphs (port of
``bigdl_tpu/nn/control_flow.py``).

The reference's dynamic graphs run Enter/Exit/Switch/Merge nodes under a
scheduler that propagates "dead" tokens through untaken branches; its JAX
package folds them into three modules, which the port keeps:

- :class:`While`: a whole loop frame.  The predicate is read on the host
  once a trip (the reference's per-trip semantics), and the body runs
  only while it holds, so a body that would diverge after the exit never
  runs there and cannot put inf or NaN into the gradients.  With
  ``max_trip_count`` the loop stops after that many trips at the most;
  without it, it runs until the predicate fails.  Both forms are
  differentiable here (torch records the trips that ran).
- :class:`Cond`: only the taken branch runs.
- :class:`Switch` / :class:`Merge`: the reference's port semantics as
  dataflow: both branches compute and ``Merge`` selects.

All are ordinary modules: use them as ``Graph`` nodes (a
:class:`~bigdl_tpu_torch.nn.graph.DynamicGraph`) or inside a
``Sequential``.  Their weights keep the reference's tree: ``While``'s
under ``body`` (and ``cond`` when the predicate is a module), ``Cond``'s
under ``true``, ``false`` (and ``pred``).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from bigdl_tpu_torch.nn.module import Module


def _as_pred(v) -> torch.Tensor:
    """A scalar predicate as a 0-d bool tensor (one element only)."""
    return torch.as_tensor(v).reshape(()).bool()


def _tree_where(pred, t, f):
    if isinstance(t, (tuple, list)):
        return type(t)(_tree_where(pred, a, b) for a, b in zip(t, f))
    if isinstance(t, dict):
        return {k: _tree_where(pred, t[k], f[k]) for k in t}
    t, f = torch.as_tensor(t), torch.as_tensor(f)
    return torch.where(pred.to(t.device), t, f)


class While(Module):
    """``while cond(carry): carry = body(carry)`` as a module.

    ``cond`` is a callable ``carry -> bool scalar`` or a module; ``body`` a
    module mapping a carry to a carry of the same structure.  With
    ``max_trip_count`` at most that many trips run.  The predicate is
    read on the host before each trip."""

    def __init__(self, cond: Union[Callable, Module], body: Module,
                 max_trip_count: Optional[int] = None,
                 name: Optional[str] = None):
        super().__init__(name or "While")
        self.body = body
        if isinstance(cond, Module):
            self.cond = cond
        else:
            object.__setattr__(self, "cond", cond)
        self.max_trip_count = max_trip_count
        #: trips the last forward ran
        self.trips = 0

    def forward(self, x):
        trips = 0
        while self.max_trip_count is None or trips < self.max_trip_count:
            if not bool(_as_pred(self.cond(x))):
                break
            x = self.body(x)
            trips += 1
        self.trips = trips
        return x


class Cond(Module):
    """``true_branch(x) if pred(x) else false_branch(x)``: only the taken
    branch runs (the predicate read on the host)."""

    def __init__(self, pred: Union[Callable, Module], true_branch: Module,
                 false_branch: Module, name: Optional[str] = None):
        super().__init__(name or "Cond")
        self.add_module("true", true_branch)
        self.add_module("false", false_branch)
        if isinstance(pred, Module):
            self.pred = pred
        else:
            object.__setattr__(self, "pred", pred)

    def forward(self, x):
        branch = "true" if bool(_as_pred(self.pred(x))) else "false"
        return self._modules[branch](x)


class Switch(Module):
    """``(data, pred)`` to ``(data, data)``, the inputs of the false and
    the true subgraph; both compute, and :class:`Merge` selects."""

    def forward(self, x):
        data, _ = x
        return data, data


class Merge(Module):
    """``(false_value, true_value, pred)`` to the true value where
    ``pred`` holds, else the false one (tables entry by entry)."""

    def forward(self, x):
        false_val, true_val, pred = x
        return _tree_where(_as_pred(pred), true_val, false_val)

"""Module system (port of ``bigdl_tpu/nn/module.py``).

Layers are ``torch.nn.Module``s that hold their weights.  Each one uses the
parameter and buffer names of the reference's ``params``/``state``
pytrees, and containers name their children ``"0"``, ``"1"``, ... in
order, so ``state_dict()`` keys are the reference's pytree paths: JAX
``params["1"]["0"]["weight"]`` is ``"1.0.weight"`` here.

Weights are drawn by :meth:`Module.initialize` from one explicit
``torch.Generator`` walked through the tree in order; until then a
layer's weights are deterministic placeholders (zeros for weights, the
reference's init values for BatchNorm).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class Module(torch.nn.Module):
    """Base class of all layers."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw this layer's own weights (not its children's).  Layers
        without weights keep this no-op."""

    def initialize(self, rng: Union[int, torch.Generator] = 0) -> "Module":
        """Draw every weight of the tree from one generator (an int seeds
        a new CPU generator), visiting modules in order."""
        gen = rng if isinstance(rng, torch.Generator) \
            else torch.Generator().manual_seed(int(rng))
        for m in self.modules():
            if isinstance(m, Module):
                m.reset_parameters(gen)
        return self


class Container(Module):
    """Composite module; children are named by their index."""

    def __init__(self, *modules: Module, name: Optional[str] = None):
        super().__init__(name)
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i: int) -> Module:
        return self._modules[str(i)]


class Sequential(Container):
    """Feed children in order."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Container):
    """Apply every child to the same input; return a tuple."""

    def forward(self, x):
        return tuple(m(x) for m in self._modules.values())


class Concat(Container):
    """Apply every child to the same input and concatenate the outputs
    along ``dim`` (0-based, the batch at 0: ``dim=1`` is NCHW's channel
    axis, ``dim=3`` NHWC's)."""

    def __init__(self, dim: int = 1, name: Optional[str] = None):
        super().__init__(name=name)
        self.dim = dim

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()], self.dim)


class Identity(Module):
    def forward(self, x):
        return x

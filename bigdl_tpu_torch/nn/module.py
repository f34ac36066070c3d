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

:class:`Remat` recomputes its inner module's forward in the backward
instead of keeping its activations (``torch.utils.checkpoint``);
:func:`remat_contexts` makes a recomputed forward see what the first one
saw: BatchNorm leaves its running statistics alone while
:func:`recomputing` is true, and the explicit generators of ``Dropout``
and ``RReLU`` are set back to their state at the first forward, so a mask
is drawn once.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Union

import torch


class Module(torch.nn.Module):
    """Base class of all layers."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name if name is not None else type(self).__name__

    def __call__(self, *args, **kwargs):
        # functional-graph syntax: a module called on Node(s) builds a DAG
        # edge (nn/graph.py); any other call is torch's, hooks included
        if len(args) == 1 and not kwargs \
                and not isinstance(args[0], torch.Tensor):
            from bigdl_tpu_torch.nn.graph import Node, is_nodes
            if is_nodes(args[0]):
                x = args[0]
                return Node(self, [x] if isinstance(x, Node) else list(x))
        return super().__call__(*args, **kwargs)

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

    # the reference's eager conveniences, on torch's own mechanisms
    def predict(self, data, batch_size: int = 128, device="cuda"):
        """Batched inference through
        :class:`~bigdl_tpu_torch.optim.predictor.Predictor`."""
        from bigdl_tpu_torch.optim.predictor import Predictor
        return Predictor(self, batch_size=batch_size,
                         device=device).predict(data)

    def predict_class(self, data, batch_size: int = 128, device="cuda"):
        from bigdl_tpu_torch.optim.predictor import Predictor
        return Predictor(self, batch_size=batch_size,
                         device=device).predict_class(data)

    def evaluate_on(self, dataset, methods, device="cuda"):
        """``{method name: ValidationResult}`` through
        :class:`~bigdl_tpu_torch.optim.predictor.Evaluator`."""
        from bigdl_tpu_torch.optim.predictor import Evaluator
        return Evaluator(self, device=device).evaluate(dataset, methods)

    def evaluate(self) -> "Module":
        """Inference mode (torch's ``eval``)."""
        return self.eval()

    def training_mode(self) -> "Module":
        return self.train()

    def zero_grad_parameters(self) -> None:
        """Zero every accumulated gradient in place."""
        self.zero_grad(set_to_none=False)

    def set_name(self, name: str) -> "Module":
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name


class Stochastic(Module):
    """A layer that draws random numbers in training mode from
    ``self.generator``, a ``torch.Generator`` on the input's device that
    the caller sets (``LocalOptimizer`` gives each such layer of its
    training copy one of its own)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.generator: Optional[torch.Generator] = None


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


class ParallelTable(Container):
    """Apply the i-th child to the i-th element of the input; return a
    tuple."""

    def forward(self, x):
        return tuple(m(x[i]) for i, m in enumerate(self._modules.values()))


def _shapes(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_shapes(e) for e in x)
    if isinstance(x, dict):
        return {k: _shapes(v) for k, v in x.items()}
    return tuple(x.shape)


class Echo(Module):
    """Debug layer: prints the input's shapes (a table's, leaf by leaf)
    at each call and passes the input on."""

    def forward(self, x):
        print(f"[Echo {self.name}] {_shapes(x)}")
        return x


class Lambda(Module):
    """A stateless layer around a tensor function, e.g. ``Lambda(lambda
    x: x.amax(1))`` for a max over time (``amax``, not ``max(dim)``, whose
    gradient goes to one of tied maxima only)."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__(name)
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


# ------------------------------------------------------- rematerialization
_recompute_depth = 0  # > 0 while a checkpointed forward is being redone


def recomputing() -> bool:
    """Whether the forward running now is a recomputation (in the
    backward) of a checkpointed region: stateful layers must not update
    their state a second time."""
    return _recompute_depth > 0


def walk(root: torch.nn.Module):
    """Every module of ``root``'s tree, the inner module of each
    :class:`Wrapper` (a :class:`Remat`) included (``modules()`` reaches
    only its children)."""
    for m in root.modules():
        yield m
        inner = getattr(m, "inner", None) if isinstance(m, Wrapper) \
            else None
        if inner is not None:
            yield inner


_ATEN = torch.ops.aten
# JAX's dots_saveable counts convolutions as products too
_DOT_OPS = frozenset([_ATEN.mm.default, _ATEN.addmm.default,
                      _ATEN.bmm.default, _ATEN.baddbmm.default,
                      _ATEN.convolution.default])
_CONV_OPS = frozenset([_ATEN.convolution.default])
SAVE_POLICIES = {"dots": _DOT_OPS, "tails": _CONV_OPS}


def _save_policy(ops: frozenset) -> Callable:
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return policy


class _Recompute:
    """The recomputation's context: :func:`recomputing` is true and each
    stochastic layer's generator holds its state of the first forward
    (the caller's state comes back afterwards)."""

    def __init__(self, saved):
        self.saved, self.current = saved, []

    def __enter__(self):
        global _recompute_depth
        _recompute_depth += 1
        self.current = [(g, g.get_state()) for g, _ in self.saved]
        for g, state in self.saved:
            g.set_state(state)

    def __exit__(self, *exc):
        global _recompute_depth
        for g, state in self.current:
            g.set_state(state)
        _recompute_depth -= 1
        return False


class _FirstForward:
    def __init__(self, gens, saved):
        self.gens, self.saved = gens, saved

    def __enter__(self):
        self.saved[:] = [(g, g.get_state()) for g in self.gens]

    def __exit__(self, *exc):
        return False


def remat_contexts(module: torch.nn.Module,
                   policy: Optional[str] = None) -> Callable:
    """``context_fn`` for ``torch.utils.checkpoint.checkpoint`` over a
    region holding ``module``: ``policy`` None saves nothing (the whole
    forward is recomputed), ``"dots"`` saves the outputs of matrix
    products and convolutions, ``"tails"`` those of convolutions only."""
    gens = [m.generator for m in walk(module)
            if isinstance(getattr(m, "generator", None), torch.Generator)]
    if policy is not None and policy not in SAVE_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; use None, "
                         f"{', '.join(map(repr, SAVE_POLICIES))}")

    def context_fn():
        saved: list = []
        fwd, rec = _FirstForward(gens, saved), _Recompute(saved)
        if policy is None:
            return fwd, rec
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        sac_fwd, sac_rec = create_selective_checkpoint_contexts(
            _save_policy(SAVE_POLICIES[policy]))
        return _both(fwd, sac_fwd), _both(rec, sac_rec)

    return context_fn


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def checkpointed(fn: Callable, module: torch.nn.Module,
                 policy: Optional[str] = None) -> Callable:
    """``fn`` whose activations are recomputed in the backward
    (:func:`remat_contexts` over ``module``, which ``fn`` runs)."""
    from torch.utils.checkpoint import checkpoint
    context_fn = remat_contexts(module, policy)

    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


class Wrapper(Module):
    """A module transparent in the tree: it shares its inner module's
    parameters, buffers and children (no key level), so ``state_dict()``
    keys, snapshots and interop paths are those of the inner module, as
    the reference's wrappers hold their inner module's tree as their own
    (``Remat``, ``Bottle``, ``MapTable``).  ``walk`` reaches the inner
    module itself."""

    def __init__(self, inner: Module, name: Optional[str] = None):
        super().__init__(name)
        object.__setattr__(self, "inner", inner)  # not a child: no key level
        self._parameters = inner._parameters
        self._buffers = inner._buffers
        self._modules = inner._modules
        self._non_persistent_buffers_set = inner._non_persistent_buffers_set

    def reset_parameters(self, generator):
        if isinstance(self.inner, Module):
            self.inner.reset_parameters(generator)

    def train(self, mode: bool = True):
        super().train(mode)
        self.inner.training = mode
        return self


class Remat(Wrapper):
    """Rematerialization: ``inner``'s activations are not kept for the
    backward but recomputed there.  ``policy`` None recomputes everything,
    ``"tails"`` keeps the convolutions' outputs and recomputes the
    BatchNorm and ReLU tails, ``"dots"`` keeps every product's output.

    Transparent in the tree (a :class:`Wrapper`; the reference's
    ``spec_children`` returns the inner module).  The region's parameters
    enter the checkpoint as inputs, so a recomputation under
    ``functional_call`` (mixed precision) uses the casts the first forward
    used."""

    def __init__(self, inner: Module, policy: Optional[str] = None,
                 name: Optional[str] = None):
        super().__init__(inner,
                         name or f"Remat[{getattr(inner, 'name', '')}]")
        self.policy = policy

    def forward(self, x):
        from torch.func import functional_call
        named = list(self.inner.named_parameters())
        names = [k for k, _ in named]

        def run(x, *tensors):
            return functional_call(self.inner, dict(zip(names, tensors)),
                                   (x,))
        return checkpointed(run, self.inner, self.policy)(
            x, *(t for _, t in named))

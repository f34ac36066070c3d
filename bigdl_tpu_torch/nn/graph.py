"""Graph — DAG models (port of ``bigdl_tpu/nn/graph.py``).

A declarative DAG of modules executed in topological order.  Calling a
module on :class:`Node` s builds an edge instead of running it
(``Module.__call__``)::

    inp = Input()
    h = Linear(4, 8)(inp)
    a = ReLU()(h)
    b = Tanh()(h)
    out = CAddTable()([a, b])      # several inputs: a list of Nodes
    model = Graph([inp], [out])

**Weight sharing:** the same module instance at several positions ties
the weights.  torch registers a child once; here it is registered under
the key of its first occurrence in the topological order (``str(i)``,
the reference's parameter key), so ``state_dict()`` keys,
``parameters()`` and ``interop.to_jax_params`` follow the reference's
``params[key]`` tree and a shared module's weights appear once.

:class:`DynamicGraph` is a ``Graph`` whose nodes may be the control-flow
modules of ``nn/control_flow.py`` (``While``, ``Cond``, ``Switch``,
``Merge``); data-dependent control flow lives inside those nodes, so it
runs in the same topological order.  Files that name it load as one.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

from bigdl_tpu_torch.nn.module import Module


class Node:
    """A module instance and its input edges."""

    __slots__ = ("module", "inputs")

    def __init__(self, module: Optional[Module], inputs: Sequence["Node"]):
        self.module = module
        self.inputs = list(inputs)

    def __repr__(self):
        name = self.module.name if self.module is not None else "Input"
        return f"Node({name})"


class Input(Node):
    """Graph input placeholder."""

    def __init__(self):
        super().__init__(None, [])


def is_nodes(x) -> bool:
    """Whether ``x`` is a Node or a non-empty list/tuple of Nodes (the
    graph-building call of a module)."""
    return isinstance(x, Node) or (
        isinstance(x, (list, tuple)) and len(x) > 0
        and all(isinstance(e, Node) for e in x))


class Graph(Module):
    """Static DAG container.  Children are keyed by the topological index
    of their module's first occurrence; nodes sharing a module share its
    weights and, in training, its running statistics in order."""

    def __init__(self, inputs: Sequence[Node], outputs: Sequence[Node],
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_nodes = list(inputs)
        self.output_nodes = list(outputs)
        self._order = self._topo_sort()
        self._param_keys: list = []
        first_seen: dict = {}
        for i, n in enumerate(self._order):
            key = first_seen.setdefault(id(n.module), str(i))
            self._param_keys.append(key)
            if key == str(i):
                self.add_module(key, n.module)

    def _topo_sort(self) -> list:
        """Reverse DFS from the outputs."""
        visited: dict = {}  # id -> 0 visiting, 1 done
        order: list = []
        inputs = {id(n) for n in self.input_nodes}

        def visit(n: Node):
            st = visited.get(id(n))
            if st == 1:
                return
            if st == 0:
                raise ValueError("graph contains a cycle")
            visited[id(n)] = 0
            for p in n.inputs:
                visit(p)
            visited[id(n)] = 1
            if n.module is not None:
                order.append(n)
            elif id(n) not in inputs:
                raise ValueError("dangling Input node not listed in inputs")

        for out in self.output_nodes:
            visit(out)
        return order

    def __deepcopy__(self, memo):
        # the nodes first, in topological order, so that copying a node
        # never recurses through its inputs: a deep graph's chain of nodes
        # would exceed Python's recursion limit
        for n in self.input_nodes + self._order:
            if id(n) not in memo:
                new = type(n).__new__(type(n))
                new.module = copy.deepcopy(n.module, memo)
                new.inputs = [memo[id(p)] for p in n.inputs]
                memo[id(n)] = new
        out = type(self).__new__(type(self))
        memo[id(self)] = out
        for k, v in self.__dict__.items():
            out.__dict__[k] = copy.deepcopy(v, memo)
        return out

    def forward(self, input):
        values: dict = {}
        if len(self.input_nodes) == 1:
            values[id(self.input_nodes[0])] = input
        else:
            if len(input) != len(self.input_nodes):
                raise ValueError(
                    f"graph expects {len(self.input_nodes)} inputs, "
                    f"got {len(input)}")
            for node, x in zip(self.input_nodes, input):
                values[id(node)] = x
        for node in self._order:
            args = [values[id(p)] for p in node.inputs]
            values[id(node)] = node.module(
                args[0] if len(args) == 1 else tuple(args))
        outs = [values[id(n)] for n in self.output_nodes]
        return outs[0] if len(outs) == 1 else tuple(outs)


class DynamicGraph(Graph):
    """A graph whose nodes may be control-flow modules (``While``,
    ``Cond``, ``Switch``/``Merge``): the reference's dynamic graph, whose
    scheduler interprets loop frames and dead tokens node by node.  Here
    a loop frame is one ``While`` node and a Switch/Merge pair a select,
    so the graph runs in ``Graph``'s topological order, and a loop trained
    through ``While`` gets its gradients, which the reference's dynamic
    graphs cannot give."""

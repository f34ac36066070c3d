"""Train a loaded TF graph (port of ``bigdl_tpu/interop/session.py``, the
``BigDLSessionImpl.train`` analog).

The imported :class:`~bigdl_tpu_torch.interop.tf_format.TFGraphModule`
is a module whose VariableV2 nodes are parameters, so session training is
adapter glue: pick the output, pair it with a criterion and feed batches
from a ``DataSet`` through ``LocalOptimizer``/``DistriOptimizer``; or,
when the graph carries its OWN input pipeline (queue runners), replay that
pipeline on the host (``interop/tf_queues.py``), feed the dequeue node and
minimize the graph's in-graph loss.  The session runs on ``device``
("cuda" by default, "cpu" only when asked).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.engine import resolve_device
from bigdl_tpu_torch.interop.tf_format import (TFGraphModule, load_tf_graph,
                                               parse_graphdef_binary,
                                               parse_graphdef_text)


class TFSession:
    """Train or fine-tune an imported GraphDef with the port's
    optimizers.

    With ``inputs=None`` the graph must be queue-fed: its input pipeline
    (filename queue -> reader -> decode -> example queue -> dequeue) is
    detected and replayed on the host, and the dequeue node becomes the
    feed point."""

    def __init__(self, graph_or_path, inputs: Optional[Sequence[str]] = None,
                 outputs: Optional[Sequence[str]] = None, device="cuda"):
        self.device = resolve_device(device)
        self.pipeline = None
        if isinstance(graph_or_path, TFGraphModule):
            self.graph = graph_or_path
            return
        if outputs is None:
            raise ValueError("loading from a path needs outputs= node names")
        if inputs is not None:
            self.graph = load_tf_graph(graph_or_path, inputs, outputs)
            return
        # queue-fed: detect the in-graph pipeline, feed at the dequeue
        from bigdl_tpu_torch.interop.tf_queues import QueuePipeline
        with open(graph_or_path, "rb") as f:
            data = f.read()
        if str(graph_or_path).endswith((".pbtxt", ".txt")):
            nodes = parse_graphdef_text(data.decode("utf-8"))
        else:
            nodes = parse_graphdef_binary(data)
        self.pipeline = QueuePipeline(nodes, outputs)
        self.graph = TFGraphModule(nodes, [self.pipeline.dequeue], outputs)

    def train(self, dataset: Optional[AbstractDataSet] = None,
              criterion: Optional[nn.Criterion] = None,
              optim_method: Optional[optim.OptimMethod] = None,
              end_when: Optional[optim.Trigger] = None,
              distributed: bool = False, mesh=None, epochs: int = 1):
        """Train the imported graph's variables.

        - with a ``dataset``: the optimizer pairs the graph's output with
          ``criterion`` against each batch's target; returns the
          optimizer (its ``state`` carries loss and epoch);
        - with ``dataset=None`` (queue-fed graphs): batches come from the
          replayed pipeline and the graph's (scalar) output is minimized
          directly; returns the per-step losses."""
        if dataset is None:
            return self._train_queue_fed(optim_method, epochs, end_when)
        if criterion is None:
            raise ValueError("dataset training needs a criterion")
        if distributed:
            opt = optim.DistriOptimizer(self.graph, dataset, criterion,
                                        mesh=mesh, device=self.device)
        else:
            opt = optim.LocalOptimizer(self.graph, dataset, criterion,
                                       device=self.device)
        opt.set_optim_method(optim_method or optim.SGD(
            learning_rate=0.01, momentum=0.9, dampening=0.0))
        opt.set_end_when(end_when or optim.max_epoch(epochs))
        opt.optimize()
        return opt

    def _train_queue_fed(self, optim_method, epochs: int,
                         end_when: Optional[optim.Trigger] = None):
        if self.pipeline is None:
            raise ValueError(
                "train(dataset=None) needs an in-graph queue pipeline "
                "(load via TFSession(path, outputs=...) with inputs=None)")
        m = self.graph.to(self.device)
        method = optim_method or optim.SGD(learning_rate=0.01,
                                           momentum=0.9, dampening=0.0)
        params = dict(m.named_parameters())
        ostate = method.init_state(params)

        def to_dev(v):
            v = np.asarray(v)
            return v if v.dtype == object else \
                torch.from_numpy(v).to(self.device)

        losses, it, stop = [], 0, False
        for p in params.values():
            p.requires_grad_(True)
        try:
            for epoch in range(epochs):
                for feeds in self.pipeline.batches(epochs=1, seed=epoch):
                    # a pre-step check, as in LocalOptimizer: max_epoch(N)
                    # stops before the first step of epoch N
                    if end_when is not None and end_when(
                            {"neval": it, "epoch": epoch,
                             "loss": losses[-1] if losses
                             else float("inf")}):
                        stop = True
                        break
                    feeds = {k: to_dev(v) for k, v in feeds.items()}
                    lr = method.current_lr(it, epoch)
                    for p in params.values():
                        p.grad = None
                    loss = torch.mean(m(feeds))
                    loss.backward()
                    method.update(
                        {k: p.grad if p.grad is not None
                         else torch.zeros_like(p) for k, p in params.items()},
                        params, ostate, lr, it)
                    losses.append(float(loss.detach()))
                    it += 1
                if stop:
                    break
        finally:
            for p in params.values():
                p.requires_grad_(False)
                p.grad = None
        return losses

    def run(self, feeds) -> np.ndarray:
        """Forward the graph on host arrays (``session.run``)."""
        m = self.graph.to(self.device)
        if isinstance(feeds, dict):
            x = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in feeds.items()}
        else:
            x = torch.from_numpy(np.asarray(feeds)).to(self.device)
        with torch.no_grad():
            out = m(x)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

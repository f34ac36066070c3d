"""Keras-style ``Sequential``/``Model`` topology with compile, fit,
evaluate and predict (port of ``bigdl_tpu/keras/topology.py``).

Building a ``Sequential`` walks the deferred ``KerasLayer`` s forward,
inferring each input shape (``keras/layers.py``), and draws the weights
with ``initialize(0)``, as the reference's lazy init does.  ``fit`` drives
``LocalOptimizer``/``DistriOptimizer`` on an in-memory ``DataSet`` (the
trained weights land in the core module), ``evaluate`` runs ``Evaluator``
and ``predict`` runs ``Predictor``.  The device is ``device=`` of
``compile`` or ``fit`` ("cuda" by default, "cpu" only when asked).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.engine import resolve_device
from bigdl_tpu_torch.keras.layers import KerasLayer, infer_output_shape
from bigdl_tpu_torch.optim.predictor import Evaluator, Predictor

_OPTIMIZERS = {
    "sgd": lambda: optim.SGD(learning_rate=0.01),
    "adam": lambda: optim.Adam(),
    "adagrad": lambda: optim.Adagrad(),
    "adadelta": lambda: optim.Adadelta(),
    "adamax": lambda: optim.Adamax(),
    "rmsprop": lambda: optim.RMSprop(),
}

_LOSSES = {
    # Keras contract: probability inputs (pair with activation="softmax"),
    # one-hot OR integer targets (CategoricalCrossEntropy takes both)
    "categorical_crossentropy": nn.CategoricalCrossEntropy,
    "sparse_categorical_crossentropy": nn.CategoricalCrossEntropy,
    "mse": nn.MSECriterion, "mean_squared_error": nn.MSECriterion,
    "mae": nn.AbsCriterion, "mean_absolute_error": nn.AbsCriterion,
    "binary_crossentropy": nn.BCECriterion,
    "hinge": nn.MarginCriterion,
    # Keras kld takes PROBABILITY predictions
    "kld": nn.KullbackLeiblerDivergenceCriterion,
    "kullback_leibler_divergence": nn.KullbackLeiblerDivergenceCriterion,
}

_METRICS = {
    "accuracy": optim.Top1Accuracy, "acc": optim.Top1Accuracy,
    "top5": optim.Top5Accuracy,
    "mae": optim.MAE,
    "loss": optim.Loss,
}


def _resolve(table, value, kind):
    if isinstance(value, str):
        try:
            return table[value.lower()]()
        except KeyError:
            raise ValueError(f"unknown {kind} {value!r}") from None
    return value


class _Topology:
    """Shared compile/fit/evaluate/predict machinery."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.optim_method = None
        self.criterion = None
        self.metrics: Sequence = ()
        self.device = "cuda"
        self.optimizer = None

    # ------------------------------------------------------------ compile
    def compile(self, optimizer: Union[str, Any], loss: Union[str, Any],
                metrics: Optional[Sequence] = None,
                device=None) -> "_Topology":
        """Resolve the optimizer, loss and metrics by name (or take the
        objects); ``device`` is where later calls run."""
        self.optim_method = _resolve(_OPTIMIZERS, optimizer, "optimizer")
        self.criterion = _resolve(_LOSSES, loss, "loss")
        if isinstance(self.criterion, type):
            self.criterion = self.criterion()
        self.metrics = [_resolve(_METRICS, m, "metric")
                        for m in (metrics or [])]
        if device is not None:
            self.device = device
        return self

    # ---------------------------------------------------------- core hook
    def core_module(self) -> torch.nn.Module:
        raise NotImplementedError

    @staticmethod
    def _to_dataset(x, y, batch_size, drop_remainder=True):
        x = np.asarray(x)
        y = None if y is None else np.asarray(y)
        samples = [Sample(x[i], None if y is None else y[i])
                   for i in range(len(x))]
        return DataSet.array(samples) >> SampleToMiniBatch(
            batch_size, drop_remainder=drop_remainder)

    # ---------------------------------------------------------------- fit
    def fit(self, x, y, batch_size: int = 32, nb_epoch: int = 10,
            validation_data: Optional[Tuple] = None,
            distributed: bool = False, device=None) -> "_Topology":
        """Train the core module in place; the last epoch's validation
        (with ``validation_data``) scores the compiled metrics."""
        if self.criterion is None:
            raise RuntimeError("call compile(...) before fit(...)")
        if device is not None:
            self.device = device
        model = self.core_module()
        train_set = self._to_dataset(x, y, batch_size)
        cls = optim.DistriOptimizer if distributed else optim.LocalOptimizer
        optimizer = (cls(model, train_set, self.criterion,
                         device=resolve_device(self.device))
                     .set_optim_method(self.optim_method)
                     .set_end_when(optim.max_epoch(nb_epoch)))
        if validation_data is not None:
            vx, vy = validation_data
            val_set = self._to_dataset(vx, vy, batch_size,
                                       drop_remainder=False)
            optimizer.set_validation(
                optim.every_epoch(), val_set,
                self.metrics or [optim.Loss(self.criterion)])
        optimizer.optimize()
        self.optimizer = optimizer  # the last fit's (state: loss, epoch)
        return self

    # ----------------------------------------------------------- evaluate
    def evaluate(self, x, y, batch_size: int = 32) -> dict:
        """``{metric name: value}`` (the loss when no metric was
        compiled)."""
        val_set = self._to_dataset(x, y, batch_size, drop_remainder=False)
        ev = Evaluator(self.core_module(), device=self.device)
        methods = self.metrics or [optim.Loss(self.criterion)]
        results = ev.evaluate(val_set, methods)
        return {name: r.result for name, r in results.items()}

    # ------------------------------------------------------------ predict
    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        pred = Predictor(self.core_module(), batch_size=batch_size,
                         device=self.device)
        return pred.predict(np.asarray(x))

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        return np.argmax(self.predict(x, batch_size), axis=-1)


class Sequential(_Topology):
    """Keras Sequential: a stack of deferred layers."""

    def __init__(self, layers: Optional[Sequence[KerasLayer]] = None,
                 name: Optional[str] = None):
        super().__init__(name)
        self.layers: list = []
        self._core: Optional[nn.Sequential] = None
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: KerasLayer) -> "Sequential":
        if not self.layers and layer.input_shape is None:
            raise ValueError(
                "first layer needs input_shape= (Keras 1.2 convention)")
        self.layers.append(layer)
        self._core = None  # invalidate the built core
        return self

    def build(self) -> nn.Sequential:
        shape = self.layers[0].input_shape
        core = nn.Sequential()
        for layer in self.layers:
            if layer.input_shape is not None:
                shape = layer.input_shape
            mod = layer.build(shape)
            shape = infer_output_shape(mod, shape)
            core.add(mod)
        self._core = core.initialize(0)
        return self._core

    def core_module(self) -> nn.Sequential:
        if self._core is None:
            self.build()
        return self._core

    @property
    def output_shape(self) -> Tuple[int, ...]:
        shape = self.layers[0].input_shape
        for layer in self.layers:
            shape = layer.output_shape(shape)
        return (None,) + tuple(shape)


class Model(_Topology):
    """Keras functional ``Model``: wraps an already-built core module or
    ``nn.Graph``."""

    def __init__(self, module: torch.nn.Module, name: Optional[str] = None):
        super().__init__(name)
        self._core = module

    def core_module(self) -> torch.nn.Module:
        return self._core

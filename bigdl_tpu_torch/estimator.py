"""DataFrame-free Estimator/Transformer facade (port of
``bigdl_tpu/estimator.py``).

``NNEstimator.fit(features, labels)`` trains through ``LocalOptimizer``
(or ``DistriOptimizer``) and returns an ``NNModel`` whose ``transform``
predicts through ``Predictor``: the scikit-learn-shaped contract the
Spark-ML API itself imitates.  Features and labels are array-likes or an
``AbstractDataSet``.  Every class takes ``device=`` ("cuda" by default,
"cpu" only when asked) and hands it to the optimizer and the predictor.
Class ids are 0-based, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.engine import resolve_device
from bigdl_tpu_torch.optim.predictor import Predictor


class NNModel:
    """A fitted transformer: batched forward over features."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 128,
                 device="cuda"):
        self.model = model
        self.batch_size = batch_size
        self._predictor = Predictor(model, batch_size=batch_size,
                                    device=device)

    def transform(self, features) -> np.ndarray:
        return self._predictor.predict(np.asarray(features))

    def set_batch_size(self, n: int) -> "NNModel":
        self.batch_size = n
        self._predictor.batch_size = n
        return self


class NNClassifierModel(NNModel):
    """Classifier variant: ``transform`` returns 0-based class ids (the
    argmax of the model's output)."""

    def transform(self, features) -> np.ndarray:
        return np.argmax(super().transform(features), axis=-1)


class NNEstimator:
    """An unfitted estimator: model, criterion and the training knobs."""

    model_cls = NNModel

    def __init__(self, model: torch.nn.Module, criterion: nn.Criterion,
                 batch_size: int = 32, max_epoch: int = 10,
                 optim_method: Optional[optim.OptimMethod] = None,
                 distributed: bool = False, device="cuda"):
        self.model = model
        self.criterion = criterion
        self.batch_size = batch_size
        self.max_epoch = max_epoch
        self.optim_method = optim_method or optim.SGD(learning_rate=0.01)
        self.distributed = distributed
        self.device = resolve_device(device)
        self.validation: Optional[tuple] = None
        self.end_when: Optional[optim.Trigger] = None

    # ---------------------------------------------------------- builders
    def set_batch_size(self, n: int) -> "NNEstimator":
        self.batch_size = n
        return self

    def set_max_epoch(self, n: int) -> "NNEstimator":
        self.max_epoch = n
        return self

    def set_optim_method(self, m: optim.OptimMethod) -> "NNEstimator":
        self.optim_method = m
        return self

    def set_end_when(self, trigger: optim.Trigger) -> "NNEstimator":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: optim.Trigger, features, labels,
                       methods: Sequence[optim.ValidationMethod],
                       batch_size: Optional[int] = None) -> "NNEstimator":
        self.validation = (trigger, features, labels,
                           list(methods), batch_size or self.batch_size)
        return self

    # --------------------------------------------------------------- fit
    def _to_dataset(self, features, labels, batch_size,
                    drop_remainder=True) -> AbstractDataSet:
        if isinstance(features, AbstractDataSet):
            return features
        f = np.asarray(features)
        lab = None if labels is None else np.asarray(labels)
        samples = [Sample(f[i], None if lab is None else lab[i])
                   for i in range(len(f))]
        return DataSet.array(samples) >> SampleToMiniBatch(
            batch_size, drop_remainder=drop_remainder)

    def _optimizer(self, train_set):
        cls = (optim.DistriOptimizer if self.distributed
               else optim.LocalOptimizer)
        return cls(self.model, train_set, self.criterion,
                   device=self.device)

    def fit(self, features, labels=None) -> NNModel:
        """Train and return the fitted model's transformer."""
        train_set = self._to_dataset(features, labels, self.batch_size)
        optimizer = (self._optimizer(train_set)
                     .set_optim_method(self.optim_method)
                     .set_end_when(self.end_when
                                   or optim.max_epoch(self.max_epoch)))
        if self.validation is not None:
            trig, vf, vl, methods, vbs = self.validation
            val_set = self._to_dataset(vf, vl, vbs, drop_remainder=False)
            optimizer.set_validation(trig, val_set, methods)
        optimizer.optimize()
        return self.model_cls(self.model, batch_size=self.batch_size,
                              device=self.device)


class NNClassifier(NNEstimator):
    """Classification estimator; ``ClassNLLCriterion`` by default."""

    model_cls = NNClassifierModel

    def __init__(self, model: torch.nn.Module,
                 criterion: Optional[nn.Criterion] = None, **kw):
        super().__init__(model, criterion or nn.ClassNLLCriterion(), **kw)

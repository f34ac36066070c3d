"""One-call Keras-model surface over import and training (port of
``bigdl_tpu/keras/backend.py``).

``KerasModelWrapper`` glues the Keras-1.2 importer
(``interop/keras_format.py``: JSON definition and HDF5 weights) to the
Keras-style topology's compile/fit/evaluate/predict, so a model exported
from Keras trains and serves with one construction call::

    m = KerasModelWrapper("model.json", "weights.h5", optimizer="adam",
                          loss="categorical_crossentropy", device="cuda")
    m.fit(x, y, nb_epoch=2)
    m.evaluate(x, y)
    m.predict(x)

Without a ``loss`` the model is import-only until :meth:`compile`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


class KerasModelWrapper:
    """Import, then train, evaluate and predict, in one object."""

    def __init__(self, json_path: str, hdf5_path: Optional[str] = None,
                 optimizer: Union[str, object] = "sgd",
                 loss: Union[str, object, None] = None,
                 metrics: Optional[Sequence] = None, device="cuda"):
        from bigdl_tpu_torch.interop.keras_format import (
            load_keras_hdf5_weights, load_keras_json)
        self.bmodel = load_keras_json(json_path)
        self.bmodel.device = device
        if hdf5_path is not None:
            load_keras_hdf5_weights(self.bmodel, hdf5_path)
        if loss is not None:
            self.bmodel.compile(optimizer, loss, metrics)

    def compile(self, optimizer, loss, metrics=None,
                device=None) -> "KerasModelWrapper":
        self.bmodel.compile(optimizer, loss, metrics, device=device)
        return self

    def fit(self, x, y, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = False
            ) -> "KerasModelWrapper":
        if y is None:
            raise ValueError("fit() needs labels y")
        self.bmodel.fit(x, y, batch_size=batch_size, nb_epoch=nb_epoch,
                        validation_data=validation_data,
                        distributed=distributed)
        return self

    def evaluate(self, x, y, batch_size: int = 32) -> dict:
        return self.bmodel.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: int = 32) -> np.ndarray:
        return self.bmodel.predict(x, batch_size=batch_size)

    def predict_classes(self, x, batch_size: int = 32) -> np.ndarray:
        return self.bmodel.predict_classes(x, batch_size=batch_size)

    def set_weights(self, weights) -> "KerasModelWrapper":
        """Install a flat Keras-order weight list (each layer's
        ``get_weights()`` concatenated)."""
        from bigdl_tpu_torch.interop.keras_format import set_keras_weights
        set_keras_weights(self.bmodel, list(weights))
        return self


def load_model(json_path: str, hdf5_path: Optional[str] = None,
               **compile_kw) -> KerasModelWrapper:
    """A :class:`KerasModelWrapper` of a file-exported model."""
    return KerasModelWrapper(json_path, hdf5_path, **compile_kw)

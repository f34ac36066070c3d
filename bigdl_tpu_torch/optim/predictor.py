"""Inference path: Predictor, Evaluator, PredictionService (port of
``bigdl_tpu/optim/predictor.py``).

Every entry point takes ``device=`` ("cuda" by default, "cpu" only when
asked), moves the model there and runs it in eval mode under
``torch.inference_mode()``.  Inputs and outputs are host numpy arrays.

Padding invariant, shared with the serving engine (``leading_rows`` and
``pad_rows`` are its helpers): a trailing partial batch is padded with
ZERO rows up to the steady batch and the pad outputs are sliced off, so
one batch shape reaches the model per ``predict``.  This is sound because
the forward runs in eval mode: BatchNorm reads its running statistics and
dropout is off, so a pad row cannot perturb a real row.

``PredictionService`` is the back-compat shim over
:class:`~bigdl_tpu_torch.serving.InferenceService`, which coalesces
concurrent callers into one bucket-padded dispatch.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import _node, tree_map
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, batch_samples
from bigdl_tpu_torch.engine import resolve_device
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult,
                                              validation_sums)
from bigdl_tpu_torch.serving.service import leading_rows, pad_rows


def _has_coo(x) -> bool:
    from bigdl_tpu_torch.nn.sparse import COOBatch
    if isinstance(x, COOBatch):
        return True
    node = _node(x)
    return node is not None and any(_has_coo(k) for k in node[2])


class Predictor:
    """Batched forward inference over a dataset or a list of samples.

    ``input_spec`` (optional): per-row ``(shape, dtype)`` of one sample
    (or a tree of them), so that :meth:`predict` of an empty dataset
    returns an empty array with the model's trailing output dims instead
    of a rank-less ``(0,)``."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 128,
                 input_spec=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.input_spec = input_spec
        self._rows_track: Optional[bool] = None  # probed at the first tail

    def _forward(self, x) -> np.ndarray:
        """One forward of a host batch (a tree of numpy arrays or CPU
        tensors, ``COOBatch`` es included) on the device."""
        dev = self.device

        def to_dev(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.to(dev)

        with torch.inference_mode():
            out = self.model(tree_map(to_dev, x))
            return out.cpu().numpy()

    def _rows_track_input(self, x) -> bool:
        """Do the output rows follow the input rows?  Forwards of zeros at
        2 and 3 rows with ``x``'s trailing shapes: both must return as
        many rows as they took.  A model that raises on them is treated
        as not row-tracking."""
        try:
            for k in (2, 3):
                probe = tree_map(
                    lambda a: np.zeros((k,) + tuple(a.shape[1:]),
                                       np.asarray(a).dtype), x)
                if self._forward(probe).shape[:1] != (k,):
                    return False
            return True
        except Exception:  # probe shapes unsupported: be conservative
            return False

    def _iter_batches(self, data):
        if isinstance(data, AbstractDataSet):
            for b in data.data(train=False):
                if not isinstance(b, MiniBatch):
                    raise TypeError(
                        "DataSet must yield MiniBatch for predict; attach "
                        "SampleToMiniBatch or pass a list of Samples")
                yield b
            return
        buf = []
        for s in data:
            buf.append(s if isinstance(s, Sample) else Sample(np.asarray(s)))
            if len(buf) == self.batch_size:
                yield batch_samples(buf)
                buf = []
        if buf:
            yield batch_samples(buf)

    def _empty_result(self) -> np.ndarray:
        """An empty input's output: ``(0,) + the model's trailing dims``
        from a one-row forward of zeros when an ``input_spec`` was given,
        else ``(0,)``."""
        if self.input_spec is None:
            return np.empty((0,))
        from bigdl_tpu_torch.serving.service import InferenceService
        row = InferenceService._normalize_row_spec(self.input_spec)
        x = tree_map(lambda s: np.zeros((1,) + tuple(s.shape), s.dtype),
                     row)
        out = self._forward(x)
        return np.empty((0,) + out.shape[1:], out.dtype)

    def predict(self, data) -> np.ndarray:
        """``data``: a dataset yielding MiniBatches, or an iterable of
        Samples or arrays.  Returns the stacked outputs.  A trailing
        partial batch is zero-padded to the first batch's rows and the
        pad rows are cut, when the model's output rows follow its input
        rows (probed once); a COO input is dispatched as it is."""
        outs = []
        steady = None  # rows of the first (steady-state) batch
        for batch in self._iter_batches(data):
            x = batch.input
            if _has_coo(x):
                outs.append(self._forward(x))
                continue
            try:
                n = leading_rows(x)
            except ValueError:  # heterogeneous leading dims: as it is
                outs.append(self._forward(x))
                continue
            if steady is None:
                steady = n
            if n < steady:
                if self._rows_track is None:
                    self._rows_track = self._rows_track_input(x)
                if self._rows_track:
                    outs.append(self._forward(pad_rows(x, steady))[:n])
                    continue
            outs.append(self._forward(x))
        if not outs:
            return self._empty_result()
        return np.concatenate(outs, axis=0)

    def predict_class(self, data) -> np.ndarray:
        """Argmax over the last dim: 0-based class ids."""
        return np.argmax(self.predict(data), axis=-1)


class Evaluator:
    """Validation methods over a dataset: ``{method name:
    ValidationResult}``, through the loop ``Optimizer.evaluate_with``
    runs (:func:`~bigdl_tpu_torch.optim.validation.validation_sums`)."""

    def __init__(self, model: torch.nn.Module, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def evaluate(self, dataset: AbstractDataSet,
                 methods: Sequence[ValidationMethod]) -> dict:
        sums, counts = validation_sums(self.model, dataset, methods)
        return {k: ValidationResult(float(v), counts[k])
                for k, v in sums.items()}


class PredictionService:
    """Thread-safe always-on inference endpoint: the back-compat shim
    over :class:`~bigdl_tpu_torch.serving.InferenceService`, keeping the
    historical constructor, the blocking ``predict`` and
    ``request_count``.  New code should use ``InferenceService``."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 32,
                 device="cuda", **service_kw):
        from bigdl_tpu_torch.serving import InferenceService
        self.batch_size = batch_size
        self._stats_lock = threading.Lock()
        self.request_count = 0  # guarded-by: _stats_lock
        # timeout 0 = adaptive batching: a lone sequential caller is not
        # taxed with a coalescing wait, while whatever queued during the
        # previous dispatch still forms the next group
        service_kw.setdefault("batch_timeout_ms", 0.0)
        self.service = InferenceService(
            model, max_batch_size=batch_size, name="PredictionService",
            device=device, **service_kw)
        self.model = self.service.model

    def predict(self, features) -> np.ndarray:
        """``features``: (n, ...) with any n >= 1, coerced by
        ``np.asarray`` (list-of-lists inputs keep working).  A transient
        ``ServiceOverloaded`` gets ONE bounded retry after the exception's
        own ``retry_after_ms``; a second rejection propagates."""
        from bigdl_tpu_torch.serving import ServiceOverloaded
        x = np.asarray(features)
        try:
            out = self.service.predict(x)
        except ServiceOverloaded as e:
            wait_ms = e.retry_after_ms if e.retry_after_ms is not None \
                else 10.0
            time.sleep(min(wait_ms, 1000.0) / 1e3)
            out = self.service.predict(x)  # a second rejection propagates
        with self._stats_lock:
            self.request_count += 1
        return out

    def stats(self) -> dict:
        return self.service.stats()

    def stop(self, drain: bool = True) -> None:
        self.service.stop(drain=drain)

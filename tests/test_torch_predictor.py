"""``Predictor``, ``Evaluator`` and ``PredictionService`` of the port
(``optim/predictor.py``) on the CPU against the reference's.

Weights are drawn in the port and carried to the reference with
``to_jax_params``.  Predictions are held within ``rtol=1e-5,
atol=1e-5*max|y|`` (f32 convolutions summed in another order); the port's
padded tail is held BITWISE against its own forward of the same padded
batch, the one shape that reaches the model (cross-shape bitwise claims
fail on this toolchain, as the reference's own serving tests show).
``Evaluator``'s ``ValidationResult`` s: counts equal, values within
``rtol=1e-5``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu import dataset as jdataset  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu.nn import sparse as jsparse  # noqa: E402
from bigdl_tpu.optim import predictor as jpred  # noqa: E402
from bigdl_tpu_torch import dataset as tdataset  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.nn import sparse as tsparse  # noqa: E402
from bigdl_tpu_torch.optim import (Evaluator, PredictionService,  # noqa: E402
                                   Predictor)
from bigdl_tpu_torch.serving.service import pad_rows  # noqa: E402


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def lenets():
    """(port LeNet-5, reference LeNet-5, its params, state)."""
    port = lenet5(10).initialize(3)
    params, state = to_jax_params(port)
    return port, jax_lenet5(10), params, state


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 1, 28, 28)).astype(np.float32)


def _ref_predictor(lenets, **kw):
    _, jm, params, state = lenets
    return jpred.Predictor(jm, params=params, state=state, **kw)


@pytest.mark.parametrize("n", [37, 32, 5], ids=["tail", "whole", "short"])
def test_predict_matches_reference(lenets, n):
    x = _images(n)
    got = Predictor(lenets[0], batch_size=16, device="cpu").predict(x)
    _close(got, _ref_predictor(lenets, batch_size=16).predict(x))


def test_padded_tail_is_the_models_own_padded_forward(lenets):
    """The 5-row tail reaches the model zero-padded to the steady 16 rows:
    its rows equal the model's forward of that padded batch, bitwise, and
    the full batches equal the model's forward of them."""
    x = _images(37, seed=1)
    pred = Predictor(lenets[0], batch_size=16, device="cpu")
    got = pred.predict(x)
    assert pred._rows_track is True
    model = lenets[0]
    with torch.no_grad():
        for lo in (0, 16):
            assert torch.equal(torch.from_numpy(got[lo:lo + 16]),
                               model(torch.from_numpy(x[lo:lo + 16])))
        tail = model(torch.from_numpy(pad_rows(x[32:], 16)))[:5]
    assert torch.equal(torch.from_numpy(got[32:]), tail)


def test_predict_class_and_samples(lenets):
    x = _images(21, seed=2)
    samples = [tdataset.Sample(r) for r in x]
    pred = Predictor(lenets[0], batch_size=8, device="cpu")
    want = _ref_predictor(lenets, batch_size=8).predict_class(x)
    assert np.array_equal(pred.predict_class(samples), want)


def test_dataset_of_minibatches(lenets):
    x = _images(21, seed=3)
    y = np.arange(21, dtype=np.int32) % 10
    tds = tdataset.DataSet.array([tdataset.Sample(a, b) for a, b in
                                  zip(x, y)]) >> tdataset.SampleToMiniBatch(
        8, drop_remainder=False)
    jds = jdataset.DataSet.array([jdataset.Sample(a, b) for a, b in
                                  zip(x, y)]) >> jdataset.SampleToMiniBatch(
        8, drop_remainder=False)
    _close(Predictor(lenets[0], device="cpu").predict(tds),
           _ref_predictor(lenets).predict(jds))
    with pytest.raises(TypeError, match="MiniBatch"):
        Predictor(lenets[0], device="cpu").predict(
            tdataset.DataSet.array([tdataset.Sample(a) for a in x]))


def test_empty_dataset_takes_its_shape_from_the_input_spec(lenets):
    spec = ((1, 28, 28), np.float32)
    got = Predictor(lenets[0], input_spec=spec, device="cpu").predict([])
    want = _ref_predictor(lenets, input_spec=spec).predict([])
    assert got.shape == want.shape == (0, 10) and got.dtype == want.dtype
    assert Predictor(lenets[0], device="cpu").predict([]).shape == (0,)


def test_rows_that_do_not_follow_the_input_skip_the_padding():
    """A model whose output rows do not follow its input rows (a sum over
    the batch): the probe says so and the tail goes as it is, as in the
    reference."""
    port = nn.Sequential(nn.Linear(4, 3)).initialize(0)
    summed = nn.Sequential(port, nn.Lambda(lambda x: x.sum(0, keepdim=True)))
    x = np.random.default_rng(4).normal(0, 1, (10, 4)).astype(np.float32)
    pred = Predictor(summed, batch_size=4, device="cpu")
    got = pred.predict(x)
    assert pred._rows_track is False and got.shape == (3, 3)
    with torch.no_grad():
        want = [port(torch.from_numpy(x[i:i + 4])).sum(0, keepdim=True)
                for i in (0, 4, 8)]
    assert torch.equal(torch.from_numpy(got), torch.cat(want))


def test_sparse_minibatch_dispatched_as_is():
    """SparseMiniBatch inputs (a COO batch and a dense part, leading dims
    nnz and N) go to the model as they are; ``SparseLinear`` over them
    matches the reference's ``Predictor`` (its COO product in the Pallas
    interpreter: bitwise, as ``tests/test_torch_sparse.py`` holds)."""
    width, rows = 30, 7

    def samples(mod, seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(rows):
            k = int(rng.integers(1, 5))
            idx = rng.choice(width, k, replace=False).astype(np.int32)
            out.append(mod.SparseSample(idx, rng.normal(0, 1, k), width))
        return out

    tm = tsparse.SparseLinear(width, 3).initialize(5)
    jm = jsparse.SparseLinear(width, 3, impl="pallas")
    params, _ = to_jax_params(tm)

    def dataset(mod):
        class Batches(mod.AbstractDataSet):
            def __init__(self):
                self.batches = [mod.batch_sparse_samples(samples(mod, s))
                                for s in (0, 1)]

            def data(self, train=False):
                return iter(self.batches)

            def size(self):
                return rows * len(self.batches)
        return Batches()

    got = Predictor(tm, device="cpu").predict(dataset(tdataset))
    want = jpred.Predictor(jm, params=params, state={}).predict(
        dataset(jdataset))
    assert got.shape == (2 * rows, 3)
    np.testing.assert_array_equal(got, np.asarray(want))


METHODS = {
    "Top1Accuracy": lambda m: m.Top1Accuracy(),
    "Top5Accuracy": lambda m: m.Top5Accuracy(),
    "Loss": lambda m: m.Loss(),
}


def test_evaluator_matches_reference(lenets):
    x = _images(45, seed=6)
    y = (np.arange(45) * 7 % 10).astype(np.int32)

    def ds(mod):
        return mod.DataSet.array([mod.Sample(a, b) for a, b in zip(x, y)]) \
            >> mod.SampleToMiniBatch(16, drop_remainder=False)

    got = Evaluator(lenets[0], device="cpu").evaluate(
        ds(tdataset), [f(optim) for f in METHODS.values()])
    _, jm, params, state = lenets
    want = jpred.Evaluator(jm, params=params, state=state).evaluate(
        ds(jdataset), [f(joptim) for f in METHODS.values()])
    assert list(got) == list(want) == list(METHODS)
    for k in METHODS:
        assert got[k].count == want[k].count == 45
        np.testing.assert_allclose(got[k].value, want[k].value, rtol=1e-5)


def test_evaluator_runs_evaluate_withs_loop(lenets):
    """``Evaluator`` and ``LocalOptimizer.evaluate_with`` are one loop:
    the same results, bitwise."""
    x = _images(40, seed=7)
    y = (np.arange(40) % 10).astype(np.int32)
    val = tdataset.DataSet.array([tdataset.Sample(a, b) for a, b in
                                  zip(x, y)]) >> tdataset.SampleToMiniBatch(
        16, drop_remainder=False)
    methods = [f(optim) for f in METHODS.values()]
    opt = optim.LocalOptimizer(lenets[0], val, nn.ClassNLLCriterion(),
                               device="cpu")
    opt.set_validation(optim.every_epoch(), val, methods)
    via_optimizer = opt.evaluate_with(lenets[0])
    via_evaluator = Evaluator(lenets[0], device="cpu").evaluate(val, methods)
    for k in METHODS:
        assert via_optimizer[k].value == via_evaluator[k].value
        assert via_optimizer[k].count == via_evaluator[k].count
    assert Evaluator(lenets[0], device="cpu").evaluate(
        tdataset.DataSet.array([]), methods) == {}


def test_prediction_service_matches_reference(lenets):
    port, jm, params, state = lenets
    svc = PredictionService(port, batch_size=4, device="cpu")
    jsvc = jpred.PredictionService(jm, params=params, state=state,
                                   batch_size=4)
    try:
        for n in (1, 3, 9):
            x = _images(n, seed=10 + n)
            _close(svc.predict(x), jsvc.predict(x))
        assert svc.request_count == jsvc.request_count == 3
        assert svc.stats()["model"] == "PredictionService"
        assert svc.service.batch_timeout_ms == 0.0
    finally:
        svc.stop()
        jsvc.stop()


def test_prediction_service_retries_overload_once(lenets, monkeypatch):
    from bigdl_tpu_torch.serving import ServiceOverloaded
    svc = PredictionService(lenets[0], batch_size=4, device="cpu")
    real = svc.service.predict
    calls = []

    def flaky(x, *a, **kw):
        calls.append(len(x))
        if len(calls) == 1:
            raise ServiceOverloaded(4, 4, retry_after_ms=1.0)
        return real(x, *a, **kw)

    try:
        monkeypatch.setattr(svc.service, "predict", flaky)
        assert svc.predict(_images(2)).shape == (2, 10)
        assert len(calls) == 2 and svc.request_count == 1

        def always(x, *a, **kw):
            raise ServiceOverloaded(4, 4, retry_after_ms=1.0)

        monkeypatch.setattr(svc.service, "predict", always)
        with pytest.raises(ServiceOverloaded):
            svc.predict(_images(1))
        assert svc.request_count == 1
    finally:
        svc.stop()


def test_entry_points_default_to_the_card(lenets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    for make in (lambda: Predictor(lenets[0]), lambda: Evaluator(lenets[0]),
                 lambda: PredictionService(lenets[0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()

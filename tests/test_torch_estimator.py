"""The estimator facade of the port (``estimator.py``: ``NNModel``,
``NNClassifierModel``, ``NNEstimator``, ``NNClassifier``) on the CPU
against the reference's.

Both packages start from the same weights (drawn in the port, carried
with ``to_jax_params``) and see the same data in the same order (both
shuffles are numpy, ``default_rng((seed, epoch))``).  The fitted models'
outputs are held within ``rtol=1e-4, atol=1e-4*max|y|`` (a few SGD or
Adam steps over f32 sums in another order, as ``test_torch_lenet.py``
holds LeNet's trained weights); class ids equal wherever the CPU's top
two log-probabilities lie more than 1e-3 apart.  The reference's own
estimator cases (``tests/test_keras_estimator.py::TestEstimator``) are
ported as the ``FITS`` parametrization.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import estimator as jest  # noqa: E402
from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu_torch import estimator as port_est  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import mnist  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402


def _blobs(n=256, d=8, classes=3, seed=0):
    """The reference estimator tests' linearly separable blobs."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 4
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def _regression(n=256):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    w = np.array([[1.0], [-2.0], [0.5], [3.0]], np.float32)
    return x, x @ w


def _mnist(n=64):
    imgs, labels = mnist.synthetic_mnist(n, seed=3)
    x = ((imgs.reshape(-1, 1, 28, 28).astype(np.float32))
         - mnist.TRAIN_MEAN) / mnist.TRAIN_STD
    return x, labels.astype(np.int32)


# name: (port model, reference model, data, estimator kind, kwargs of both
# constructors but the optim method, the optim method's class and args)
FITS = {
    "classifier_blobs": (
        lambda m: m.Sequential(m.Linear(8, 3), m.LogSoftMax()),
        lambda m: m.Sequential(m.Linear(8, 3), m.LogSoftMax()),
        _blobs, "NNClassifier", dict(batch_size=32, max_epoch=3),
        ("SGD", dict(learning_rate=0.1))),
    "estimator_regression": (
        lambda m: m.Linear(4, 1), lambda m: m.Linear(4, 1), _regression,
        "NNEstimator", dict(batch_size=32, max_epoch=3),
        ("SGD", dict(learning_rate=0.05))),
    "lenet_classifier": (
        lambda m: lenet5(10), lambda m: jax_lenet5(10), _mnist,
        "NNClassifier", dict(batch_size=16, max_epoch=2),
        ("SGD", dict(learning_rate=0.05, momentum=0.9))),
    "mse_regression_adam": (
        lambda m: m.Linear(2, 2), lambda m: m.Linear(2, 2),
        lambda: (np.random.RandomState(0).rand(128, 2).astype(np.float32),
                 (np.random.RandomState(0).rand(128, 2) @ np.asarray(
                     [[2.0, -1.0], [0.5, 1.5]])).astype(np.float32)),
        "NNEstimator", dict(batch_size=32, max_epoch=3),
        ("Adam", dict(learning_rate=0.05))),
}


def _fit_both(name, validation=False):
    make_t, make_j, data, kind, kw, (method, margs) = FITS[name]
    x, y = data()
    tm = make_t(nn).initialize(7)
    params, state = to_jax_params(tm)
    jm = make_j(jnn)
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = jax.tree_util.tree_map(jnp.asarray, state)
    crit = ({} if kind == "NNClassifier" else
            {"criterion": nn.MSECriterion()})
    jcrit = ({} if kind == "NNClassifier" else
             {"criterion": jnn.MSECriterion()})
    test = getattr(port_est, kind)(tm, **crit, **kw, device="cpu",
                                optim_method=getattr(optim, method)(**margs))
    ref = getattr(jest, kind)(jm, **jcrit, **kw,
                              optim_method=getattr(joptim, method)(**margs))
    if validation:
        test.set_validation(optim.every_epoch(), x[:40], y[:40],
                            [optim.Top1Accuracy()], batch_size=16)
        ref.set_validation(joptim.every_epoch(), x[:40], y[:40],
                           [joptim.Top1Accuracy()], batch_size=16)
    return test.fit(x, y), ref.fit(x, y), x, tm


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_and_transform_match_reference(name):
    tfit, jfit, x, tm = _fit_both(name)
    kind = FITS[name][3]
    assert isinstance(tfit, port_est.NNClassifierModel
                      if kind == "NNClassifier" else port_est.NNModel)
    raw_t = tfit._predictor.predict(x)
    raw_j = jfit._predictor.predict(x)
    _close(raw_t, raw_j)
    got, want = tfit.transform(x), np.asarray(jfit.transform(x))
    assert got.shape == want.shape
    if kind == "NNClassifier":
        top = np.sort(np.asarray(raw_j), axis=-1)
        clear = top[:, -1] - top[:, -2] > 1e-3
        assert np.array_equal(got[clear], want[clear])
        assert got.dtype.kind == "i"


def test_fit_with_validation_matches_reference():
    tfit, jfit, x, _ = _fit_both("classifier_blobs", validation=True)
    _close(tfit._predictor.predict(x), jfit._predictor.predict(x))


def test_setters_and_defaults():
    m = nn.Sequential(nn.Linear(8, 3), nn.LogSoftMax()).initialize(0)
    clf = port_est.NNClassifier(m, device="cpu")
    assert isinstance(clf.criterion, nn.ClassNLLCriterion)
    assert isinstance(clf.optim_method, optim.SGD)
    assert clf.optim_method.learning_rate == 0.01
    assert (clf.batch_size, clf.max_epoch) == (32, 10)
    assert clf.set_batch_size(8).set_max_epoch(2) is clf
    trig = optim.max_iteration(3)
    assert clf.set_end_when(trig).end_when is trig
    x, y = _blobs(64)
    fitted = clf.fit(x, y).set_batch_size(5)
    assert fitted._predictor.batch_size == 5
    assert fitted.transform(x).shape == (64,)
    est = port_est.NNEstimator(m, nn.MSECriterion(), device="cpu")
    assert est.model_cls is port_est.NNModel
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_est.NNClassifier(m)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_est.NNModel(m)

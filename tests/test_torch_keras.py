"""The Keras surface of the port (``keras/``: ``layers``, ``topology``,
``backend``) on the CPU against the reference's.

- Every Keras-1.2 layer of the reference's ``keras/layers.py`` (``LAYERS``,
  several forms of most): the port's shape inference gives the
  reference's output shape, and the built module, its weights drawn in the
  port and carried across with ``to_jax_params`` (BatchNorm statistics
  drawn too), gives the reference's output within ``rtol=1e-5,
  atol=1e-5*max|y|``.
- ``Sequential.compile``/``fit``/``evaluate``/``predict`` from the same
  weights and data order as the reference: the fitted predictions within
  ``rtol=1e-4, atol=1e-4*max|y|`` (a few f32 SGD steps), the metrics
  within 1e-4.
- The reference's own Keras cases (``tests/test_keras_estimator.py``,
  ``tests/test_keras_backend.py``) ported in ``REFERENCE_CASES``.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import keras as JK  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu_torch import keras as K  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _random_bn_stats(core, seed):
    rng = np.random.default_rng(seed)
    for m in core.modules():
        if isinstance(m, nn.SpatialBatchNormalization):
            for t, lo, hi in ((m.running_mean, -0.3, 0.3),
                              (m.running_var, 0.5, 2.0),
                              (m.weight, 0.5, 1.5), (m.bias, -0.3, 0.3)):
                t.data.copy_(torch.from_numpy(
                    rng.uniform(lo, hi, m.n_output).astype(np.float32)))
    return core


# name: (layers of either package, input shape, input kind)
LAYERS = {
    "Dense": (lambda k: [k.Dense(6, activation="relu",
                                 input_shape=(5,))], (5,), "f"),
    "Dense-input_dim-nobias": (lambda k: [k.Dense(4, bias=False,
                                                  input_dim=7)], (7,), "f"),
    "Activation": (lambda k: [k.Activation("tanh", input_shape=(5,))],
                   (5,), "f"),
    "Dropout": (lambda k: [k.Dropout(0.3, input_shape=(5,))], (5,), "f"),
    "Flatten": (lambda k: [k.Flatten(input_shape=(2, 3, 4))], (2, 3, 4),
                "f"),
    "Reshape": (lambda k: [k.Reshape((6, 4), input_shape=(2, 3, 4))],
                (2, 3, 4), "f"),
    "Convolution1D": (lambda k: [k.Convolution1D(
        4, 3, activation="tanh", subsample_length=2, input_shape=(9, 5))],
        (9, 5), "f"),
    "Convolution2D": (lambda k: [k.Convolution2D(
        4, 3, 3, activation="relu", input_shape=(3, 9, 9))], (3, 9, 9), "f"),
    "Convolution2D-same-stride": (lambda k: [k.Convolution2D(
        4, 2, 2, border_mode="same", subsample=(2, 2),
        input_shape=(3, 9, 8))], (3, 9, 8), "f"),
    "Convolution2D-tf": (lambda k: [k.Convolution2D(
        4, 3, 3, dim_ordering="tf", input_shape=(9, 9, 3))], (9, 9, 3), "f"),
    "MaxPooling2D": (lambda k: [k.MaxPooling2D(input_shape=(2, 8, 8))],
                     (2, 8, 8), "f"),
    "MaxPooling2D-same": (lambda k: [k.MaxPooling2D(
        (3, 3), (2, 2), border_mode="same", input_shape=(2, 7, 6))],
        (2, 7, 6), "f"),
    "MaxPooling2D-same-tf": (lambda k: [k.MaxPooling2D(
        (3, 3), (2, 2), border_mode="same", dim_ordering="tf",
        input_shape=(7, 6, 2))], (7, 6, 2), "f"),
    "AveragePooling2D": (lambda k: [k.AveragePooling2D(
        (2, 3), input_shape=(2, 8, 9))], (2, 8, 9), "f"),
    "AveragePooling2D-same": (lambda k: [k.AveragePooling2D(
        (2, 2), (2, 2), border_mode="same", input_shape=(2, 5, 5))],
        (2, 5, 5), "f"),
    "GlobalAveragePooling2D": (lambda k: [k.GlobalAveragePooling2D(
        input_shape=(3, 5, 4))], (3, 5, 4), "f"),
    "GlobalAveragePooling2D-tf": (lambda k: [k.GlobalAveragePooling2D(
        dim_ordering="tf", input_shape=(5, 4, 3))], (5, 4, 3), "f"),
    "GlobalMaxPooling2D": (lambda k: [k.GlobalMaxPooling2D(
        input_shape=(3, 5, 4))], (3, 5, 4), "f"),
    "ZeroPadding2D": (lambda k: [k.ZeroPadding2D(
        (1, 2), input_shape=(2, 3, 4))], (2, 3, 4), "f"),
    "ZeroPadding2D-tf": (lambda k: [k.ZeroPadding2D(
        (1, 2), dim_ordering="tf", input_shape=(3, 4, 2))], (3, 4, 2), "f"),
    "BatchNormalization-image": (lambda k: [k.BatchNormalization(
        input_shape=(3, 4, 5))], (3, 4, 5), "f"),
    "BatchNormalization-1d": (lambda k: [k.BatchNormalization(
        epsilon=1e-4, input_shape=(6,))], (6,), "f"),
    "Embedding": (lambda k: [k.Embedding(11, 4, input_length=7)], (7,), "i"),
    "SimpleRNN": (lambda k: [k.SimpleRNN(5, input_shape=(6, 3))], (6, 3),
                  "f"),
    "LSTM-sequences": (lambda k: [k.LSTM(5, return_sequences=True,
                                         input_shape=(6, 3))], (6, 3), "f"),
    "LSTM-backwards": (lambda k: [k.LSTM(5, go_backwards=True,
                                         input_shape=(6, 3))], (6, 3), "f"),
    "GRU": (lambda k: [k.GRU(5, input_shape=(6, 3))], (6, 3), "f"),
    "GRU-sequences": (lambda k: [k.GRU(5, return_sequences=True,
                                       input_shape=(6, 3))], (6, 3), "f"),
    "Bidirectional-LSTM": (lambda k: [k.Bidirectional(k.LSTM(
        4, input_shape=(5, 3)))], (5, 3), "f"),
    "Bidirectional-GRU-sum": (lambda k: [k.Bidirectional(
        k.GRU(4, return_sequences=True), merge_mode="sum",
        input_shape=(5, 3))], (5, 3), "f"),
    "TimeDistributed-Dense": (lambda k: [k.TimeDistributed(
        k.Dense(4, activation="tanh"), input_shape=(5, 3))], (5, 3), "f"),
    "InputLayer": (lambda k: [k.InputLayer(input_shape=(4,)),
                              k.Dense(2)], (4,), "f"),
    "RepeatVector": (lambda k: [k.RepeatVector(3, input_shape=(4,))], (4,),
                     "f"),
    "Permute": (lambda k: [k.Permute((2, 3, 1), input_shape=(2, 3, 4))],
                (2, 3, 4), "f"),
    "Cropping2D": (lambda k: [k.Cropping2D(((1, 0), (1, 2)),
                                           input_shape=(2, 6, 7))],
                   (2, 6, 7), "f"),
    "Cropping2D-tf": (lambda k: [k.Cropping2D(((1, 0), (1, 2)),
                                              dim_ordering="tf",
                                              input_shape=(6, 7, 2))],
                      (6, 7, 2), "f"),
    "UpSampling2D": (lambda k: [k.UpSampling2D((2, 3),
                                               input_shape=(2, 3, 4))],
                     (2, 3, 4), "f"),
    "UpSampling2D-tf": (lambda k: [k.UpSampling2D(
        (2, 3), dim_ordering="tf", input_shape=(3, 4, 2))], (3, 4, 2), "f"),
    "ZeroPadding1D": (lambda k: [k.ZeroPadding1D(2, input_shape=(5, 3))],
                      (5, 3), "f"),
    "MaxPooling1D": (lambda k: [k.MaxPooling1D(2, input_shape=(8, 3))],
                     (8, 3), "f"),
    "MaxPooling1D-stride": (lambda k: [k.MaxPooling1D(
        3, stride=2, input_shape=(9, 3))], (9, 3), "f"),
    "GlobalMaxPooling1D": (lambda k: [k.GlobalMaxPooling1D(
        input_shape=(6, 3))], (6, 3), "f"),
    "GlobalAveragePooling1D": (lambda k: [k.GlobalAveragePooling1D(
        input_shape=(6, 3))], (6, 3), "f"),
    "Highway": (lambda k: [k.Highway(input_shape=(5,))], (5,), "f"),
    "Highway-relu": (lambda k: [k.Highway(activation="relu",
                                          input_shape=(5,))], (5,), "f"),
    "MaxoutDense": (lambda k: [k.MaxoutDense(3, nb_feature=2,
                                             input_shape=(4,))], (4,), "f"),
    "SeparableConvolution2D": (lambda k: [k.SeparableConvolution2D(
        6, 3, 3, depth_multiplier=2, activation="relu",
        input_shape=(3, 7, 7))], (3, 7, 7), "f"),
    "mixed_stack": (lambda k: [
        k.Convolution2D(4, 3, 3, input_shape=(2, 8, 8), activation="relu"),
        k.UpSampling2D(), k.Cropping2D(((1, 1), (1, 1))),
        k.Permute((2, 3, 1)), k.Flatten(), k.MaxoutDense(6), k.Highway(),
        k.RepeatVector(3), k.GlobalAveragePooling1D(), k.Dense(2)],
        (2, 8, 8), "f"),
}


def _input(shape, kind, seed=0, n=3):
    rng = np.random.default_rng(seed)
    if kind == "i":
        return rng.integers(0, 11, (n,) + shape).astype(np.float32)
    return rng.normal(0, 1, (n,) + shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    make, shape, kind = LAYERS[name]
    tm, jm = K.Sequential(make(K)), JK.Sequential(make(JK))
    assert tm.output_shape == jm.output_shape
    core = _random_bn_stats(tm.core_module(), seed=1)
    core.initialize(2)
    _random_bn_stats(core, seed=1)
    params, state = to_jax_params(core)
    x = _input(shape, kind)
    want, _ = jm.core_module().apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x),
        training=False)
    core.eval()
    with torch.no_grad():
        got = core(torch.from_numpy(x)).numpy()
    assert got.shape[1:] == tuple(tm.output_shape[1:])
    _close(got, want)


@pytest.mark.parametrize("mode", ["sum", "mul", "max", "concat", "ave"])
def test_merge_matches_reference(mode):
    rng = np.random.default_rng(3)
    a, b = (rng.normal(0, 1, (2, 4)).astype(np.float32) for _ in range(2))
    got = K.Merge(mode=mode).build((4,))((torch.from_numpy(a),
                                          torch.from_numpy(b)))
    want, _ = JK.Merge(mode=mode).build((4,)).apply({}, {}, (a, b))
    _close(got.numpy(), want)


# ------------------------------------------------------------- topology
def _blobs(n=256, d=8, classes=3, seed=0):
    """The reference Keras tests' linearly separable blobs."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 4
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def _twins(make):
    """(port Sequential, reference Sequential), the reference's core
    holding the port's initial weights."""
    tm, jm = K.Sequential(make(K)), JK.Sequential(make(JK))
    params, state = to_jax_params(tm.core_module())
    jcore = jm.core_module()
    jcore._params = jax.tree_util.tree_map(jnp.asarray, params)
    jcore._state = jax.tree_util.tree_map(jnp.asarray, state)
    return tm, jm


def _lenet(k):
    return [k.Convolution2D(6, 5, 5, activation="tanh",
                            input_shape=(1, 28, 28)),
            k.MaxPooling2D(), k.Convolution2D(12, 5, 5, activation="tanh"),
            k.MaxPooling2D(), k.Flatten(), k.Dense(100, activation="tanh"),
            k.Dense(10, activation="softmax")]


# name: (model, data, compile args of either package, fit kwargs)
FITS = {
    "blobs_mlp": (
        lambda k: [k.Dense(16, activation="relu", input_shape=(8,)),
                   k.Dense(3, activation="softmax")], _blobs,
        lambda o: (o.SGD(learning_rate=0.1), "categorical_crossentropy",
                   ["accuracy"]), dict(batch_size=32, nb_epoch=2)),
    "lenet_keras_example": (
        _lenet, lambda: _mnist(96),
        lambda o: (o.SGD(learning_rate=0.05, momentum=0.9),
                   "categorical_crossentropy", ["accuracy", "top5"]),
        dict(batch_size=32, nb_epoch=2)),
    "lstm_adam_mse": (
        lambda k: [k.LSTM(6, input_shape=(5, 3)), k.Dense(2)],
        lambda: (np.random.default_rng(5).normal(0, 1, (64, 5, 3))
                 .astype(np.float32),
                 np.random.default_rng(6).normal(0, 1, (64, 2))
                 .astype(np.float32)),
        lambda o: ("adam", "mse", ["mae"]), dict(batch_size=16, nb_epoch=2)),
}


def _mnist(n):
    from bigdl_tpu_torch.dataset import mnist
    imgs, labels = mnist.synthetic_mnist(n, seed=4)
    x = ((imgs.reshape(-1, 1, 28, 28).astype(np.float32))
         - mnist.TRAIN_MEAN) / mnist.TRAIN_STD
    return x, labels.astype(np.int32)


@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_evaluate_predict_match_reference(name):
    make, data, compile_args, fit_kw = FITS[name]
    x, y = data()
    tm, jm = _twins(make)
    tm.compile(*compile_args(optim), device="cpu")
    jm.compile(*compile_args(joptim))
    tm.fit(x, y, validation_data=(x[:40], y[:40]), **fit_kw)
    jm.fit(x, y, validation_data=(x[:40], y[:40]), **fit_kw)
    _close(tm.predict(x, batch_size=24), jm.predict(x, batch_size=24),
           tol=1e-4)
    got, want = tm.evaluate(x, y, batch_size=24), jm.evaluate(
        x, y, batch_size=24)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    if y.dtype.kind == "i":
        probs = np.asarray(jm.predict(x))
        top = np.sort(probs, axis=-1)
        clear = top[:, -1] - top[:, -2] > 1e-3
        assert np.array_equal(tm.predict_classes(x)[clear],
                              np.asarray(jm.predict_classes(x))[clear])


def test_device_is_taken_from_compile_or_fit():
    m = K.Sequential([K.Dense(2, input_shape=(3,))])
    assert m.device == "cuda"
    m.compile("sgd", "mse", device="cpu")
    assert m.device == "cpu"
    x = np.zeros((8, 3), np.float32)
    m.fit(x, np.zeros((8, 2), np.float32), batch_size=4, nb_epoch=1,
          device="cpu")
    assert m.optimizer.state["neval"] == 2
    if not torch.cuda.is_available():
        m2 = K.Sequential([K.Dense(2, input_shape=(3,))])
        m2.compile("sgd", "mse")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            m2.predict(x)


# ------------------------------------------- the reference's own cases
def _model_json():
    return json.dumps({
        "class_name": "Sequential",
        "config": [
            {"class_name": "Dense",
             "config": {"output_dim": 16, "activation": "relu",
                        "batch_input_shape": [None, 4]}},
            {"class_name": "Dense",
             "config": {"output_dim": 2, "activation": "softmax"}},
        ]})


def _spiral(n=256, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 4)).astype(np.float32)
    y_ix = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
    return x, np.eye(2, dtype=np.float32)[y_ix], y_ix


def case_dense_shape_inference():
    m = K.Sequential()
    m.add(K.Dense(32, activation="relu", input_shape=(16,)))
    m.add(K.Dense(4))
    assert m.output_shape == (None, 4)


def case_conv_stack_shape_inference():
    m = K.Sequential([
        K.Convolution2D(6, 5, 5, input_shape=(1, 28, 28),
                        activation="tanh"),
        K.MaxPooling2D(), K.Flatten(), K.Dense(10, activation="softmax")])
    assert m.output_shape == (None, 10)
    with torch.no_grad():
        out = m.core_module()(torch.zeros(2, 1, 28, 28))
    assert out.shape == (2, 10)


def case_lstm_return_sequences():
    assert K.Sequential([K.LSTM(7, return_sequences=True,
                                input_shape=(5, 3))]).output_shape \
        == (None, 5, 7)
    assert K.Sequential([K.LSTM(7, input_shape=(5, 3))]).output_shape \
        == (None, 7)


def case_unknown_activation_raises():
    with pytest.raises(ValueError):
        K.Sequential([K.Dense(4, activation="nope",
                              input_shape=(3,))]).build()


def case_first_layer_needs_input_shape():
    with pytest.raises(ValueError):
        K.Sequential().add(K.Dense(4))


def case_compile_fit_evaluate_predict():
    x, y = _blobs()
    m = K.Sequential([K.Dense(16, activation="relu", input_shape=(8,)),
                      K.Dense(3, activation="softmax")])
    m.compile(optimizer=optim.SGD(learning_rate=0.1),
              loss="categorical_crossentropy", metrics=["accuracy"],
              device="cpu")
    m.fit(x, y, batch_size=32, nb_epoch=8)
    assert m.evaluate(x, y)["Top1Accuracy"] > 0.9
    assert (m.predict_classes(x[:64]) == y[:64]).mean() > 0.85


def case_kld_maps_to_probability_criterion():
    from bigdl_tpu_torch.keras.topology import _LOSSES
    assert _LOSSES["kld"] is nn.KullbackLeiblerDivergenceCriterion
    assert _LOSSES["kullback_leibler_divergence"] \
        is nn.KullbackLeiblerDivergenceCriterion


def case_fit_with_validation():
    x, y = _blobs(128)
    m = K.Sequential([K.Dense(3, activation="softmax", input_shape=(8,))])
    m.compile("sgd", "categorical_crossentropy", ["accuracy"], device="cpu")
    m.fit(x, y, batch_size=32, nb_epoch=2, validation_data=(x, y))


def case_model_wrapping_core_module():
    x, y = _blobs(128)
    m = K.Model(nn.Sequential(nn.Linear(8, 3), nn.LogSoftMax())
                .initialize(0))
    m.compile(optim.SGD(learning_rate=0.1), nn.ClassNLLCriterion(),
              ["accuracy"], device="cpu")
    m.fit(x, y, batch_size=32, nb_epoch=6)
    assert m.evaluate(x, y)["Top1Accuracy"] > 0.9


def case_same_padding_even_kernel():
    assert K.Sequential([K.Convolution2D(
        4, 2, 2, border_mode="same", input_shape=(3, 28, 28))]
    ).output_shape == (None, 4, 28, 28)
    assert K.Sequential([K.Convolution2D(
        4, 3, 3, border_mode="same", subsample=(2, 2),
        input_shape=(3, 28, 28))]).output_shape == (None, 4, 14, 14)


def case_same_pooling_shape_and_values():
    m = K.Sequential([K.MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                                     border_mode="same",
                                     input_shape=(1, 5, 5))])
    assert m.output_shape == (None, 1, 3, 3)
    ma = K.Sequential([K.AveragePooling2D(pool_size=(2, 2), strides=(2, 2),
                                          border_mode="same",
                                          input_shape=(1, 3, 3))])
    out = ma.core_module()(torch.arange(9.0).reshape(1, 1, 3, 3))
    # the bottom-right window covers only cell (2, 2) = 8: avg 8, not 8/4
    assert out[0, 0, 1, 1].item() == 8.0


def case_cropping_full_extent_gives_empty():
    out = nn.Cropping2D((0, 4), (0, 0))(torch.zeros(1, 2, 4, 5))
    assert out.shape == (1, 2, 0, 5)


def case_categorical_crossentropy_one_hot():
    probs = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]])
    onehot = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    c = nn.CategoricalCrossEntropy()
    expected = -(np.log(0.7) + np.log(0.8)) / 2
    np.testing.assert_allclose(c.apply(probs, onehot).item(), expected,
                               rtol=1e-5)
    np.testing.assert_allclose(c.apply(probs, torch.tensor([0, 1])).item(),
                               expected, rtol=1e-5)


def case_1d_pooling_and_padding():
    m = K.Sequential([K.ZeroPadding1D(2, input_shape=(6, 3)),
                      K.Convolution1D(5, 3, activation="tanh"),
                      K.MaxPooling1D(2), K.GlobalMaxPooling1D()])
    assert m.output_shape == (None, 5)


def case_separable_conv():
    assert K.Sequential([K.SeparableConvolution2D(
        8, 3, 3, input_shape=(4, 9, 9))]).output_shape[1] == 8


def case_merge_modes():
    for mode, expect in (("sum", 3.0), ("mul", 2.0), ("max", 2.0)):
        out = K.Merge(mode=mode).build((4,))((torch.full((2, 4), 1.0),
                                              torch.full((2, 4), 2.0)))
        assert torch.all(out == expect)


def case_separable_tf_ordering_rejected():
    with pytest.raises(NotImplementedError, match="dim_ordering"):
        K.Sequential([K.SeparableConvolution2D(
            8, 3, 3, dim_ordering="tf", input_shape=(9, 9, 4))]).build()


def case_highway_activation_respected():
    assert K.Highway(activation="relu").build((6,)).activation \
        is not K.Highway().build((6,)).activation


def case_merge_in_sequential_raises():
    m = K.Sequential([K.InputLayer(input_shape=(4,)), K.Merge(mode="sum")])
    with pytest.raises(TypeError, match="Sequential"):
        _ = m.output_shape


def case_wrapper_one_call_fit_evaluate_predict(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(_model_json())
    x, y, y_ix = _spiral()
    m = K.KerasModelWrapper(str(p), optimizer="adam",
                            loss="categorical_crossentropy",
                            metrics=["accuracy"], device="cpu")
    m.fit(x, y, batch_size=32, nb_epoch=15)
    assert m.evaluate(x, y)["Top1Accuracy"] > 0.9
    pred = m.predict(x)
    assert pred.shape == (256, 2)
    np.testing.assert_allclose(pred.sum(1), 1.0, rtol=1e-4)
    assert (m.predict_classes(x) == y_ix).mean() > 0.9


def case_wrapper_import_only_then_compile(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(_model_json())
    m = K.KerasModelWrapper(str(p), device="cpu")  # no loss: import-only
    with pytest.raises(RuntimeError):
        m.fit(*_spiral()[:2], nb_epoch=1)
    m.compile("sgd", "categorical_crossentropy")
    m.fit(*_spiral()[:2], batch_size=64, nb_epoch=1)


def case_wrapper_set_weights_then_predict(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(_model_json())
    rng = np.random.default_rng(1)
    ws = [rng.normal(0, 0.1, (4, 16)).astype(np.float32),
          np.zeros(16, np.float32),
          rng.normal(0, 0.1, (16, 2)).astype(np.float32),
          np.zeros(2, np.float32)]
    m = K.load_model(str(p), device="cpu").set_weights(ws)
    x = rng.normal(0, 1, (5, 4)).astype(np.float32)
    h = np.maximum(x @ ws[0] + ws[1], 0)
    logits = h @ ws[2] + ws[3]
    want = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(m.predict(x), want, rtol=1e-4, atol=1e-5)


def case_smooth_l1_rejects_two_tuple():
    c = nn.SmoothL1CriterionWithWeights()
    with pytest.raises(ValueError):
        c.apply(torch.zeros(1, 2), (torch.zeros(1, 2), torch.ones(1, 2)))


def case_wrapper_hdf5_weights_when_h5py_present(tmp_path):
    h5py = pytest.importorskip("h5py")
    p = tmp_path / "m.json"
    p.write_text(_model_json())
    rng = np.random.default_rng(2)
    ws = [rng.normal(0, 0.1, (4, 16)).astype(np.float32),
          np.zeros(16, np.float32),
          rng.normal(0, 0.1, (16, 2)).astype(np.float32),
          np.zeros(2, np.float32)]
    h5 = tmp_path / "w.h5"
    with h5py.File(str(h5), "w") as f:
        grp = f.create_group("model_weights")
        grp.attrs["layer_names"] = [b"dense_1", b"dense_2"]
        for i, name in enumerate(("dense_1", "dense_2")):
            g = grp.create_group(name)
            g.attrs["weight_names"] = [f"{name}/W".encode(),
                                       f"{name}/b".encode()]
            g[f"{name}/W"] = ws[2 * i]
            g[f"{name}/b"] = ws[2 * i + 1]
    m = K.KerasModelWrapper(str(p), str(h5), device="cpu")
    x = rng.normal(0, 1, (3, 4)).astype(np.float32)
    h = np.maximum(x @ ws[0] + ws[1], 0)
    logits = h @ ws[2] + ws[3]
    want = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    np.testing.assert_allclose(m.predict(x), want, rtol=1e-4, atol=1e-5)


REFERENCE_CASES = {name[5:]: fn for name, fn in dict(globals()).items()
                   if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(REFERENCE_CASES))
def test_reference_keras_case(name, tmp_path):
    fn = REFERENCE_CASES[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()

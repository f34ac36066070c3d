"""The Keras-1.2 importer of the port (``interop/keras_format.py``) on the
CPU against the reference's: a JSON definition the test writes
(Sequential or functional), the same Keras-order weight arrays installed
by ``set_keras_weights`` (or read from an HDF5 file the test writes, when
``h5py`` is present), and the two forwards within ``rtol=1e-5,
atol=1e-5*max|y|``.  ``ModelRegistry.deploy(format="keras")`` and
``convert_model --from keras`` load the same files.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu.interop import keras_format as jkf  # noqa: E402
from bigdl_tpu_torch.interop import keras_format as tkf  # noqa: E402


def _layer(cls, **cfg):
    return {"class_name": cls, "config": cfg}


SEQUENTIAL = {
    "mlp_dropout": ([
        _layer("Dense", output_dim=8, activation="relu",
               batch_input_shape=[None, 4]),
        _layer("Dropout", p=0.5),
        _layer("Dense", output_dim=3, activation="softmax")], (4,)),
    "batchnorm": ([
        _layer("Dense", output_dim=8, activation="linear",
               batch_input_shape=[None, 4]),
        _layer("BatchNormalization", epsilon=1e-3),
        _layer("Dense", output_dim=3)], (4,)),
    "lenet": ([
        _layer("Convolution2D", nb_filter=6, nb_row=5, nb_col=5,
               activation="tanh", batch_input_shape=[None, 1, 28, 28]),
        _layer("MaxPooling2D", pool_size=[2, 2]),
        _layer("Convolution2D", nb_filter=12, nb_row=5, nb_col=5,
               activation="tanh"),
        _layer("MaxPooling2D", pool_size=[2, 2], strides=[2, 2]),
        _layer("Flatten"),
        _layer("Dense", output_dim=100, activation="tanh"),
        _layer("Dense", output_dim=10, activation="softmax")], (1, 28, 28)),
    "conv_tf_same": ([
        _layer("Convolution2D", nb_filter=4, nb_row=3, nb_col=3,
               border_mode="same", subsample=[2, 2], dim_ordering="tf",
               batch_input_shape=[None, 9, 9, 3]),
        _layer("AveragePooling2D", pool_size=[2, 2], border_mode="same",
               dim_ordering="tf"),
        _layer("GlobalMaxPooling2D", dim_ordering="tf")], (9, 9, 3)),
    "conv_th_pads": ([
        _layer("ZeroPadding2D", padding=[1, 2],
               batch_input_shape=[None, 2, 6, 6]),
        _layer("Convolution2D", nb_filter=3, nb_row=3, nb_col=3,
               bias=False),
        _layer("BatchNormalization"),
        _layer("Activation", activation="relu"),
        _layer("GlobalAveragePooling2D")], (2, 6, 6)),
    "text_rnn": ([
        _layer("Embedding", input_dim=20, output_dim=6, input_length=7),
        _layer("LSTM", output_dim=5, return_sequences=True),
        _layer("GRU", output_dim=4, go_backwards=True),
        _layer("Dense", output_dim=2)], (7,)),
    "conv1d_simple_rnn": ([
        _layer("Convolution1D", nb_filter=5, filter_length=3,
               activation="relu", batch_input_shape=[None, 9, 4]),
        _layer("SimpleRNN", output_dim=3),
        _layer("Reshape", target_shape=[3, 1])], (9, 4)),
}


def _functional(mode="concat"):
    return {"class_name": "Model", "config": {
        "name": "branchy",
        "layers": [
            {"class_name": "InputLayer", "name": "in1",
             "config": {"name": "in1", "batch_input_shape": [None, 6]}},
            {"class_name": "Dense", "name": "a",
             "config": {"name": "a", "output_dim": 8, "activation": "relu"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Dense", "name": "b",
             "config": {"name": "b", "output_dim": 8, "activation": "tanh"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Merge", "name": "m",
             "config": {"name": "m", "mode": mode, "concat_axis": -1},
             "inbound_nodes": [[["a", 0, 0], ["b", 0, 0]]]},
            {"class_name": "Dense", "name": "out",
             "config": {"name": "out", "output_dim": 3,
                        "activation": "softmax"},
             "inbound_nodes": [[["m", 0, 0]]]}],
        "input_layers": [["in1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}


def _channel_concat():
    return {"class_name": "Model", "config": {
        "name": "chan_concat",
        "layers": [
            {"class_name": "InputLayer", "name": "in1",
             "config": {"name": "in1", "batch_input_shape": [None, 3, 8, 8]}},
            {"class_name": "Convolution2D", "name": "ca",
             "config": {"name": "ca", "nb_filter": 4, "nb_row": 3,
                        "nb_col": 3, "border_mode": "same"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Convolution2D", "name": "cb",
             "config": {"name": "cb", "nb_filter": 5, "nb_row": 3,
                        "nb_col": 3, "border_mode": "same"},
             "inbound_nodes": [[["in1", 0, 0]]]},
            {"class_name": "Merge", "name": "m",
             "config": {"name": "m", "mode": "concat", "concat_axis": 1},
             "inbound_nodes": [[["ca", 0, 0], ["cb", 0, 0]]]},
            {"class_name": "Convolution2D", "name": "out",
             "config": {"name": "out", "nb_filter": 2, "nb_row": 1,
                        "nb_col": 1},
             "inbound_nodes": [[["m", 0, 0]]]}],
        "input_layers": [["in1", 0, 0]],
        "output_layers": [["out", 0, 0]]}}


def _shared_layer():
    return {"class_name": "Model", "config": {
        "layers": [
            {"class_name": "InputLayer", "name": "i",
             "config": {"name": "i", "batch_input_shape": [None, 4]}},
            {"class_name": "Dense", "name": "d",
             "config": {"name": "d", "output_dim": 4},
             "inbound_nodes": [[["i", 0, 0]], [["d", 0, 0]]]}],
        "input_layers": [["i", 0, 0]],
        "output_layers": [["d", 1, 0]]}}


DOCS = {**{name: ({"class_name": "Sequential", "config": layers}, shape)
           for name, (layers, shape) in SEQUENTIAL.items()},
        "functional_concat": (_functional("concat"), (6,)),
        "functional_sum": (_functional("sum"), (6,)),
        "functional_channel_concat": (_channel_concat(), (3, 8, 8)),
        "functional_shared_layer": (_shared_layer(), (4,))}


def _keras_weights(core, seed):
    """Keras-order arrays fitting the port's built ``core``: each leaf's
    weight (Dense kernels (in, out), tf conv kernels (kh, kw, in, out)),
    bias, and BatchNorm's four, seeded."""
    from bigdl_tpu_torch import nn
    rng = np.random.default_rng(seed)
    out = []

    def rand(shape, lo=-0.5, hi=0.5):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def walk(m):
        kids = tkf._children(m)
        if kids is not None:
            for k in kids:
                walk(k)
            return
        p = dict(m.named_parameters(recurse=False))
        if isinstance(m, nn.SpatialBatchNormalization):
            n = m.n_output
            out.extend([rand(n, 0.5, 1.5), rand(n), rand(n),
                        rand(n, 0.5, 2.0)])
            return
        if "weight" in p:
            w = tuple(p["weight"].shape)
            if isinstance(m, nn.Linear) or (len(w) == 2 and "cell" not in
                                            type(m).__name__.lower()):
                w = w[::-1]
            elif len(w) == 4 and getattr(m, "format", "NCHW") == "NHWC":
                w = (w[2], w[3], w[1], w[0])
            out.append(rand(w))
        if p.get("bias") is not None:
            out.append(rand(tuple(p["bias"].shape)))

    walk(core)
    return out


def _input(shape, seed=1):
    rng = np.random.default_rng(seed)
    if shape == (7,):
        return rng.integers(0, 20, (3,) + shape).astype(np.float32)
    return rng.normal(0, 1, (3,) + shape).astype(np.float32)


def _load_both(text):
    """Both packages' topologies of ``text``, the reference's core holding
    the port's initial weights: the arrays a Keras file does not cover
    (the recurrent cells' own parameter names) start equal."""
    from bigdl_tpu_torch.interop import to_jax_params
    tm, jm = tkf.load_keras_json(text), jkf.load_keras_json(text)
    params, state = to_jax_params(tm.core_module())
    jcore = jm.core_module()
    jcore._params = jax.tree_util.tree_map(jnp.asarray, params)
    jcore._state = jax.tree_util.tree_map(jnp.asarray, state)
    return tm, jm


def _forwards(doc, shape, weights=None, seed=0):
    text = json.dumps(doc)
    tm, jm = _load_both(text)
    ws = weights if weights is not None else _keras_weights(
        tm.core_module(), seed)
    tkf.set_keras_weights(tm, ws)
    jkf.set_keras_weights(jm, ws)
    x = _input(shape)
    core = tm.core_module().eval()
    with torch.no_grad():
        got = core(torch.from_numpy(x)).numpy()
    jcore = jm.core_module()
    want, _ = jcore.apply(jm._params if jm._params is not None
                          else jcore._params,
                          jm._mstate if jm._mstate is not None
                          else jcore._state, jnp.asarray(x), training=False)
    return got, np.asarray(want), tm, jm


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(DOCS))
def test_json_and_keras_weights_match_reference(name):
    doc, shape = DOCS[name]
    got, want, tm, jm = _forwards(doc, shape)
    _close(got, want)
    if doc["class_name"] == "Sequential":
        assert tm.output_shape == jm.output_shape
        assert got.shape[1:] == tuple(tm.output_shape[1:])


def test_keras_order_weights_land_where_keras_puts_them():
    """Dense kernels (in, out) transposed, BatchNorm's fourth array the
    running variance: the numpy forward of the Keras layer stack."""
    doc, _ = DOCS["batchnorm"]
    rng = np.random.RandomState(1)
    ws = [rng.rand(4, 8).astype(np.float32), rng.rand(8).astype(np.float32),
          rng.rand(8).astype(np.float32) + 0.5, rng.rand(8).astype(np.float32),
          rng.rand(8).astype(np.float32),
          rng.rand(8).astype(np.float32) + 0.5,
          rng.rand(8, 3).astype(np.float32), rng.rand(3).astype(np.float32)]
    m = tkf.load_keras_json(json.dumps(doc))
    tkf.set_keras_weights(m, ws)
    x = rng.rand(2, 4).astype(np.float32)
    with torch.no_grad():
        out = m.core_module().eval()(torch.from_numpy(x)).numpy()
    h = x @ ws[0] + ws[1]
    hn = ws[2] * (h - ws[4]) / np.sqrt(ws[5] + 1e-3) + ws[3]
    np.testing.assert_allclose(out, hn @ ws[6] + ws[7], rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="consumed 8 of 9"):
        tkf.set_keras_weights(m, ws + [ws[-1]])


def test_unknown_layer_and_dynamic_shapes_raise():
    doc = {"class_name": "Sequential", "config": [_layer("Lambda")]}
    with pytest.raises(NotImplementedError, match="Lambda"):
        tkf.load_keras_json(json.dumps(doc))
    doc = {"class_name": "Sequential", "config": [
        _layer("Dense", output_dim=2, batch_input_shape=[None, None])]}
    with pytest.raises(NotImplementedError, match="dynamic"):
        tkf.load_keras_json(json.dumps(doc))


def test_functional_shared_layer_ties_weights():
    m = tkf.load_keras_json(json.dumps(_shared_layer()))
    assert len(list(m.core_module().parameters())) == 2


def _write_hdf5(path, core, ws):
    """A Keras-1.2 weight file: one group a weighted layer, in order."""
    h5py = pytest.importorskip("h5py")
    counts, names = [], []
    for i, m in enumerate(core.children()):
        n = sum(1 for _ in m.parameters()) + sum(
            1 for k, _ in m.named_buffers() if k.startswith("running"))
        if n:
            counts.append(n)
            names.append(f"layer_{i}")
    with h5py.File(path, "w") as f:
        grp = f.create_group("model_weights")
        grp.attrs["layer_names"] = [n.encode() for n in names]
        at = 0
        for name, n in zip(names, counts):
            g = grp.create_group(name)
            wn = [f"{name}_{j}".encode() for j in range(n)]
            g.attrs["weight_names"] = wn
            for w, a in zip(wn, ws[at:at + n]):
                g.create_dataset(w.decode(), data=a)
            at += n


@pytest.mark.parametrize("name", ["batchnorm", "lenet"])
def test_hdf5_weights_match_reference(name, tmp_path):
    pytest.importorskip("h5py")
    doc, shape = DOCS[name]
    text = json.dumps(doc)
    tm, jm = _load_both(text)
    ws = _keras_weights(tm.core_module(), seed=5)
    path = str(tmp_path / "w.h5")
    _write_hdf5(path, tm.core_module(), ws)
    tkf.load_keras_hdf5_weights(tm, path)
    jkf.load_keras_hdf5_weights(jm, path)
    x = _input(shape)
    with torch.no_grad():
        got = tm.core_module().eval()(torch.from_numpy(x)).numpy()
    want, _ = jm.core_module().apply(jm._params, jm._mstate, jnp.asarray(x),
                                     training=False)
    _close(got, np.asarray(want))
    # the same arrays installed directly: bitwise the file's
    direct = tkf.load_keras_json(text)
    tkf.set_keras_weights(direct, ws)
    with torch.no_grad():
        assert torch.equal(direct.core_module().eval()(torch.from_numpy(x)),
                           torch.from_numpy(got))


def test_deploy_keras_file_matches_reference_deploy(tmp_path):
    from bigdl_tpu.serving import ModelRegistry as JaxRegistry
    from bigdl_tpu_torch.serving import ModelRegistry
    doc, shape = DOCS["lenet"]
    path = str(tmp_path / "lenet.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    ws = _keras_weights(tkf.load_keras_json(path).core_module(), seed=6)
    x = _input(shape, seed=7)
    with ModelRegistry(device="cpu") as reg:
        reg.deploy("k", path=path, format="keras", weights=ws)
        got = reg.predict("k", x, timeout=120)
    m = tkf.load_keras_json(path)
    tkf.set_keras_weights(m, ws)
    with torch.no_grad():
        want = m.core_module().eval()(torch.from_numpy(x)).numpy()
    _close(got, want)
    h5 = pytest.importorskip("h5py") and str(tmp_path / "w.h5")
    _write_hdf5(h5, tkf.load_keras_json(path).core_module(), ws)
    jreg = JaxRegistry()
    try:
        jreg.deploy("k", path=path, format="keras", weights=h5)
        want_h5 = np.asarray(jreg.predict("k", x, timeout=120))
    finally:
        jreg.stop_all()
    with ModelRegistry(device="cpu") as reg:
        reg.deploy("k", path=path, format="keras", weights=h5)
        _close(reg.predict("k", x, timeout=120), want_h5)


def test_convert_model_from_keras(tmp_path):
    """``--from keras`` with a JSON definition and its HDF5 weights, to a
    ``.bigdl`` file that loads to the same forward, bitwise."""
    pytest.importorskip("h5py")
    from bigdl_tpu_torch import interop
    from bigdl_tpu_torch.interop import convert_model
    doc, shape = DOCS["lenet"]
    path, h5 = str(tmp_path / "l.json"), str(tmp_path / "l.h5")
    with open(path, "w") as f:
        json.dump(doc, f)
    m = tkf.load_keras_json(path)
    ws = _keras_weights(m.core_module(), seed=8)
    _write_hdf5(h5, m.core_module(), ws)
    out = str(tmp_path / "l.bigdl")
    convert_model.main(["--from", "keras", "--to", "bigdl", "--input", path,
                        "--weights", h5, "--output", out, "--device", "cpu"])
    tkf.set_keras_weights(m, ws)
    x = torch.from_numpy(_input(shape, seed=9))
    with torch.no_grad():
        want = m.core_module().eval()(x)
        got = interop.load_bigdl_module(out).eval()(x)
    assert torch.equal(got, want)

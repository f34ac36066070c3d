"""The port's interop layer against the JAX reference, on the CPU.

Every format crosses packages both ways: the reference writes and the
port reads, the port writes and the reference reads, and the two eval-mode
forwards agree within ``TOL[format]`` (a share of max|y|).  Each direction
also reads a planted fault (the loaded model's first weight flipped along
its last axis, a layout bug) that must exceed the limit.  The writers of
both packages give byte-identical files for the same weights.
``convert_model`` and ``ModelRegistry.deploy(path=, format=)`` are held to
the reference's own.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import bigdl_tpu.interop as jinterop  # noqa: E402
from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.interop import caffe_export as jcaffe_export  # noqa: E402
from bigdl_tpu.interop import torch_export as jtorch_export  # noqa: E402
from bigdl_tpu.models import lenet5 as jlenet5  # noqa: E402
from bigdl_tpu.nn.quantized import quantize as jquantize  # noqa: E402
from bigdl_tpu.utils import protowire as jpw  # noqa: E402

from bigdl_tpu_torch import interop, nn  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.nn.quantized import quantize  # noqa: E402
from bigdl_tpu_torch.utils import protowire as pw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# forward agreement, as a share of max|y|: the weights cross exactly, so
# what is left is the two packages' own arithmetic; Caffe splits BatchNorm
# into BatchNorm + Scale and TensorFlow folds it into one scale and shift
TOL = {"bigdl": 1e-5, "torch": 1e-5, "caffe": 1e-4, "tensorflow": 1e-4}


# ------------------------------------------------------------- the models
def _cnn(n, lrn=True):
    """conv/BN/ReLU/LRN/pools/Flatten/Linear (TensorFlow's exporter maps
    no LRN: ``cnn_tf`` leaves it out)."""
    seq = (n.Sequential(name="CNN")
           .add(n.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, name="conv1"))
           .add(n.SpatialBatchNormalization(4, name="bn1"))
           .add(n.ReLU(name="relu1")))
    if lrn:
        seq.add(n.SpatialCrossMapLRN(3, 0.5, 0.75, 1.0, name="lrn"))
    return (seq.add(n.SpatialMaxPooling(2, 2, 2, 2, name="pool1"))
            .add(n.SpatialConvolution(4, 6, 3, 3, name="conv2"))
            .add(n.Tanh(name="tanh"))
            .add(n.SpatialAveragePooling(2, 2, 2, 2, name="pool2"))
            .add(n.Flatten(name="flat"))
            .add(n.Linear(6, 5, name="fc"))
            .add(n.SoftMax(name="prob")))


def _mlp_bn(n):
    return (n.Sequential(name="MLP")
            .add(n.Linear(8, 16, name="fc1"))
            .add(n.BatchNormalization(16, name="bn"))
            .add(n.ReLU(name="relu"))
            .add(n.Dropout(0.3, name="drop"))
            .add(n.Linear(16, 4, name="fc2"))
            .add(n.LogSoftMax(name="logp")))


def _bottleneck(n):
    """ResNet's bottleneck with a projection shortcut (ConcatTable)."""
    def conv_bn(cin, cout, k, s, p, nm):
        return [n.SpatialConvolution(cin, cout, k, k, s, s, p, p,
                                     with_bias=False, name=f"{nm}_conv"),
                n.SpatialBatchNormalization(cout, name=f"{nm}_bn")]
    main = n.Sequential(name="main")
    for m in (conv_bn(8, 4, 1, 1, 0, "a") + [n.ReLU(name="a_relu")]
              + conv_bn(4, 4, 3, 2, 1, "b") + [n.ReLU(name="b_relu")]
              + conv_bn(4, 16, 1, 1, 0, "c")):
        main.add(m)
    short = n.Sequential(name="short")
    for m in conv_bn(8, 16, 1, 2, 0, "s"):
        short.add(m)
    return (n.Sequential(name="Bottleneck")
            .add(n.ConcatTable(name="split").add(main).add(short))
            .add(n.CAddTable(name="add")).add(n.ReLU(name="out_relu")))


def _graph_bottleneck(n):
    """The same bottleneck through the functional API (an nn.Graph)."""
    inp = n.Input()

    def conv_bn(x, cin, cout, k, s, p, nm):
        x = n.SpatialConvolution(cin, cout, k, k, s, s, p, p, with_bias=False,
                                 name=f"{nm}_conv")(x)
        return n.SpatialBatchNormalization(cout, name=f"{nm}_bn")(x)
    h = n.ReLU(name="a_relu")(conv_bn(inp, 8, 4, 1, 1, 0, "a"))
    h = n.ReLU(name="b_relu")(conv_bn(h, 4, 4, 3, 2, 1, "b"))
    h = conv_bn(h, 4, 16, 1, 1, 0, "c")
    s = conv_bn(inp, 8, 16, 1, 2, 0, "s")
    out = n.ReLU(name="out_relu")(n.CAddTable(name="add")([h, s]))
    return n.Graph([inp], [out], name="GraphBottleneck")


def _graph_shared(n):
    """A branching Graph whose Linear is used at two nodes (tied)."""
    inp = n.Input()
    shared = n.Linear(6, 6, name="shared")
    h = shared(inp)
    a = n.ReLU(name="relu")(h)
    b = n.Tanh(name="tanh")(shared(a))
    s = n.CAddTable(name="sum")([a, b])
    out = n.Linear(6, 3, name="head")(s)
    return n.Graph([inp], [out], name="Shared")


def _temporal(n):
    return (n.Sequential(name="Temporal")
            .add(n.TemporalConvolution(4, 6, 3, 1, name="tconv"))
            .add(n.ReLU(name="relu")))


def _regularized(n):
    from importlib import import_module
    reg = import_module(n.__name__ + ".regularizers")
    return n.Sequential(name="Reg").add(n.Linear(
        5, 3, w_regularizer=reg.L1L2Regularizer(1e-4, 2e-4),
        b_regularizer=reg.L2Regularizer(3e-4), name="fc"))


def _lenet(n):
    return lenet5(10) if n is nn else jlenet5(10)


BUILDERS = {"lenet": (_lenet, (2, 784)), "mlp_bn": (_mlp_bn, (3, 8)),
            "cnn": (_cnn, (2, 3, 8, 8)),
            "cnn_tf": (lambda n: _cnn(n, lrn=False), (2, 3, 8, 8)),
            "bottleneck": (_bottleneck, (2, 8, 6, 6)),
            "graph_bottleneck": (_graph_bottleneck, (2, 8, 6, 6)),
            "graph_shared": (_graph_shared, (3, 6)),
            "temporal": (_temporal, (2, 7, 4)),
            "regularized": (_regularized, (4, 5)),
            "lenet_q_weight_only": (_lenet, (2, 784)),
            "lenet_q_dynamic": (_lenet, (2, 784))}
FORMAT_MODELS = {
    "bigdl": list(BUILDERS),
    "torch": ["lenet", "mlp_bn", "cnn"],
    "caffe": ["cnn", "graph_bottleneck", "graph_shared"],
    "tensorflow": ["lenet", "mlp_bn", "cnn_tf", "bottleneck"],
}
CASES = [(f, m) for f, ms in FORMAT_MODELS.items() for m in ms]


def _jtree(t):
    return jax.tree_util.tree_map(jax.numpy.asarray, t)


def twins(name, seed=0):
    """(port model, reference model, input): the same weights, BatchNorm
    running statistics drawn from the seed, both in eval mode."""
    build, shape = BUILDERS[name]
    port = build(nn).initialize(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for m in port.modules():
        if isinstance(m, nn.SpatialBatchNormalization):
            m.running_mean.copy_(torch.randn(m.n_output, generator=gen))
            m.running_var.copy_(torch.rand(m.n_output, generator=gen) + 0.5)
    ref = build(jnn)
    p, s = interop.to_jax_params(port)
    ref._params, ref._state = _jtree(p), _jtree(s)
    if name.startswith("lenet_q_"):
        mode = name[len("lenet_q_"):]
        port, ref = quantize(port, mode=mode), jquantize(ref, mode=mode)
    x = np.random.default_rng(seed + 2).normal(size=shape).astype(np.float32)
    return port.eval(), ref.evaluate(), x


def port_forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


def ref_forward(model, x):
    if hasattr(model, "evaluate"):
        model.evaluate()
    return np.asarray(model.forward(x))


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def planted(model):
    """The loaded port model with its first weight (a float parameter, an
    int8 panel, or a frozen graph's weight constant) flipped along its last
    axis."""
    tensors = list(model.parameters()) + list(model.buffers())
    for t in tensors:
        if t.dim() >= 2 and t.shape[-1] > 1:
            with torch.no_grad():
                t.copy_(t.flip(-1))
            return model
    for nm, v in getattr(model, "_folded", {}).items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f" \
                and v.ndim >= 2 and v.shape[-1] > 1:
            model._folded[nm] = np.ascontiguousarray(v[..., ::-1])
            model._const_cache.clear()
            return model
    raise AssertionError("no weight to plant a fault in")


# ------------------------------------------------------ per-format writers
def port_save(fmt, model, d, x_shape):
    if fmt == "bigdl":
        p = os.path.join(d, "port.bigdl")
        interop.save_bigdl_module(model, p)
        return (p,)
    if fmt == "torch":
        p = os.path.join(d, "port.t7")
        interop.save_torch_module(model, p)
        return (p,)
    if fmt == "caffe":
        proto, weights = os.path.join(d, "port.prototxt"), \
            os.path.join(d, "port.caffemodel")
        interop.save_caffe(model, proto, weights)
        return proto, weights
    p = os.path.join(d, "port.pb")
    interop.save_tf_graph(model, p, x_shape)
    return (p,)


def ref_save(fmt, model, d, x_shape):
    if fmt == "bigdl":
        p = os.path.join(d, "ref.bigdl")
        jinterop.save_bigdl_module(model, p)
        return (p,)
    if fmt == "torch":
        p = os.path.join(d, "ref.t7")
        jtorch_export.save_torch_module(model, p)
        return (p,)
    if fmt == "caffe":
        proto, weights = os.path.join(d, "ref.prototxt"), \
            os.path.join(d, "ref.caffemodel")
        jcaffe_export.save_caffe(model, proto, weights)
        return proto, weights
    p = os.path.join(d, "ref.pb")
    jinterop.save_tf_graph(model, p, x_shape)
    return (p,)


def port_load(fmt, files):
    if fmt == "bigdl":
        return interop.load_bigdl_module(files[0])
    if fmt == "torch":
        return interop.load_torch_module(files[0])
    if fmt == "caffe":
        return interop.load_caffe_model(*files)
    return interop.load_tf_graph(files[0], ["input"], ["output"])


def ref_load(fmt, files):
    if fmt == "bigdl":
        return jinterop.load_bigdl_module(files[0])
    if fmt == "torch":
        return jtorch_export.load_torch_module(files[0])
    if fmt == "caffe":
        return jinterop.load_caffe_model(*files)
    return jinterop.load_tf_graph(files[0], ["input"], ["output"])


def _read(files):
    return [open(f, "rb").read() for f in files]


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("fmt,name", CASES)
def test_writers_byte_identical(fmt, name, tmp_path):
    port, ref, x = twins(name)
    got = _read(port_save(fmt, port, str(tmp_path), x.shape))
    want = _read(ref_save(fmt, ref, str(tmp_path), x.shape))
    assert [len(g) for g in got] == [len(w) for w in want]
    assert got == want


@pytest.mark.parametrize("fmt,name", CASES)
def test_reference_writes_port_reads(fmt, name, tmp_path):
    port, ref, x = twins(name)
    files = ref_save(fmt, ref, str(tmp_path), x.shape)
    want = ref_forward(ref, x)
    got = port_forward(port_load(fmt, files), x)
    assert got.shape == want.shape
    assert rel(got, want) <= TOL[fmt]
    fault = rel(port_forward(planted(port_load(fmt, files)), x), want)
    assert fault > TOL[fmt], f"planted fault reads {fault}: the check is blind"


@pytest.mark.parametrize("fmt,name", CASES)
def test_port_writes_reference_reads(fmt, name, tmp_path):
    port, ref, x = twins(name)
    files = port_save(fmt, port, str(tmp_path), x.shape)
    got = ref_forward(ref_load(fmt, files), x)
    want = port_forward(port, x)
    assert rel(got, want) <= TOL[fmt]
    # the same file read back by the port, with the planted fault
    fault = rel(port_forward(planted(port_load(fmt, files)), x), want)
    assert fault > TOL[fmt], f"planted fault reads {fault}: the check is blind"


def test_shared_module_appears_once(tmp_path):
    port, ref, x = twins("graph_shared")
    assert sorted(port.state_dict()) == ["0.bias", "0.weight", "5.bias",
                                         "5.weight"]
    assert len(list(port.parameters())) == 4
    p, _ = interop.to_jax_params(port)
    assert set(p) == set(ref._params)  # first-occurrence keys
    interop.save_bigdl_module(port, str(tmp_path / "g.bigdl"))
    back = interop.load_bigdl_module(str(tmp_path / "g.bigdl"))
    assert len(list(back.parameters())) == 4
    assert back._order[0].module is back._order[2].module
    np.testing.assert_array_equal(port_forward(back, x), port_forward(port, x))


def test_graph_under_hooks_and_remat():
    """Module.__call__ builds Nodes only for Nodes: a tensor call keeps
    torch's hooks, and a Remat region inside a Graph recomputes."""
    port, _, x = twins("graph_bottleneck")
    seen = []
    h = port._order[0].module.register_forward_hook(
        lambda m, i, o: seen.append(o.shape))
    want = port_forward(port, x)
    h.remove()
    assert seen == [torch.Size([2, 4, 6, 6])]
    inp = nn.Input()
    block = nn.Remat(nn.Sequential(nn.Linear(6, 6), nn.Tanh()))
    g = nn.Graph([inp], [nn.Linear(6, 2)(block(inp))]).initialize(3)
    xt = torch.randn(4, 6, requires_grad=True)
    g(xt).sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    assert want.shape == (2, 16, 3, 3)


def test_decoded_tree_and_storage_ids(tmp_path):
    port, _, x = twins("cnn")
    path = str(tmp_path / "m.bigdl")
    interop.save_bigdl_module(port, path)
    data = open(path, "rb").read()
    tree = interop.decode_bigdl_module(data)
    want = jinterop.decode_bigdl_module(data)
    assert tree["module_type"] == "com.intel.analytics.bigdl.nn.Sequential"
    assert [s["name"] for s in tree["sub_modules"]] == \
        [s["name"] for s in want["sub_modules"]]
    bn = tree["sub_modules"][1]
    np.testing.assert_array_equal(bn["attrs"]["runningMean"],
                                  port[1].running_mean.numpy())
    assert tree["sub_modules"][4]["attrs"]["ceil_mode"] is False
    # the writer is deterministic: a second save is the same bytes
    interop.save_bigdl_module(port, path)
    assert open(path, "rb").read() == data


def test_regularizers_cross(tmp_path):
    port, ref, _ = twins("regularized")
    path = str(tmp_path / "r.bigdl")
    jinterop.save_bigdl_module(ref, path)
    fc = interop.load_bigdl_module(path)[0]
    assert (fc.w_regularizer.l1, fc.w_regularizer.l2) == (1e-4, 2e-4)
    assert (fc.b_regularizer.l1, fc.b_regularizer.l2) == (0.0, 3e-4)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantized_file_bitwise_to_in_memory(mode, tmp_path):
    """A quantized LeNet read from a file (written by either package) runs
    bitwise as the in-memory quantized model, int8 panels and mode kept."""
    port, ref, x = twins(f"lenet_q_{mode}")
    for writer in (interop.save_bigdl_module, jinterop.save_bigdl_module):
        path = str(tmp_path / "q.bigdl")
        writer(port if writer is interop.save_bigdl_module else ref, path)
        back = interop.load_bigdl_module(path)
        layers = [m for m in back.modules()
                  if isinstance(m, (nn.QuantizedLinear,
                                    nn.QuantizedSpatialConvolution))]
        assert len(layers) == 4 and {m.mode for m in layers} == {mode}
        assert all(m.weight_q.dtype == torch.int8 for m in layers)
        np.testing.assert_array_equal(port_forward(back, x),
                                      port_forward(port, x))


def test_t7_values_cross(tmp_path):
    value = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
             "b": [1.5, "s", True], "c": np.ones((2, 2), np.float64)}
    for save, load in ((interop.save_t7, jinterop.load_t7),
                       (jinterop.save_t7, interop.load_t7)):
        path = str(tmp_path / "v.t7")
        save(path, value)
        back = load(path)
        np.testing.assert_array_equal(back["a"], value["a"])
        assert back["b"] == value["b"]
        assert back["a"].dtype == np.int32
    interop.save_t7(str(tmp_path / "p.t7"), value)
    jinterop.save_t7(str(tmp_path / "r.t7"), value)
    assert _read([tmp_path / "p.t7"]) == _read([tmp_path / "r.t7"])


def test_caffe_custom_converter_and_unknown_layer(tmp_path):
    port, _, x = twins("cnn")
    proto, weights = str(tmp_path / "n.prototxt"), str(tmp_path / "n.cm")
    interop.save_caffe(port, proto, weights)
    text = open(proto).read().replace('type: "TanH"', 'type: "MyTanh"')
    open(proto, "w").write(text)
    with pytest.raises(NotImplementedError, match="MyTanh"):
        interop.load_caffe_model(proto, weights)
    m = interop.load_caffe_model(
        proto, weights, custom={"MyTanh": lambda layer, blobs: nn.Tanh()})
    assert rel(port_forward(m, x), port_forward(port, x)) <= TOL["caffe"]


def test_caffe_v1_layers(tmp_path):
    """An old-format net: V1 ``layers`` with enum types and blobs at V1
    field numbers (name 4, blobs 6)."""
    w = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    b = np.random.default_rng(1).normal(size=3).astype(np.float32)
    proto = str(tmp_path / "v1.prototxt")
    open(proto, "w").write(
        'name: "v1"\ninput: "data"\n'
        'layers {\n  name: "ip"\n  type: "InnerProduct"\n  bottom: "data"\n'
        '  top: "ip"\n  inner_product_param {\n    num_output: 3\n  }\n}\n'
        'layers {\n  name: "relu"\n  type: "ReLU"\n  bottom: "ip"\n'
        '  top: "ip"\n}\n')
    blob = lambda a: pw.enc_bytes(6, pw.enc_packed_floats(  # noqa: E731
        5, a.reshape(-1).tolist()) + pw.enc_bytes(7, b"".join(
            pw.enc_varint(1, d) for d in a.shape)))
    layer = pw.enc_str(4, "ip") + blob(w) + blob(b)
    weights = str(tmp_path / "v1.caffemodel")
    open(weights, "wb").write(pw.enc_str(1, "v1") + pw.enc_bytes(2, layer))
    x = np.random.default_rng(2).normal(size=(2, 4)).astype(np.float32)
    got = port_forward(interop.load_caffe_model(proto, weights), x)
    want = np.asarray(jinterop.load_caffe_model(proto, weights).forward(x))
    np.testing.assert_allclose(got, np.maximum(x @ w.T + b, 0), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_tf_trainable_export_variables(tmp_path):
    port, ref, x = twins("mlp_bn")
    path = str(tmp_path / "t.pb")
    interop.save_tf_graph(port, path, x.shape, trainable=True)
    jpath = str(tmp_path / "r.pb")
    jinterop.save_tf_graph(ref, jpath, x.shape, trainable=True)
    assert _read([path]) == _read([jpath])
    g = interop.load_tf_graph(path, ["input"], ["output"])
    names = sorted(k for k, _ in g.named_parameters())
    assert len(names) == 4 and [n.split("_")[0] for n in names] == \
        ["bias", "bias", "weight", "weight"]
    assert rel(port_forward(g, x), port_forward(port, x)) <= TOL["tensorflow"]
    # the variables take gradients
    for p in g.parameters():
        p.requires_grad_(True)
    g(torch.from_numpy(x)).sum().backward()
    assert all(p.grad is not None for p in g.parameters())


# --------------------------------------------------------- protowire
VARINTS = [0, 1, 127, 128, 255, 300, 16383, 16384, 2**31 - 1, 2**31,
           2**32, 2**63 - 1, -1, -2, -(2**31), -(2**63)]


@pytest.mark.parametrize("v", VARINTS)
def test_protowire_varint(v):
    enc = pw.varint(v)
    assert enc == jpw.varint(v)
    got, pos = pw.read_varint(enc, 0)
    assert pos == len(enc) and pw.as_sint(got) == v
    assert jpw.as_sint(jpw.read_varint(enc, 0)[0]) == v


@pytest.mark.parametrize("v", [0, 1, -1, 2, -2, 2**31 - 1, -(2**31),
                               2**62, -(2**62)])
def test_protowire_zigzag(v):
    zz = (v << 1) ^ (v >> 63)
    enc = pw.enc_varint(3, zz)
    assert enc == jpw.enc_varint(3, zz)
    msg = pw.decode_message(enc)
    assert pw.as_zigzag(msg[3][0]) == v == jpw.as_zigzag(msg[3][0])


def test_protowire_packed_and_nested():
    floats = [0.0, -1.5, 3.25, 2.0 ** -100, float("inf")]
    ints = [0, 1, 300, 2**40]
    inner = pw.enc_packed_floats(5, floats) + pw.enc_packed_ints(6, ints) \
        + pw.enc_str(1, "héllo") + pw.enc_double(7, -2.5) \
        + pw.enc_float(8, 0.5)
    outer = pw.enc_bytes(2, inner) + pw.enc_bytes(2, b"") \
        + pw.enc_varint(4, 7)
    jinner = jpw.enc_packed_floats(5, floats) + jpw.enc_packed_ints(6, ints) \
        + jpw.enc_str(1, "héllo") + jpw.enc_double(7, -2.5) \
        + jpw.enc_float(8, 0.5)
    assert outer == jpw.enc_bytes(2, jinner) + jpw.enc_bytes(2, b"") \
        + jpw.enc_varint(4, 7)
    m = pw.decode_message(outer)
    assert m == jpw.decode_message(outer)
    sub = pw.decode_message(m[2][0])
    assert pw.unpack_packed(sub[5][0], "float") == floats
    assert pw.ints(sub, 6) == ints
    assert pw.as_str(sub[1][0]) == "héllo"
    assert pw.as_double(sub[7][0]) == -2.5 and pw.as_float(sub[8][0]) == 0.5
    assert pw.decode_message(m[2][1]) == {}
    with pytest.raises(ValueError, match="wire type"):
        pw.decode_message(bytes([0x0B]))  # a group start


# ------------------------------------------------ convert_model and deploy
def _cli(module, args):
    out = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


CONVERSIONS = [("bigdl", "bigdl", []), ("bigdl", "torch", []),
               ("bigdl", "caffe", []), ("torch", "bigdl", []),
               ("caffe", "bigdl", []), ("tensorflow", "bigdl", []),
               ("bigdl", "bigdl", ["--quantize", "--quantize-mode",
                                   "weight_only", "--quantize-tolerance",
                                   "0.5"]),
               ("bigdl", "bigdl", ["--quantize", "--quantize-mode",
                                   "dynamic", "--quantize-tolerance", "0.5"])]


@pytest.mark.parametrize("src,dst,extra", CONVERSIONS)
def test_convert_model_matches_reference(src, dst, extra, tmp_path, capsys):
    """The port's CLI (``--device cpu``) and the reference's on the same
    source file write the same bytes."""
    from bigdl_tpu.interop import convert_model as jconvert
    from bigdl_tpu_torch.interop import convert_model
    name = {"tensorflow": "cnn_tf"}.get(src, "cnn")
    if dst == "caffe":
        name = "graph_shared"
    port, ref, x = twins(name)
    src_files = ref_save(src, ref, str(tmp_path), x.shape)
    args = ["--from", src, "--to", dst, "--input", src_files[-1]] + extra
    if src == "caffe":
        args += ["--prototxt", src_files[0]]
    if src == "tensorflow":
        args += ["--tf_inputs", "input", "--tf_outputs", "output"]
    outs = {}
    for main, tag in ((convert_model.main, "port"), (jconvert.main, "ref")):
        out = str(tmp_path / f"{tag}.out")
        main(args + ["--output", out]
             + (["--device", "cpu"] if tag == "port" else []))
        if extra:
            assert "quantize parity" in capsys.readouterr().out
        outs[tag] = _read([out] + ([out + ".prototxt"] if dst == "caffe"
                                   else []))
    assert outs["port"] == outs["ref"]


def test_convert_model_command_line(tmp_path):
    """``python -m bigdl_tpu_torch.interop.convert_model`` as a command."""
    port, _, x = twins("cnn")
    src = str(tmp_path / "m.bigdl")
    interop.save_bigdl_module(port, src)
    stdout = _cli("bigdl_tpu_torch.interop.convert_model", [
        "--from", "bigdl", "--to", "torch", "--input", src, "--output",
        str(tmp_path / "m.t7"), "--device", "cpu"])
    assert "converted" in stdout
    back = interop.load_torch_module(str(tmp_path / "m.t7"))
    np.testing.assert_array_equal(port_forward(back, x), port_forward(port, x))


def test_convert_model_parity_gate_and_device(tmp_path):
    port, _, x = twins("cnn")
    src = str(tmp_path / "m.bigdl")
    interop.save_bigdl_module(port, src)
    from bigdl_tpu_torch.interop import convert_model
    with pytest.raises(SystemExit, match="parity check FAILED"):
        convert_model.main(["--from", "bigdl", "--to", "bigdl", "--input",
                            src, "--output", str(tmp_path / "q.bigdl"),
                            "--quantize", "--quantize-tolerance", "0",
                            "--device", "cpu"])
    assert not os.path.exists(tmp_path / "q.bigdl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert_model.main(["--from", "bigdl", "--to", "bigdl",
                                "--input", src, "--output",
                                str(tmp_path / "o.bigdl")])
    # --from keras reads a Keras JSON definition: a .bigdl file is none
    with pytest.raises(SystemExit, match="--from keras"):
        convert_model.main(["--from", "keras", "--to", "bigdl", "--input",
                            src, "--output", str(tmp_path / "k.bigdl"),
                            "--device", "cpu"])
    assert not os.path.exists(tmp_path / "k.bigdl")


@pytest.mark.parametrize("fmt,name", [("bigdl", "cnn"), ("torch", "cnn"),
                                      ("caffe", "graph_bottleneck"),
                                      ("tensorflow", "bottleneck")])
def test_deploy_from_file_matches_reference_deploy(fmt, name, tmp_path):
    from bigdl_tpu.serving import ModelRegistry as JaxRegistry
    from bigdl_tpu_torch.serving import ModelRegistry
    port, ref, x = twins(name)
    files = ref_save(fmt, ref, str(tmp_path), x.shape)
    kw = {"path": files[-1], "format": fmt}
    if fmt == "caffe":
        kw["prototxt"] = files[0]
    if fmt == "tensorflow":
        kw.update(tf_inputs=["input"], tf_outputs=["output"])
    with ModelRegistry(device="cpu") as reg:
        reg.deploy("m", **kw)
        got = reg.predict("m", x, timeout=120)
    jreg = JaxRegistry()
    try:
        jreg.deploy("m", **kw)
        want = np.asarray(jreg.predict("m", x, timeout=120))
    finally:
        jreg.stop_all()
    assert got.shape == want.shape
    assert rel(got, want) <= TOL[fmt]


def _keras_layer(cls, **cfg):
    return {"class_name": cls, "config": cfg}


# LeNet-5 as a Keras-1.2 JSON (softmax where the port's ends in LogSoftMax)
KERAS_LENET_JSON = {"class_name": "Sequential", "config": [
    _keras_layer("Reshape", target_shape=[1, 28, 28],
                 batch_input_shape=[None, 1, 28, 28]),
    _keras_layer("Convolution2D", nb_filter=6, nb_row=5, nb_col=5,
                 activation="tanh"),
    _keras_layer("MaxPooling2D", pool_size=[2, 2]),
    _keras_layer("Convolution2D", nb_filter=12, nb_row=5, nb_col=5,
                 activation="tanh"),
    _keras_layer("MaxPooling2D", pool_size=[2, 2]),
    _keras_layer("Reshape", target_shape=[192]),
    _keras_layer("Dense", output_dim=100, activation="tanh"),
    _keras_layer("Dense", output_dim=10, activation="softmax")]}


def keras_lenet_weights(model):
    """``model``'s (a port LeNet-5) weights in Keras order: conv kernels
    as they are, Dense kernels (in, out)."""
    out = []
    for m in model.modules():
        if isinstance(m, (nn.SpatialConvolution, nn.Linear)):
            w = m.weight.detach().numpy()
            out += [w.T.copy() if w.ndim == 2 else w,
                    m.bias.detach().numpy()]
    return out


def test_deploy_quantize_and_keras(tmp_path):
    from bigdl_tpu_torch.serving import ModelRegistry
    port, _, x = twins("lenet")
    path = str(tmp_path / "l.bigdl")
    interop.save_bigdl_module(port, path)
    with ModelRegistry(device="cpu") as reg:
        svc = reg.deploy("q", path=path, format="bigdl", quantize="dynamic")
        got = reg.predict("q", x, timeout=120)
        assert svc.stats()["weights_dtype"] == "int8"
        # a Keras JSON LeNet with the same weights in Keras order
        kpath = str(tmp_path / "l.json")
        with open(kpath, "w") as f:
            json.dump(KERAS_LENET_JSON, f)
        reg.deploy("k", path=kpath, format="keras",
                   weights=keras_lenet_weights(port))
        got_k = reg.predict("k", x, timeout=120)
    want = port_forward(quantize(port, mode="dynamic"), x)
    np.testing.assert_array_equal(got, want)
    want_k = port_forward(port, x)
    np.testing.assert_allclose(got_k, np.exp(want_k), rtol=1e-5,
                               atol=1e-6)


def test_deep_graph_copies_and_quantizes():
    """A Graph whose node chain is deeper than Python's recursion limit
    allows a recursive copy of: ``copy.deepcopy`` and ``quantize`` (which
    copies a Graph whole, as the reference keeps it float) keep its ties."""
    import copy
    inp = nn.Input()
    shared = nn.Linear(4, 4)
    h = shared(inp)
    for i in range(400):
        h = nn.Tanh()(h)
    out = shared(h)
    g = nn.Graph([inp], [out]).initialize(0)
    for dup in (copy.deepcopy(g), quantize(g)):
        assert dup._order[0].module is dup._order[-1].module
        assert dup._order[0].module is not shared
        x = torch.randn(2, 4)
        torch.testing.assert_close(dup(x), g(x), rtol=0, atol=0)

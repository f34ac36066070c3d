"""The port's TF op registry and GraphDef importer against the JAX
reference, on the CPU.

Every registered op runs on the same numpy inputs in both registries
(one or more parametrised cases each); results agree within ``rtol=2e-5,
atol=2e-6`` for floats and exactly for integers and booleans, with the
same dtype.  The random ops cannot match JAX's generator: they are held
to shape, dtype, same-seed determinism, per-node seeds and the first two
moments.  Hand-built GraphDefs (``torch_tfgraph_util``, written with the
port's protowire) run through both importers.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu.dataset.tfrecord import encode_example  # noqa: E402
from bigdl_tpu.interop import load_tf_graph as jload_tf_graph  # noqa: E402
from bigdl_tpu.interop.tf_format import (  # noqa: E402
    parse_graphdef_text as jparse_text)
from bigdl_tpu.ops.registry import OPS as JOPS  # noqa: E402

from bigdl_tpu_torch.interop import load_tf_graph  # noqa: E402
from bigdl_tpu_torch.interop.tf_format import (  # noqa: E402
    parse_graphdef_binary, parse_graphdef_text)
from bigdl_tpu_torch.ops.registry import OPS  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tfgraph_util as tg  # noqa: E402

RTOL, ATOL = 2e-5, 2e-6
R = np.random.default_rng(0)


def f(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def i32(*vals):
    return np.asarray(vals, np.int32)


def b(*shape):
    return R.uniform(size=shape) > 0.5


def _image_bytes(fmt, channels=3):
    from PIL import Image
    arr = (R.uniform(size=(5, 7, channels)) * 255).astype(np.uint8)
    img = Image.fromarray(arr[..., 0] if channels == 1 else arr)
    buf = io.BytesIO()
    if fmt == "GIF":
        frames = [img, Image.fromarray(255 - np.asarray(img))]
        frames[0].save(buf, format="GIF", save_all=True,
                       append_images=frames[1:])
    else:
        img.save(buf, format=fmt)
    return buf.getvalue()


# (op, attrs, inputs): the reference and the port see the same inputs
CASES = []


def case(op, attrs, *inputs, name=None):
    CASES.append(pytest.param(op, attrs, inputs, id=name or op))


for _op in ("Identity", "StopGradient", "PreventGradient"):
    case(_op, {}, f(2, 3))
case("Cast", {"DstT": 3}, f(2, 3) * 10, name="Cast-int")
case("Cast", {"DstT": 10}, f(2, 3), name="Cast-bool")
case("Cast", {"DstT": 1}, i32(1, -2, 3), name="Cast-float")
for _op in ("Add", "AddV2", "Sub", "Mul", "RealDiv", "Div", "Maximum",
            "Minimum", "SquaredDifference", "Equal", "NotEqual", "Greater",
            "GreaterEqual", "Less", "LessEqual"):
    case(_op, {}, f(2, 3), f(2, 3) + 2.0)
case("Add", {}, f(2, 3), np.float32(0.5), name="Add-scalar")
case("Add", {}, i32(1, 2, 3), i32(4, 5, 6), name="Add-int")
case("Pow", {}, f(2, 3, lo=0.5, hi=2.0), f(2, 3))
case("FloorDiv", {}, f(2, 3) * 5, f(2, 3, lo=0.5, hi=2.0))
case("FloorDiv", {}, i32(7, -7, 5), i32(2, 2, -3), name="FloorDiv-int")
case("Mod", {}, f(2, 3) * 5, f(2, 3, lo=0.5, hi=2.0))
case("Mod", {}, i32(7, -7, 5), i32(2, 2, -3), name="Mod-int")
case("LogicalAnd", {}, b(2, 3), b(2, 3))
case("LogicalOr", {}, b(2, 3), b(2, 3))
for _op in ("Neg", "Abs", "Exp", "Square", "Floor", "Ceil", "Sign",
            "Tanh", "Sigmoid", "Relu", "Elu", "Softplus", "Softsign", "Erf",
            "Selu", "Expm1", "Erfc", "Rint", "Sin", "Cos", "Tan", "Atan",
            "Sinh", "Cosh"):
    case(_op, {}, f(3, 4) * 3)
case("Relu6", {}, f(3, 4) * 8)
case("Round", {}, np.asarray([-2.5, -1.5, -0.5, 0.5, 1.5, 2.4, 2.6],
                             np.float32))
for _op in ("Log", "Sqrt", "Rsqrt", "Reciprocal", "Lgamma", "Digamma",
            "Inv"):
    case(_op, {}, f(3, 4, lo=0.2, hi=4.0))
case("Log1p", {}, f(3, 4, lo=-0.5, hi=3.0))
case("Asin", {}, f(3, 4, lo=-0.99, hi=0.99))
case("Acos", {}, f(3, 4, lo=-0.99, hi=0.99))
case("LogicalNot", {}, b(2, 3))
_special = np.asarray([0.5, np.nan, np.inf, -np.inf, -1.0], np.float32)
for _op in ("IsNan", "IsInf", "IsFinite"):
    case(_op, {}, _special)
case("AddN", {}, f(2, 3), f(2, 3), f(2, 3))
case("MatMul", {"transpose_b": True}, f(2, 3), f(4, 3))
case("MatMul", {"transpose_a": True}, f(3, 2), f(3, 4), name="MatMul-ta")
case("BatchMatMul", {}, f(2, 3, 4), f(2, 4, 5))
case("BatchMatMulV2", {"adj_x": True, "adj_y": True}, f(2, 4, 3),
     f(2, 5, 4))
case("Softmax", {}, f(3, 5) * 4)
case("LogSoftmax", {}, f(3, 5) * 4)
case("L2Loss", {}, f(3, 5))
case("Select", {}, b(2, 3), f(2, 3), f(2, 3))
case("SelectV2", {}, b(2, 3), f(2, 3), f(2, 3))
for _op in ("Sum", "Mean", "Max", "Min", "Prod"):
    case(_op, {"keep_dims": True}, f(2, 3, 4), i32(1, -1))
    case(_op, {}, f(2, 3, 4), i32(0), name=f"{_op}-drop")
case("Sum", {}, f(2, 3), np.zeros(0, np.int32), name="Sum-all")
case("Mean", {}, i32(1, 2, 4), i32(0), name="Mean-int")
# torch widens integer sums and products to int64; the reference keeps
# int32 (uint32 for unsigned inputs)
case("Sum", {}, np.int32([[1, 5, 3], [2, 2, 2]]), np.int32(1), name="Sum-int")
case("Prod", {}, np.int32([[1, 5, 3], [2, 2, 2]]), np.int32(1),
     name="Prod-int")
case("Sum", {}, np.asarray([[True, False, True], [True, True, False]]),
     np.int32(1), name="Sum-bool")
case("Sum", {}, np.uint8([[1, 5, 3], [200, 2, 2]]), np.int32(1),
     name="Sum-uint8")
case("Square", {}, np.asarray([True, False, True]), name="Square-bool")
case("Rint", {}, np.int32([1, -2, 7]), name="Rint-int")
case("Cumsum", {}, np.asarray([True, False, True, True]), np.int32(0),
     name="Cumsum-bool")
case("Cumsum", {"exclusive": True}, np.asarray([True, False, True, True]),
     np.int32(0), name="Cumsum-bool-exclusive")
for _op in ("All", "Any"):
    case(_op, {"keepdims": True}, b(3, 4), i32(1))
case("ArgMax", {}, f(3, 5), np.int32(1))
case("ArgMin", {}, f(3, 5), np.int32(0))
case("Reshape", {}, f(2, 6), i32(3, -1))
case("Squeeze", {"squeeze_dims": [1]}, f(2, 1, 3, 1))
case("Squeeze", {}, f(2, 1, 3, 1), name="Squeeze-all")
case("ExpandDims", {}, f(2, 3), np.int32(-1))
case("Shape", {}, f(2, 3, 4))
case("Rank", {}, f(2, 3, 4))
case("Size", {}, f(2, 3, 4))
case("Fill", {}, i32(2, 3), np.float32(1.5))
case("Pack", {"axis": 1}, f(2, 3), f(2, 3))
case("Unpack", {"axis": 1}, f(3, 2))
case("ConcatV2", {}, f(2, 3), f(2, 2), np.int32(1))
case("Concat", {}, np.int32(0), f(2, 3), f(1, 3))
case("Slice", {}, f(4, 5), i32(1, 0), i32(2, -1))
case("StridedSlice", {"shrink_axis_mask": 1}, f(4, 5, 6), i32(1, 0, 5),
     i32(3, 5, 0), i32(1, 2, -2))
case("StridedSlice", {"begin_mask": 2, "end_mask": 4}, f(4, 5, 6),
     i32(-3, 3, 1), i32(-1, 0, 0), i32(1, 1, 2), name="StridedSlice-masks")
case("Transpose", {}, f(2, 3, 4), i32(2, 0, 1))
case("Pad", {}, f(2, 3), i32(1, 0, 0, 2).reshape(2, 2))
case("PadV2", {}, f(2, 3), i32(1, 1, 2, 0).reshape(2, 2), np.float32(3.0))
case("Tile", {}, f(2, 3), i32(2, 1))
case("Gather", {}, f(5, 3), np.asarray([[0, 4], [2, 2]], np.int32))
case("GatherV2", {}, f(5, 3), i32(2, 0), np.int32(1))
case("OneHot", {}, i32(0, 2, 1), np.int32(4), np.float32(2.0),
     np.float32(-1.0))
case("BiasAdd", {"data_format": b"NCHW"}, f(2, 3, 4, 4), f(3))
case("BiasAdd", {}, f(2, 4, 4, 3), f(3), name="BiasAdd-nhwc")
case("BiasAddV1", {}, f(2, 4, 3), f(3))
case("Conv2D", {"strides": [1, 2, 2, 1], "padding": b"SAME"},
     f(2, 7, 7, 3), f(3, 3, 3, 4))
case("Conv2D", {"strides": [1, 1, 1, 1], "padding": b"SAME",
                "dilations": [1, 2, 2, 1]}, f(1, 6, 6, 2), f(3, 3, 2, 3),
     name="Conv2D-dilated")
case("Conv2D", {"strides": [1, 1, 2, 2], "padding": b"VALID",
                "data_format": b"NCHW"}, f(2, 3, 7, 7), f(3, 3, 3, 4),
     name="Conv2D-nchw")
case("DepthwiseConv2dNative", {"strides": [1, 1, 1, 1],
                               "padding": b"SAME"},
     f(2, 6, 6, 3), f(3, 3, 3, 2))
case("DepthwiseConv2dNative", {"strides": [1, 1, 2, 2], "padding": b"VALID",
                               "data_format": b"NCHW"},
     f(1, 3, 7, 7), f(2, 2, 3, 1), name="DepthwiseConv2dNative-nchw")
for _op in ("MaxPool", "AvgPool"):
    case(_op, {"ksize": [1, 3, 3, 1], "strides": [1, 2, 2, 1],
               "padding": b"SAME"}, f(2, 8, 7, 3))
    case(_op, {"ksize": [1, 1, 2, 2], "strides": [1, 1, 2, 2],
               "padding": b"VALID", "data_format": b"NCHW"},
         f(2, 3, 5, 6), name=f"{_op}-nchw")
for _op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
    case(_op, {"epsilon": 1e-3}, f(2, 4, 4, 3), f(3), f(3), f(3),
         f(3, lo=0.5, hi=2.0))
case("FusedBatchNorm", {"data_format": b"NCHW"}, f(2, 3, 4, 4), f(3),
     f(3), f(3), f(3, lo=0.5, hi=2.0), name="FusedBatchNorm-nchw")
_labels = np.abs(f(4, 5))
case("SoftmaxCrossEntropyWithLogits", {}, f(4, 5) * 3,
     _labels / _labels.sum(-1, keepdims=True))
case("TruncateDiv", {}, i32(7, -7, 5, -9), i32(2, 2, -3, 4))
case("TruncateDiv", {}, f(2, 3) * 5, f(2, 3, lo=0.5, hi=2.0),
     name="TruncateDiv-float")
case("TruncateMod", {}, f(2, 3) * 5, f(2, 3, lo=0.5, hi=2.0))
case("FloorMod", {}, i32(7, -7, 5, -9), i32(2, 2, -3, 4))
case("Range", {}, np.int32(2), np.int32(10), np.int32(3))
case("Range", {}, np.float32(0.5), np.float32(2.0), np.float32(0.25),
     name="Range-float")
case("LinSpace", {}, np.float32(-1.0), np.float32(1.0), np.int32(5))
_ties = np.asarray([[1., 5., 3., 5., 2., 3.], [0., 0., 1., 0., 1., 2.]],
                   np.float32)
case("TopK", {"k": 3}, _ties)
case("TopKV2", {}, _ties, np.int32(4))
_pred = np.asarray([[0.1, 0.9, 0.0, 0.5], [0.8, 0.1, 0.1, 0.1],
                    [0.3, np.nan, 0.2, 0.1]], np.float32)
case("InTopK", {"k": 2}, _pred, i32(3, 2, 0))
case("InTopKV2", {}, _pred, i32(1, 1, 0), np.int32(1))
case("Split", {"num_split": 3}, np.int32(1), f(2, 6))
case("SplitV", {}, f(2, 6), i32(1, -1, 2), np.int32(1))
case("SegmentSum", {}, f(4, 3), i32(0, 0, 1, 3))
case("UnsortedSegmentSum", {}, f(4, 3), i32(2, 0, 2, 1), np.int32(3))
case("UnsortedSegmentSum", {}, f(5), i32(1, 0, 1, 4, 0), np.int32(3),
     name="UnsortedSegmentSum-vector")
case("Cumsum", {"exclusive": True, "reverse": True}, f(2, 4), np.int32(1))
case("Cumsum", {}, f(3, 2), np.int32(0), name="Cumsum-plain")
case("LRN", {"depth_radius": 2, "bias": 1.0, "alpha": 0.5, "beta": 0.75},
     f(1, 2, 2, 6))
case("Conv3D", {"strides": [1, 1, 2, 1, 1], "padding": b"SAME"},
     f(1, 4, 5, 4, 2), f(2, 3, 2, 2, 3))
case("ResizeBilinear", {}, f(1, 3, 4, 2), i32(5, 7))
case("ResizeBilinear", {"align_corners": True}, f(1, 3, 4, 2), i32(5, 3),
     name="ResizeBilinear-aligned")
case("ResizeNearestNeighbor", {}, f(1, 3, 4, 2), i32(5, 7))
case("ResizeNearestNeighbor", {"align_corners": True}, f(1, 3, 4, 2),
     i32(6, 2), name="ResizeNearestNeighbor-aligned")
case("ReverseV2", {}, f(2, 3, 4), i32(0, 2))
case("InvertPermutation", {}, i32(2, 0, 3, 1))
case("Where", {}, b(3, 4))
case("DecodeRaw", {"out_type": 1}, np.asarray(
    [f(6).tobytes(), f(6).tobytes()], object))
case("DecodeRaw", {"out_type": 5, "little_endian": False},
     np.asarray([1, -2, 300], ">i2").tobytes(), name="DecodeRaw-bigendian")
case("DecodePng", {}, _image_bytes("PNG"))
case("DecodeJpeg", {"channels": 1}, _image_bytes("JPEG"))
case("DecodeImage", {}, _image_bytes("PNG", 1))
case("DecodeImage", {"dtype": 1, "expand_animations": False},
     _image_bytes("GIF"), name="DecodeImage-gif")
case("DecodeGif", {}, _image_bytes("GIF"))
case("ApproximateEqual", {"tolerance": 0.01}, f(3, 4),
     f(3, 4) * 0.0 + 0.2)
case("Dilation2D", {"strides": [1, 2, 2, 1], "rates": [1, 1, 1, 1],
                    "padding": b"SAME"}, f(1, 5, 5, 2), f(3, 3, 2))
case("Dilation2D", {"strides": [1, 1, 1, 1], "rates": [1, 2, 2, 1],
                    "padding": b"VALID"}, f(1, 6, 6, 2), f(2, 2, 2),
     name="Dilation2D-valid")
case("Substr", {}, np.asarray([b"hello", b"tensor"], object), i32(1, 2),
     i32(3, 10))
case("Assert", {}, np.asarray(True), f(2))
case("NoOp", {})
case("ParseExample", {"Nsparse": 0, "Ndense": 2, "dense_shapes": [[2], [1]]},
     np.asarray([encode_example({"x": np.asarray([1., 2.], np.float32),
                                 "y": np.asarray([5], np.int64)}),
                 encode_example({"x": np.asarray([3., 4.], np.float32),
                                 "y": np.asarray([-7], np.int64)})],
                object),
     np.asarray([b"", b""], object), np.asarray(b"x", object),
     np.asarray(b"y", object))

RANDOM = ("RandomUniform", "RandomStandardNormal", "TruncatedNormal",
          "RandomShuffle")
TENSOR_ARRAY = ("TensorArrayV3", "TensorArrayWriteV3", "TensorArrayReadV3",
                "TensorArrayGatherV3", "TensorArrayScatterV3",
                "TensorArraySizeV3", "TensorArrayCloseV3")


def _flat(out):
    return list(out) if isinstance(out, tuple) else [out]


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def test_registries_hold_the_same_ops():
    assert set(OPS) == set(JOPS)
    covered = {p.values[0] for p in CASES} | set(RANDOM) | set(TENSOR_ARRAY)
    assert covered == set(OPS), sorted(set(OPS) - covered)


@pytest.mark.parametrize("op,attrs,inputs", CASES)
def test_op_matches_reference(op, attrs, inputs):
    want = _flat(JOPS[op]({**attrs, "_node_name": "n"}, *inputs))
    got = _flat(OPS[op]({**attrs, "_node_name": "n"}, *inputs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _as_np(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype == object:
            assert g.tolist() == w.tolist()
            continue
        # torch holds native byte order only (DecodeRaw's big-endian case)
        assert g.dtype == w.dtype.newbyteorder("="), (g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(g, w)


# moments of 20,000 draws: (mean, variance); the truncated normal's
# variance is 1 - 2*2*phi(2)/(Phi(2)-Phi(-2)) = 0.7737
MOMENTS = {"RandomUniform": (0.5, 1 / 12), "RandomStandardNormal": (0.0, 1.0),
           "TruncatedNormal": (0.0, 0.7737)}


@pytest.mark.parametrize("op", sorted(MOMENTS))
def test_random_op(op):
    attrs = {"seed": 3, "seed2": 4, "_node_name": "init/random"}
    a = OPS[op](attrs, i32(200, 100))
    assert a.shape == (200, 100) and a.dtype == torch.float32
    torch.testing.assert_close(a, OPS[op](dict(attrs), i32(200, 100)),
                               rtol=0, atol=0)  # same seed, same draw
    other = OPS[op]({**attrs, "_node_name": "init/other"}, i32(200, 100))
    assert not torch.equal(a, other)  # seeded per node, as the reference
    ref = np.asarray(JOPS[op](attrs, i32(200, 100)))
    mean, var = MOMENTS[op]
    for v in (a.numpy(), ref):
        assert abs(v.mean() - mean) < 0.02
        assert abs(v.var() - var) < 0.03 * max(var, 0.1)
    if op == "TruncatedNormal":
        assert a.abs().max() <= 2.0


def test_random_shuffle():
    x = np.arange(50, dtype=np.float32).reshape(25, 2)
    attrs = {"seed": 1, "_node_name": "shuffle"}
    got = OPS["RandomShuffle"](attrs, x)
    assert sorted(got[:, 0].tolist()) == x[:, 0].tolist()
    torch.testing.assert_close(got[:, 1] - got[:, 0], torch.ones(25))
    assert torch.equal(got, OPS["RandomShuffle"](dict(attrs), x))
    assert not torch.equal(got, torch.from_numpy(x))


def test_tensor_array_ops():
    """The TensorArray family, call by call, against the reference's."""
    outs = {}
    for reg, tag in ((OPS, "port"), (JOPS, "ref")):
        handle, flow = reg["TensorArrayV3"]({"dtype": 1, "_node_name": "ta"},
                                            np.int32(4))
        flow = reg["TensorArrayScatterV3"]({}, handle, i32(0, 2),
                                           np.stack([f(3) * 0 + 1,
                                                     f(3) * 0 + 2]), flow)
        flow = reg["TensorArrayWriteV3"]({}, handle, np.int32(3),
                                         np.asarray([7., 8., 9.],
                                                    np.float32), flow)
        outs[tag] = [reg["TensorArrayReadV3"]({}, handle, np.int32(3), flow),
                     reg["TensorArrayGatherV3"]({}, handle, i32(3, 0, 1),
                                                flow),
                     reg["TensorArraySizeV3"]({}, handle, flow),
                     reg["TensorArrayCloseV3"]({}, handle)]
    for g, w in zip(outs["port"], outs["ref"]):
        np.testing.assert_array_equal(_as_np(g), np.asarray(w))
    _, pending = OPS["TensorArrayV3"]({"dtype": 1}, np.int32(2))
    with pytest.raises(NotImplementedError, match="before any write"):
        OPS["TensorArrayReadV3"]({}, None, np.int32(0), pending)


def test_ops_follow_the_card_device_rule():
    """Host constants meet a tensor on its device: the result lives where
    the tensor lives (the CPU here; the card in the GPU tests)."""
    x = torch.from_numpy(f(2, 3))
    out = OPS["Add"]({}, np.float32(1.0), x)
    assert out.device == x.device and out.dtype == torch.float32
    out = OPS["Pad"]({}, x, i32(1, 1, 0, 0).reshape(2, 2))
    assert out.shape == (4, 3)


# ----------------------------------------------------- hand-built graphs
def _both(tmp_path, graph, inputs, outputs, name="g.pb"):
    p = str(tmp_path / name)
    open(p, "wb").write(graph)
    return load_tf_graph(p, inputs, outputs), jload_tf_graph(p, inputs,
                                                             outputs)


def _run_both(port, ref, feed):
    got = port({k: torch.as_tensor(v) for k, v in feed.items()})
    want, _ = ref.apply(ref._params, ref._state, feed)
    return _flat(got), [np.asarray(w) for w in _flat(want)]


@pytest.mark.parametrize("pred", [True, False])
def test_switch_merge(pred, tmp_path):
    port, ref = _both(tmp_path, tg.cond_graph(), ["x", "pred"], ["out"])
    x = f(3)
    got, want = _run_both(port, ref, {"x": x, "pred": np.asarray(pred)})
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(want[0], x * 2 if pred else x + 1, rtol=1e-6)


def test_two_variable_while(tmp_path):
    port, ref = _both(tmp_path, tg.while_graph(), ["i0", "acc0"],
                      ["out", "i_exit"])
    got, want = _run_both(port, ref, {"i0": np.float32(1.0),
                                      "acc0": np.float32(3.0)})
    assert [float(g) for g in got] == [float(w) for w in want] == [48.0, 5.0]


def test_nested_while_frames(tmp_path):
    port, ref = _both(tmp_path, tg.nested_loop_graph(), ["acc0", "w"],
                      ["out", "i_exit"])
    feed = {"acc0": f(2, 3), "w": f(3)}
    got, want = _run_both(port, ref, feed)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert float(got[1]) == float(want[1]) == 3.0
    acc = feed["acc0"]
    for _ in range(6):
        acc = acc * np.float32(2) + feed["w"]
    np.testing.assert_array_equal(got[0].numpy(), acc)


def test_tensor_array_rnn_loop_and_gradient(tmp_path):
    rng = np.random.default_rng(1)
    T, B, I, H = 5, 3, 4, 6
    g, W, U = tg.dynrnn_graph(T, B, I, H, rng)
    port, ref = _both(tmp_path, g, ["x"], ["out"])
    x = rng.normal(0, 1, (T, B, I)).astype(np.float32)
    got, want = _run_both(port, ref, {"x": x})
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=2e-5,
                               atol=2e-5)
    h, ys = np.zeros((B, H), np.float32), []
    for t in range(T):
        h = np.tanh(x[t] @ W + h @ U)
        ys.append(h)
    np.testing.assert_allclose(got[0].numpy(), np.stack(ys), rtol=2e-5,
                               atol=2e-5)
    # autograd runs through the loop and the TensorArray reads and writes
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) ** 2).sum().backward()
    gref = jax.grad(lambda v: (ref.apply({}, {}, {"x": v})[0] ** 2).sum())(x)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gref), rtol=1e-4,
                               atol=1e-5)


def test_port_suffixed_feed(tmp_path):
    g = (tg.node("x", "Placeholder") + tg.node("y", "Relu", ["x:0"]))
    port, ref = _both(tmp_path, g, ["x:0"], ["y"])
    x = f(2, 3)
    got = port({"x:0": torch.from_numpy(x)})
    np.testing.assert_array_equal(got.numpy(), np.maximum(x, 0))
    np.testing.assert_array_equal(port(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref.forward(x)))


def test_unsupported_masks_raise(tmp_path):
    from bigdl_tpu_torch.utils import protowire as pw
    mask = pw.enc_varint(3, 1)
    g = (tg.node("x", "Placeholder")
         + tg.node("b", "Const", value=tg.shape_const([0]))
         + tg.node("s", "StridedSlice", ["x", "b", "b", "b"],
                   ellipsis_mask=mask))
    p = str(tmp_path / "m.pb")
    open(p, "wb").write(g)
    m = load_tf_graph(p, ["x"], ["s"])
    with pytest.raises(NotImplementedError, match="ellipsis_mask"):
        m(torch.zeros(2, 3))


def test_loop_interior_output_rejected_and_malformed_frame(tmp_path):
    p = str(tmp_path / "w.pb")
    open(p, "wb").write(tg.while_graph())
    with pytest.raises(NotImplementedError, match="inside while frame"):
        load_tf_graph(p, ["i0", "acc0"], ["i_mrg"])
    g = (tg.node("x", "Placeholder") + tg.node("y", "Identity", ["x"])
         + tg.node("stray", "Enter", ["x"]))
    open(p, "wb").write(g)
    m = load_tf_graph(p, ["x"], ["y"])
    np.testing.assert_array_equal(m(torch.ones(2)).numpy(), [1.0, 1.0])
    open(p, "wb").write(tg.node("x", "Placeholder")
                        + tg.node("y", "NoSuchOp", ["x"]))
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        load_tf_graph(p, ["x"], ["y"])(torch.ones(2))


def test_static_and_dynamic_trip_counts_agree(tmp_path):
    """The nested graph's loops have const counters (static trip counts);
    the two-variable graph's counter is fed (evaluated condition)."""
    from bigdl_tpu_torch.interop.tf_loops import static_trip_count
    port, _ = _both(tmp_path, tg.nested_loop_graph(4.0, 3.0), ["acc0", "w"],
                    ["out"])
    trips = sorted(static_trip_count(fr, port.by_name, port._try_const_eval)
                   for fr in port._frames.values())
    assert trips == [3, 4]
    port2, _ = _both(tmp_path, tg.while_graph(), ["i0", "acc0"], ["out"],
                     name="w.pb")
    assert [static_trip_count(fr, port2.by_name, port2._try_const_eval)
            for fr in port2._frames.values()] == [None]


def test_text_and_binary_graphdefs_parse_alike():
    text = '''
node { name: "x" op: "Placeholder"
       attr { key: "dtype" value { type: DT_FLOAT } } }
node { name: "w" op: "Const"
       attr { key: "value" value { tensor { dtype: DT_FLOAT
              tensor_shape { dim { size: 2 } } float_val: 1.5
              float_val: -2 } } } }
node { name: "y" op: "Mul" input: "x" input: "w"
       attr { key: "T" value { type: DT_FLOAT } }
       attr { key: "strides" value { list { i: 1 i: 2 } } } }
'''
    got, want = parse_graphdef_text(text), jparse_text(text)
    assert [n["name"] for n in got] == [n["name"] for n in want]
    np.testing.assert_array_equal(got[1]["attrs"]["value"],
                                  want[1]["attrs"]["value"])
    assert got[2]["attrs"]["strides"] == [1, 2]
    binary = (tg.node("x", "Placeholder")
              + tg.node("w", "Const", value=tg.attr_tensor([1.5, -2.0]))
              + tg.node("y", "Mul", ["x", "w"]))
    nodes = parse_graphdef_binary(binary)
    np.testing.assert_array_equal(nodes[1]["attrs"]["value"],
                                  got[1]["attrs"]["value"])

"""BigDL protobuf model files: reader and writer (port of
``bigdl_tpu/interop/bigdl_format.py``).

A model file is ONE serialized ``BigDLModule`` message (the reference's
``bigdl.proto`` schema), decoded and encoded with the generic wire codec
of ``utils/protowire``:

- ``moduleType`` (field 7) is the Scala class name
  (``com.intel.analytics.bigdl.nn.Linear``); the attribute keys (field 8
  map) are its constructor parameter names;
- ``hasParameters``/``parameters`` (fields 15/16) carry the tensors in the
  reference's ``parameters()`` order, weight then bias; a convolution's
  weight is stored (nGroup, out/g, in/g, kH, kW);
- tensors point at storages by id; the first occurrence carries the data.
  The writer takes ids from a counter, so its output is deterministic and
  byte-identical to the reference package's for the same weights;
- BatchNorm's running statistics ride as the ``runningMean``/
  ``runningVar`` tensor attributes, max pooling's ``ceil_mode`` as an
  attribute, per-layer penalties as ``wRegularizer``/``bRegularizer``;
- a ``Graph`` is written as the reference's ``StaticGraph``: sub-modules
  with ``preModules``/``nextModules`` edges, one name per occurrence and
  one ``id`` (field 12) per module instance; only the first occurrence of
  a shared module carries its weights;
- the int8 twins store ``weight_q`` as an f32 tensor (exact: -127..127),
  then ``weight_scale`` and the bias, with their mode in ``quantMode``.

The loader builds port modules on the CPU with the file's weights; move
the model to its device afterwards.  A ``DynamicGraph`` loads as a
``DynamicGraph`` (``nn/graph.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.graph import DynamicGraph, Graph, Input
from bigdl_tpu_torch.nn.module import Module, Remat
from bigdl_tpu_torch.utils import protowire as pw

_NN = "com.intel.analytics.bigdl.nn."

# DataType enum (bigdl.proto)
DT_INT32, DT_INT64, DT_FLOAT, DT_DOUBLE = 0, 1, 2, 3
DT_STRING, DT_BOOL = 4, 5
DT_TENSOR = 10
DT_ARRAY_VALUE = 15

_CONTAINERS = ("Sequential", "Concat", "ConcatTable")


# ===========================================================================
# wire-level decode of the bigdl.proto messages
# ===========================================================================
def _decode_storage(data: bytes) -> dict:
    m = pw.decode_message(data)
    out = {"id": pw.ints(m, 9)[0] if 9 in m else 0, "data": None}
    if 2 in m:   # float_data (packed or not)
        vals: List[float] = []
        for v in m[2]:
            vals.extend(pw.unpack_packed(v, "float") if isinstance(v, bytes)
                        else [pw.as_float(v)])
        out["data"] = np.asarray(vals, np.float32)
    elif 3 in m:
        vals = []
        for v in m[3]:
            vals.extend(pw.unpack_packed(v, "double") if isinstance(v, bytes)
                        else [pw.as_double(v)])
        out["data"] = np.asarray(vals, np.float64)
    elif 6 in m:
        out["data"] = np.asarray(pw.ints(m, 6), np.int32)
    elif 7 in m:
        out["data"] = np.asarray([pw.as_sint(x) for x in pw.ints(m, 7)],
                                 np.int64)
    return out


def _decode_tensor(data: bytes, storages: Dict[int, np.ndarray]
                   ) -> Optional[np.ndarray]:
    m = pw.decode_message(data)
    size = pw.ints(m, 2)
    offset = pw.ints(m, 4)[0] if 4 in m else 0
    n = int(np.prod(size)) if size else 1
    arr = None
    if 8 in m:
        st = _decode_storage(m[8][0])
        if st["data"] is not None and len(st["data"]):
            storages.setdefault(st["id"], st["data"])
        arr = storages.get(st["id"])
    if arr is None:
        return None
    flat = arr[offset - 1 if offset >= 1 else 0:]
    flat = flat[:n]
    return np.asarray(flat, np.float32).reshape(size) if size else \
        np.asarray(flat[:1], np.float32).reshape(())


def _decode_attr(data: bytes, storages) -> Tuple[int, Any]:
    m = pw.decode_message(data)
    dtype = pw.ints(m, 1)[0] if 1 in m else 0
    if 3 in m:
        return dtype, pw.as_sint(m[3][0])
    if 4 in m:
        return dtype, pw.as_sint(m[4][0])
    if 5 in m:
        return dtype, pw.as_float(m[5][0])
    if 6 in m:
        return dtype, pw.as_double(m[6][0])
    if 7 in m:
        return dtype, pw.as_str(m[7][0])
    if 8 in m:
        return dtype, bool(m[8][0])
    if 9 in m:
        return dtype, _dec_regularizer(m[9][0])
    if 10 in m:
        return dtype, _decode_tensor(m[10][0], storages)
    if 15 in m:  # ArrayValue
        am = pw.decode_message(m[15][0])
        adt = pw.ints(am, 2)[0] if 2 in am else 0
        if adt == DT_INT32:
            return dtype, [pw.as_sint(v) for v in pw.ints(am, 3)]
        if adt == DT_FLOAT:
            vals = []
            for v in am.get(5, []):
                vals.extend(pw.unpack_packed(v, "float")
                            if isinstance(v, bytes) else [pw.as_float(v)])
            return dtype, vals
        if adt == DT_TENSOR:
            return dtype, [_decode_tensor(v, storages)
                           for v in am.get(10, [])]
        if adt == DT_STRING:
            return dtype, [pw.as_str(v) for v in am.get(7, [])]
        return dtype, None
    if 16 in m:  # DataFormat enum: 0 NCHW, 1 NHWC
        return dtype, "NCHW" if pw.ints(m, 16)[0] == 0 else "NHWC"
    # oneof absent (hand-written/partial file; genuine writers always set
    # it): fall back to the dataType's zero value so downstream int()/
    # float() coercions get a diagnosable default rather than None
    zero = {DT_INT32: 0, DT_INT64: 0, DT_FLOAT: 0.0, DT_DOUBLE: 0.0,
            DT_STRING: "", DT_BOOL: False}
    return dtype, zero.get(dtype)


def decode_bigdl_module(data: bytes,
                        storages: Optional[Dict[int, np.ndarray]] = None
                        ) -> dict:
    """Decode one BigDLModule message into a plain dict tree."""
    if storages is None:
        storages = {}
    m = pw.decode_message(data)
    attrs: Dict[str, Any] = {}
    for entry in m.get(8, []):
        em = pw.decode_message(entry)
        key = pw.as_str(em[1][0])
        attrs[key] = _decode_attr(em[2][0], storages)[1]
    return {
        "name": pw.as_str(m[1][0]) if 1 in m else "",
        "module_type": pw.as_str(m[7][0]) if 7 in m else "",
        "sub_modules": [decode_bigdl_module(s, storages)
                        for s in m.get(2, [])],
        "attrs": attrs,
        "has_parameters": bool(pw.ints(m, 15)[0]) if 15 in m else False,
        "parameters": [_decode_tensor(t, storages) for t in m.get(16, [])],
        # deprecated pre-hasParameters layout (BigDLModule weight=3/bias=4);
        # decoded so the loader can refuse loudly instead of silently
        # leaving random init weights in place
        "legacy_weight": _decode_tensor(m[3][0], storages) if 3 in m else None,
        "legacy_bias": _decode_tensor(m[4][0], storages) if 4 in m else None,
        "pre_modules": [pw.as_str(v) for v in m.get(5, [])],
        "next_modules": [pw.as_str(v) for v in m.get(6, [])],
        # unique instance id (bigdl.proto field 12) — shared-module marker
        "id": pw.ints(m, 12)[0] if 12 in m else None,
    }


# ===========================================================================
# module construction from the decoded tree
# ===========================================================================
def _conv(a, name=None) -> "nn.SpatialConvolution":
    return nn.SpatialConvolution(
        int(a["nInputPlane"]), int(a["nOutputPlane"]),
        int(a["kernelW"]), int(a["kernelH"]),
        int(a.get("strideW", 1)), int(a.get("strideH", 1)),
        int(a.get("padW", 0)), int(a.get("padH", 0)),
        n_group=int(a.get("nGroup", 1)),
        with_bias=bool(a.get("withBias", True)),
        dilation_w=int(a.get("dilationW", 1)),
        dilation_h=int(a.get("dilationH", 1)),
        format=a.get("format", "NCHW"), name=name)


def _build_graph(node: dict, name, cls=Graph) -> Graph:
    """The reference's GraphSerializable: sub-modules with preModules
    edges, inputNames/outputNames attributes, built as ``cls``.  Shared
    instances are tied by the proto ``id`` field; a repeated NAME (writers
    without ids) ties too."""
    a = node["attrs"]
    in_names = list(a.get("inputNames", []))
    out_names = list(a.get("outputNames", []))
    built_by_id: Dict[int, Module] = {}
    built_by_name: Dict[str, Module] = {}
    occurrence: Dict[str, Any] = {}
    inputs_by_name: Dict[str, Any] = {}
    for sub in node["sub_modules"]:
        st = sub["module_type"].rsplit(".", 1)[-1]
        nm = sub["name"]
        if st == "Input":
            ph = Input()
            occurrence[nm] = ph
            inputs_by_name[nm] = ph
            continue
        iid = sub.get("id")
        mod = (built_by_id.get(iid) if iid is not None
               else built_by_name.get(nm))
        if mod is None:
            mod = _build(sub)
            built_by_name[nm] = mod
            if iid is not None:
                built_by_id[iid] = mod
        pres = list(sub["pre_modules"])
        if not pres:
            if nm not in in_names:
                raise ValueError(f"graph node {nm!r} has no preModules and "
                                 "is not an input")
            pres_nodes = [inputs_by_name.setdefault(nm, Input())]
        else:
            pres_nodes = [occurrence[p] for p in pres]
        occurrence[nm] = mod(pres_nodes if len(pres_nodes) > 1
                             else pres_nodes[0])
    inputs = [inputs_by_name[n] for n in in_names]
    outputs = [occurrence[n] for n in out_names]
    return cls(inputs, outputs, name=name)


_SIMPLE = {"ReLU": nn.ReLU, "Tanh": nn.Tanh, "Sigmoid": nn.Sigmoid,
           "LogSoftMax": nn.LogSoftMax, "SoftMax": nn.SoftMax,
           "Identity": nn.Identity, "Flatten": nn.Flatten, "ELU": nn.ELU,
           "ReLU6": nn.ReLU6, "SoftPlus": nn.SoftPlus, "Abs": nn.Abs,
           "HardTanh": nn.HardTanh, "Square": nn.Square, "Sqrt": nn.Sqrt,
           "Exp": nn.Exp}


def _construct(node: dict) -> Module:
    t = node["module_type"].rsplit(".", 1)[-1]
    a = node["attrs"]
    name = node["name"] or None
    if t in ("StaticGraph", "Graph", "DynamicGraph"):
        return _build_graph(node, name,
                            DynamicGraph if t == "DynamicGraph" else Graph)
    if t in _CONTAINERS:
        m = (nn.Concat(dim=int(a.get("dimension", 2)) - 1, name=name)
             if t == "Concat" else getattr(nn, t)(name=name))
        for s in node["sub_modules"]:
            m.add(_build(s))
        return m
    if t == "Linear":
        return nn.Linear(int(a["inputSize"]), int(a["outputSize"]),
                         with_bias=bool(a.get("withBias", True)), name=name)
    if t == "SpatialConvolution":
        return _conv(a, name)
    if t in ("SpatialMaxPooling", "SpatialAveragePooling"):
        kw = {"ceil_mode": bool(a.get("ceil_mode", False)),
              "format": a.get("format", "NCHW"), "name": name}
        if t == "SpatialAveragePooling":
            kw["count_include_pad"] = bool(a.get("countIncludePad", True))
        return getattr(nn, t)(
            int(a["kW"]), int(a["kH"]), int(a.get("dW", 1)),
            int(a.get("dH", 1)), int(a.get("padW", 0)),
            int(a.get("padH", 0)), **kw)
    if t in ("SpatialBatchNormalization", "BatchNormalization"):
        return getattr(nn, t)(int(a["nOutput"]),
                              eps=float(a.get("eps", 1e-5)),
                              momentum=float(a.get("momentum", 0.1)),
                              affine=bool(a.get("affine", True)), name=name)
    if t == "SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(
            size=int(a.get("size", 5)), alpha=float(a.get("alpha", 1.0)),
            beta=float(a.get("beta", 0.75)), k=float(a.get("k", 1.0)),
            format=a.get("format", "NCHW"), name=name)
    if t == "Dropout":
        return nn.Dropout(float(a.get("initP", 0.5)), name=name)
    if t == "Scale":
        return nn.Scale(tuple(int(v) for v in a["size"]), name=name)
    if t == "Reshape":
        return nn.Reshape(tuple(int(v) for v in a["size"]), name=name)
    if t == "View":
        sizes = a.get("sizes", a.get("size"))
        return nn.View(tuple(int(v) for v in sizes), name=name)
    if t == "LookupTable":
        return nn.LookupTable(int(a["nIndex"]), int(a["nOutput"]), name=name)
    if t == "JoinTable":
        return nn.JoinTable(int(a.get("dimension", 2)) - 1, name=name)
    if t == "CAddTable":
        return nn.CAddTable(name=name)
    if t == "TemporalConvolution":
        return nn.TemporalConvolution(
            int(a["inputFrameSize"]), int(a["outputFrameSize"]),
            int(a["kernelW"]), int(a.get("strideW", 1)), name=name)
    if t in ("QuantizedLinear", "QuantizedSpatialConvolution"):
        # the int8 twins are built straight from the node's tensors
        ps = [p for p in node["parameters"] if p is not None]
        if len(ps) < 2:
            raise ValueError(
                f"quantized module {node['name']!r}: expected (weight_q, "
                f"weight_scale[, bias]) tensors, got {len(ps)}")
        qmode = (a.get("quantMode") or ["weight_only"])[0]
        wq = np.asarray(ps[0], np.float32).astype(np.int8)
        ws = np.asarray(ps[1], np.float32)
        b = np.asarray(ps[2], np.float32) if len(ps) > 2 else None
        if t == "QuantizedLinear":
            return nn.QuantizedLinear(wq, ws, b, name=name, mode=qmode)
        return nn.QuantizedSpatialConvolution(_conv(a), wq, ws, b,
                                              name=name, mode=qmode)
    if t in _SIMPLE:
        return _SIMPLE[t](name=name)
    raise NotImplementedError(
        f"BigDL module type {node['module_type']!r} not mapped yet")


def _build(node: dict) -> Module:
    m = _construct(node)
    a = node["attrs"]
    # per-layer penalties (the reference's wRegularizer/bRegularizer)
    if a.get("wRegularizer") is not None:
        m.w_regularizer = a["wRegularizer"]
    if a.get("bRegularizer") is not None:
        m.b_regularizer = a["bRegularizer"]
    _load_weights(m, node)
    return m


def _put(t: Optional[torch.Tensor], arr) -> None:
    if t is None:
        return
    arr = np.asarray(arr, np.float32).reshape(tuple(t.shape))
    with torch.no_grad():
        t.copy_(torch.from_numpy(arr))


def _load_weights(m: Module, node: dict) -> None:
    """Copy the node's own serialized tensors into ``m`` (a container's
    children load themselves as they are built)."""
    t = node["module_type"].rsplit(".", 1)[-1]
    if t in _CONTAINERS or t in ("StaticGraph", "Graph", "DynamicGraph") \
            or t.startswith("Quantized"):
        return
    ps = [p for p in node["parameters"] if p is not None]
    if not ps:
        lw, lb = node.get("legacy_weight"), node.get("legacy_bias")
        if lw is not None:
            # the deprecated layout (weight=3/bias=4) through the same paths
            ps = [lw] + ([lb] if lb is not None else [])
        elif lb is not None:
            raise ValueError(
                f"module {node['name']!r} ({t}): legacy bias (field 4) "
                "present but its weight (field 3) failed to decode — "
                "refusing to load a partially-decoded legacy checkpoint")
    if t == "Scale":
        if ps:
            _put(m.mul.weight, ps[0])
        if len(ps) > 1:
            _put(m.add.bias, ps[1])
    elif t in ("SpatialBatchNormalization", "BatchNormalization"):
        if getattr(m, "weight", None) is not None and len(ps) >= 1:
            _put(m.weight, ps[0])
        if getattr(m, "bias", None) is not None and len(ps) >= 2:
            _put(m.bias, ps[1])
        for key, buf in (("runningMean", "running_mean"),
                         ("runningVar", "running_var")):
            if node["attrs"].get(key) is not None:
                _put(getattr(m, buf), node["attrs"][key])
    elif t in ("SpatialConvolution", "Linear", "TemporalConvolution",
               "LookupTable"):
        if ps:
            # a conv weight (g, out/g, in/g, kh, kw) reshapes to OIHW
            _put(m.weight, ps[0])
        if len(ps) > 1 and getattr(m, "bias", None) is not None:
            _put(m.bias, ps[1])
    else:
        # generic positional copy over the layer's own sorted parameters
        own = dict(m.named_parameters(recurse=False))
        for key, val in zip(sorted(own), ps):
            _put(own[key], val)


def load_bigdl_module(path: str) -> Module:
    """Load a BigDL model file (the reference's ``Module.loadModule``):
    port modules on the CPU holding the file's weights."""
    with open(path, "rb") as f:
        data = f.read()
    return _build(decode_bigdl_module(data))


# ===========================================================================
# export (writer)
# ===========================================================================
def _enc_storage(arr: np.ndarray, sid: int) -> bytes:
    flat = np.asarray(arr, np.float32).reshape(-1)
    return (pw.enc_varint(1, DT_FLOAT)
            + pw.enc_packed_floats(2, flat.tolist())
            + pw.enc_varint(9, sid))


def _enc_tensor(arr: np.ndarray, sid: int) -> bytes:
    arr = np.asarray(arr)
    size = arr.shape
    stride = [int(np.prod(size[i + 1:])) for i in range(len(size))]
    body = pw.enc_varint(1, DT_FLOAT)
    body += pw.enc_packed_ints(2, list(size))
    body += pw.enc_packed_ints(3, stride)
    body += pw.enc_varint(4, 1)  # 1-based offset like the reference
    body += pw.enc_varint(5, len(size))
    body += pw.enc_varint(6, int(arr.size))
    body += pw.enc_bytes(8, _enc_storage(arr, sid))
    body += pw.enc_varint(9, sid)
    return body


def _enc_attr_int(v: int) -> bytes:
    return pw.enc_varint(1, DT_INT32) + pw.enc_varint(3, int(v))


def _enc_attr_double(v: float) -> bytes:
    return pw.enc_varint(1, DT_DOUBLE) + pw.enc_double(6, float(v))


def _enc_attr_bool(v: bool) -> bytes:
    return pw.enc_varint(1, DT_BOOL) + pw.enc_varint(8, 1 if v else 0)


def _enc_attr_int_array(vs) -> bytes:
    av = (pw.enc_varint(1, len(vs)) + pw.enc_varint(2, DT_INT32)
          + pw.enc_packed_ints(3, [int(v) for v in vs]))
    return pw.enc_varint(1, DT_ARRAY_VALUE) + pw.enc_bytes(15, av)


def _enc_attr_format(fmt: str) -> bytes:
    # DataType DATA_FORMAT=16; oneof field 16 = InputDataFormat enum
    return pw.enc_varint(1, 16) + pw.enc_varint(16,
                                                0 if fmt == "NCHW" else 1)


def _enc_attr_tensor(arr, sid) -> bytes:
    return pw.enc_varint(1, DT_TENSOR) + pw.enc_bytes(10, _enc_tensor(arr,
                                                                      sid))


def _enc_attr_str_array(vs) -> bytes:
    av = (pw.enc_varint(1, len(vs)) + pw.enc_varint(2, DT_STRING)
          + b"".join(pw.enc_str(7, str(v)) for v in vs))
    return pw.enc_varint(1, DT_ARRAY_VALUE) + pw.enc_bytes(15, av)


def _enc_attr_regularizer(reg) -> bytes:
    """Regularizer message (bigdl.proto): regularizerType=1 (0=L1L2,
    1=L1, 2=L2), regularData=2 repeated double; AttrValue dataType
    REGULARIZER=9, oneof field 9."""
    l1 = float(getattr(reg, "l1", 0.0))
    l2 = float(getattr(reg, "l2", 0.0))
    if l1 and not l2:
        rt, data = 1, [l1]
    elif l2 and not l1:
        rt, data = 2, [l2]
    else:
        rt, data = 0, [l1, l2]
    msg = pw.enc_varint(1, rt) + b"".join(pw.enc_double(2, d)
                                          for d in data)
    return pw.enc_varint(1, 9) + pw.enc_bytes(9, msg)


def _dec_regularizer(msg_bytes: bytes):
    from bigdl_tpu_torch.nn.regularizers import L1L2Regularizer
    m = pw.decode_message(msg_bytes)
    rt = pw.ints(m, 1)[0] if 1 in m else 0
    data = [pw.as_double(v) for v in m.get(2, [])]
    if rt == 1:
        return L1L2Regularizer(l1=data[0] if data else 0.0)
    if rt == 2:
        return L1L2Regularizer(l2=data[0] if data else 0.0)
    return L1L2Regularizer(l1=data[0] if data else 0.0,
                           l2=data[1] if len(data) > 1 else 0.0)


def _host(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _children(m: Module) -> List[Module]:
    return list(m._modules.values())


class _Exporter:
    def __init__(self):
        self.next_id = 1

    def sid(self) -> int:
        i = self.next_id
        self.next_id += 1
        return i

    @staticmethod
    def module_attrs(m: Module) -> Dict[str, bytes]:
        t = type(m).__name__
        out: Dict[str, bytes] = {}
        if getattr(m, "w_regularizer", None) is not None:
            out["wRegularizer"] = _enc_attr_regularizer(m.w_regularizer)
        if getattr(m, "b_regularizer", None) is not None:
            out["bRegularizer"] = _enc_attr_regularizer(m.b_regularizer)
        if t == "Linear":
            return {**out,
                    "inputSize": _enc_attr_int(m.input_size),
                    "outputSize": _enc_attr_int(m.output_size),
                    "withBias": _enc_attr_bool(m.with_bias)}
        if t == "SpatialConvolution":
            return {**out, **_conv_attrs(m, m.n_input_plane,
                                         m.n_output_plane, m.with_bias,
                                         m.format)}
        if t in ("SpatialMaxPooling", "SpatialAveragePooling"):
            attrs = {"kW": _enc_attr_int(m.kernel[1]),
                     "kH": _enc_attr_int(m.kernel[0]),
                     "dW": _enc_attr_int(m.stride[1]),
                     "dH": _enc_attr_int(m.stride[0]),
                     "padW": _enc_attr_int(m.pad[1]),
                     "padH": _enc_attr_int(m.pad[0]),
                     "ceil_mode": _enc_attr_bool(m.ceil_mode)}
            if t == "SpatialAveragePooling":
                attrs["countIncludePad"] = _enc_attr_bool(
                    m.count_include_pad)
            attrs["format"] = _enc_attr_format(m.format)
            return attrs
        if t in ("SpatialBatchNormalization", "BatchNormalization"):
            return {"nOutput": _enc_attr_int(m.n_output),
                    "eps": _enc_attr_double(m.eps),
                    "momentum": _enc_attr_double(m.momentum),
                    "affine": _enc_attr_bool(m.affine)}
        if t == "SpatialCrossMapLRN":
            return {"size": _enc_attr_int(m.size),
                    "alpha": _enc_attr_double(m.alpha),
                    "beta": _enc_attr_double(m.beta),
                    "k": _enc_attr_double(m.k),
                    "format": _enc_attr_format(m.format)}
        if t == "Dropout":
            return {"initP": _enc_attr_double(m.p)}
        if t == "Scale":
            return {"size": _enc_attr_int_array(m.mul.size)}
        if t in ("Reshape", "View"):
            return {"size": _enc_attr_int_array(m.size),
                    "batchMode": _enc_attr_int(0)}
        if t == "LookupTable":
            return {"nIndex": _enc_attr_int(m.n_index),
                    "nOutput": _enc_attr_int(m.n_output)}
        if t == "Concat":
            return {"dimension": _enc_attr_int(m.dim + 1)}
        if t == "JoinTable":
            return {"dimension": _enc_attr_int(m.dimension + 1)}
        if t == "TemporalConvolution":
            return {**out,
                    "inputFrameSize": _enc_attr_int(m.input_frame_size),
                    "outputFrameSize": _enc_attr_int(m.output_frame_size),
                    "kernelW": _enc_attr_int(m.kernel_w),
                    "strideW": _enc_attr_int(m.stride_w)}
        # the int8 twins: the float layer's structure plus the mode
        if t == "QuantizedLinear":
            o, i = m.weight_q.shape
            return {**out,
                    "inputSize": _enc_attr_int(i),
                    "outputSize": _enc_attr_int(o),
                    "withBias": _enc_attr_bool(m.bias is not None),
                    "quantMode": _enc_attr_str_array([m.mode])}
        if t == "QuantizedSpatialConvolution":
            o, i = m.weight_q.shape[:2]
            return {**out, **_conv_attrs(m, i * m.n_group, o,
                                         m.bias is not None, m.format),
                    "quantMode": _enc_attr_str_array([m.mode])}
        return out

    def encode(self, m: Module, pre=(), nxt=(), name: Optional[str] = None,
               with_params: bool = True) -> bytes:
        if isinstance(m, Remat):
            # an execution hint: the wrapped module is what is saved
            return self.encode(m.inner, pre, nxt, name=name or m.inner.name,
                               with_params=with_params)
        if isinstance(m, Graph):
            return self.encode_graph(m, pre, nxt)
        t = type(m).__name__
        body = pw.enc_str(1, name or m.name or t)
        for p in pre:
            body += pw.enc_str(5, p)
        for nx in nxt:
            body += pw.enc_str(6, nx)
        body += pw.enc_str(7, _NN + t)
        body += pw.enc_str(9, "0.2.0")
        if t in _CONTAINERS:
            for child in _children(m):
                body += pw.enc_bytes(2, self.encode(
                    child, with_params=with_params))
        for key, attr in self.module_attrs(m).items():
            body += pw.enc_bytes(8, pw.enc_str(1, key) + pw.enc_bytes(2, attr))
        # a shared module's later occurrence: structure only (the int8
        # twins hold their tensors outside the reference's params tree, so
        # they are written at every occurrence, as the reference writes them)
        tensors = self.module_tensors(m) \
            if with_params or t.startswith("Quantized") else []
        if tensors:
            body += pw.enc_varint(15, 1)  # hasParameters
            for arr in tensors:
                body += pw.enc_bytes(16, _enc_tensor(arr, self.sid()))
        if with_params and t in ("SpatialBatchNormalization",
                                 "BatchNormalization"):
            for key, buf in (("runningMean", "running_mean"),
                             ("runningVar", "running_var")):
                entry = (pw.enc_str(1, key) + pw.enc_bytes(
                    2, _enc_attr_tensor(_host(getattr(m, buf)), self.sid())))
                body += pw.enc_bytes(8, entry)
        return body

    def encode_graph(self, g: Graph, pre=(), nxt=()) -> bytes:
        """The reference's ``StaticGraph``: sub-modules with
        ``preModules``/``nextModules`` edges, ``inputNames``/
        ``outputNames`` attributes; one unique name per OCCURRENCE, one
        ``id`` per INSTANCE, weights on the first occurrence only."""
        body = pw.enc_str(1, g.name or "Graph")
        for p in pre:
            body += pw.enc_str(5, p)
        for nx in nxt:
            body += pw.enc_str(6, nx)
        body += pw.enc_str(7, _NN + "StaticGraph")
        body += pw.enc_str(9, "0.2.0")

        node_names: Dict[int, str] = {}
        inst_ids: Dict[int, int] = {}
        used: Dict[str, int] = {}
        for node in g._order:
            mod = node.module
            base = mod.name or type(mod).__name__
            n = used.get(base, 0)
            used[base] = n + 1
            node_names[id(node)] = base if n == 0 else f"{base}@{n}"
            inst_ids.setdefault(id(mod), len(inst_ids) + 1)
        in_names = []
        for i, inp in enumerate(g.input_nodes):
            nm = f"graph_input_{i}"
            node_names[id(inp)] = nm
            in_names.append(nm)

        consumers: Dict[int, List[str]] = {}
        for node in g._order:
            for p in node.inputs:
                consumers.setdefault(id(p), []).append(node_names[id(node)])

        for i, inp in enumerate(g.input_nodes):
            sub = (pw.enc_str(1, in_names[i])
                   + b"".join(pw.enc_str(6, c)
                              for c in consumers.get(id(inp), []))
                   + pw.enc_str(7, _NN + "Input")
                   + pw.enc_str(9, "0.2.0"))
            body += pw.enc_bytes(2, sub)

        emitted: set = set()
        for node in g._order:
            mod = node.module
            first = id(mod) not in emitted
            emitted.add(id(mod))
            sub = self.encode(mod, pre=[node_names[id(p)] for p in node.inputs],
                              nxt=consumers.get(id(node), []),
                              name=node_names[id(node)], with_params=first)
            sub += pw.enc_varint(12, inst_ids[id(mod)])
            body += pw.enc_bytes(2, sub)

        for akey, aval in (("inputNames", in_names),
                           ("outputNames",
                            [node_names[id(n)] for n in g.output_nodes])):
            entry = pw.enc_str(1, akey) + pw.enc_bytes(
                2, _enc_attr_str_array(aval))
            body += pw.enc_bytes(8, entry)
        return body

    @staticmethod
    def module_tensors(m: Module) -> List[np.ndarray]:
        t = type(m).__name__
        if t in ("QuantizedLinear", "QuantizedSpatialConvolution"):
            # int8 values are exact in the f32 tensor wire format
            out = [_host(m.weight_q), _host(m.weight_scale)]
            if m.bias is not None:
                out.append(_host(m.bias))
            return out
        if t in _CONTAINERS:
            return []
        if t == "SpatialConvolution":
            w = _host(m.weight)
            g = m.n_group
            out = [w.reshape(g, w.shape[0] // g, *w.shape[1:])]
            if m.bias is not None:
                out.append(_host(m.bias))
            return out
        if t == "Scale":
            return [_host(m.mul.weight), _host(m.add.bias)]
        own = dict(m.named_parameters(recurse=False))
        out = [_host(own[k]) for k in ("weight", "bias")
               if own.get(k) is not None]
        if not out:  # the generic reader's sorted order
            out = [_host(own[k]) for k in sorted(own)]
        return out


def _conv_attrs(m, n_in, n_out, with_bias, fmt) -> Dict[str, bytes]:
    return {"nInputPlane": _enc_attr_int(n_in),
            "nOutputPlane": _enc_attr_int(n_out),
            "kernelW": _enc_attr_int(m.kernel[1]),
            "kernelH": _enc_attr_int(m.kernel[0]),
            "strideW": _enc_attr_int(m.stride[1]),
            "strideH": _enc_attr_int(m.stride[0]),
            "padW": _enc_attr_int(m.pad[1]),
            "padH": _enc_attr_int(m.pad[0]),
            "nGroup": _enc_attr_int(m.n_group),
            "withBias": _enc_attr_bool(with_bias),
            "format": _enc_attr_format(fmt),
            "dilationW": _enc_attr_int(m.dilation[1]),
            "dilationH": _enc_attr_int(m.dilation[0])}


def save_bigdl_module(module: Module, path: str) -> None:
    """Write ``module`` as a BigDL model file (the reference's
    ``Module.saveModule``), byte-identical to the reference package's file
    of the same model and weights."""
    data = _Exporter().encode(module)
    with open(path, "wb") as f:
        f.write(data)

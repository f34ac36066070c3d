"""Caffe model importer: prototxt plus caffemodel into a ``Graph`` (port of
``bigdl_tpu/interop/caffe_format.py``).

The prototxt (text proto, parsed by ``tf_format``'s text-proto reader)
defines the net; the binary caffemodel (``utils/protowire``) carries each
layer's weight blobs, matched by layer name.  New-format ``layer`` and V1
``layers`` are both read.  Unknown layer types take a converter from
``custom={type: fn(layer, blobs) -> module}``.  The modules are built on
the CPU with the blobs as their weights.

Caffe proto field numbers used (from caffe.proto):
  NetParameter: name=1, input=3, input_dim=4, input_shape=8, layer=100,
    layers=2 (V1)
  LayerParameter: name=1, type=2, bottom=3, top=4, blobs=7
  V1LayerParameter: name=4, blobs=6
  BlobProto: shape=7 {dim=1}, data=5 (packed float), num/chan/h/w=1..4
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.tf_format import _parse_textproto, _tokenize
from bigdl_tpu_torch.nn.graph import Graph, Input, Node
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils import protowire as pw


# ---------------------------------------------------------------- decoding
def _blob_to_array(data: bytes) -> np.ndarray:
    m = pw.decode_message(data)
    vals: List[float] = []
    for v in m.get(5, []):
        vals.extend(pw.unpack_packed(v, "float")
                    if isinstance(v, bytes) else [pw.as_float(v)])
    arr = np.asarray(vals, np.float32)
    if 7 in m:  # BlobShape
        sm = pw.decode_message(m[7][0])
        dims = [pw.as_sint(d) for d in pw.ints(sm, 1)]
        return arr.reshape(dims)
    legacy = [pw.ints(m, f)[0] if f in m else 1 for f in (1, 2, 3, 4)]
    if np.prod(legacy) == arr.size:
        return arr.reshape(legacy)
    return arr


def _decode_caffemodel(data: bytes) -> Dict[str, List[np.ndarray]]:
    """caffemodel → {layer name: [blobs]} (weights then bias)."""
    net = pw.decode_message(data)
    blobs: Dict[str, List[np.ndarray]] = {}
    for lay in net.get(100, []):   # new format LayerParameter
        lm = pw.decode_message(lay)
        name = pw.as_str(lm[1][0])
        if 7 in lm:
            blobs[name] = [_blob_to_array(b) for b in lm[7]]
    for lay in net.get(2, []):     # V1LayerParameter fallback
        lm = pw.decode_message(lay)
        if 4 in lm and 6 in lm:
            blobs[pw.as_str(lm[4][0])] = [_blob_to_array(b)
                                          for b in lm[6]]
    return blobs


def _parse_prototxt(text: str) -> dict:
    root = _parse_textproto(_tokenize(text))

    def dec(v):
        return v.decode() if isinstance(v, bytes) else v

    layers = []
    for key in ("layer", "layers"):
        for l in root.get(key, []):
            p: dict = {k: v for k, v in l.items()}
            layers.append({
                "name": dec(p["name"][0]),
                "type": dec(p["type"][0]),
                "bottom": [dec(b) for b in p.get("bottom", [])],
                "top": [dec(t) for t in p.get("top", [])],
                "params": p,
            })
    return {
        "name": dec(root.get("name", [b""])[0]),
        "inputs": [dec(i) for i in root.get("input", [])],
        "input_dims": [int(d) for d in root.get("input_dim", [])],
        "layers": layers,
    }


def _pick(p: dict, key: str, default=None):
    v = p.get(key)
    if not v:
        return default
    x = v[0]
    return x.decode() if isinstance(x, bytes) else x


# --------------------------------------------------------------- converters
def _put(t: Optional[torch.Tensor], arr) -> None:
    if t is None or arr is None:
        return
    with torch.no_grad():
        t.copy_(torch.from_numpy(
            np.asarray(arr, np.float32).reshape(tuple(t.shape))))


def _conv_module(name, cp, blobs):
    num_out = int(_pick(cp, "num_output"))
    kh = int(_pick(cp, "kernel_h", _pick(cp, "kernel_size", 1)))
    kw = int(_pick(cp, "kernel_w", _pick(cp, "kernel_size", 1)))
    sh = int(_pick(cp, "stride_h", _pick(cp, "stride", 1)))
    sw = int(_pick(cp, "stride_w", _pick(cp, "stride", 1)))
    ph = int(_pick(cp, "pad_h", _pick(cp, "pad", 0)))
    pw_ = int(_pick(cp, "pad_w", _pick(cp, "pad", 0)))
    group = int(_pick(cp, "group", 1))
    dil = int(_pick(cp, "dilation", 1))
    bias = bool(_pick(cp, "bias_term", True))
    w = blobs[0]
    if w.ndim < 4:
        # writers that keep only the num/channels legacy dims leave the
        # blob flat: recover OIHW from the layer's hyper-parameters
        w = w.reshape(num_out, w.size // (num_out * kh * kw), kh, kw)
    m = nn.SpatialConvolution(w.shape[1] * group, num_out, kw, kh, sw, sh,
                              pw_, ph, n_group=group, with_bias=bias,
                              dilation_w=dil, dilation_h=dil, name=name)
    _put(m.weight, w)
    if bias and len(blobs) > 1:
        _put(m.bias, blobs[1])
    return m


def _ip_module(name, ip, blobs):
    num_out = int(_pick(ip, "num_output"))
    bias = bool(_pick(ip, "bias_term", True))
    w = blobs[0].reshape(num_out, -1)
    # Caffe's InnerProduct flattens its input itself
    lin = nn.Linear(w.shape[1], num_out, with_bias=bias, name=name)
    _put(lin.weight, w)
    if bias and len(blobs) > 1:
        _put(lin.bias, blobs[1])
    return nn.Sequential(nn.Flatten(), lin, name=name)


def _pool_module(name, pp):
    mode = _pick(pp, "pool", 0)
    mode = {"MAX": 0, "AVE": 1}.get(mode, mode)
    k = int(_pick(pp, "kernel_size", 2))
    kh = int(_pick(pp, "kernel_h", k))
    kw = int(_pick(pp, "kernel_w", k))
    s = int(_pick(pp, "stride", 1))
    sh = int(_pick(pp, "stride_h", s))
    sw = int(_pick(pp, "stride_w", s))
    p = int(_pick(pp, "pad", 0))
    ph = int(_pick(pp, "pad_h", p))
    pw_ = int(_pick(pp, "pad_w", p))
    cls = nn.SpatialMaxPooling if int(mode) == 0 else nn.SpatialAveragePooling
    # Caffe pools in ceil mode
    return cls(kw, kh, sw, sh, pw_, ph, ceil_mode=True, name=name)


def _convert_layer(layer: dict, blobs: List[np.ndarray],
                   custom: Dict[str, Callable]):
    """(module or None, None | "input" | "skip")."""
    t = layer["type"]
    name = layer["name"]
    p = layer["params"]
    if t in custom:
        return custom[t](layer, blobs), None
    if t == "Convolution":
        return _conv_module(name, p["convolution_param"][0], blobs), None
    if t == "InnerProduct":
        return _ip_module(name, p["inner_product_param"][0], blobs), None
    if t == "Pooling":
        return _pool_module(name, p["pooling_param"][0]), None
    simple = {"ReLU": nn.ReLU, "TanH": nn.Tanh, "Sigmoid": nn.Sigmoid,
              "Softmax": nn.SoftMax, "Flatten": nn.Flatten}
    if t in simple:
        return simple[t](name=name), None
    if t == "Dropout":
        ratio = float(_pick(p.get("dropout_param", [{}])[0],
                            "dropout_ratio", 0.5))
        return nn.Dropout(ratio, name=name), None
    if t == "LRN":
        lp = p.get("lrn_param", [{}])[0]
        return nn.SpatialCrossMapLRN(
            size=int(_pick(lp, "local_size", 5)),
            alpha=float(_pick(lp, "alpha", 1.0)),
            beta=float(_pick(lp, "beta", 0.75)),
            k=float(_pick(lp, "k", 1.0)), name=name), None
    if t == "Concat":
        cp = p.get("concat_param", [{}])[0]
        return nn.JoinTable(int(_pick(cp, "axis", 1)), name=name), None
    if t == "Eltwise":
        ep = p.get("eltwise_param", [{}])[0]
        op = _pick(ep, "operation", "SUM")
        op = {0: "PROD", 1: "SUM", 2: "MAX"}.get(op, op)
        cls = {"SUM": nn.CAddTable, "PROD": nn.CMulTable}.get(op,
                                                              nn.CMaxTable)
        return cls(name=name), None
    if t == "BatchNorm":
        bp = p.get("batch_norm_param", [{}])[0]
        m = nn.SpatialBatchNormalization(
            blobs[0].size if blobs else 0,
            eps=float(_pick(bp, "eps", 1e-5)), affine=False, name=name)
        if blobs:
            scale = blobs[2].reshape(-1)[0] if len(blobs) > 2 else 1.0
            scale = 1.0 / scale if scale != 0 else 0.0
            _put(m.running_mean, blobs[0].reshape(-1) * scale)
            _put(m.running_var, blobs[1].reshape(-1) * scale)
        return m, None
    if t == "Scale":
        # per-channel y = gamma * x + beta (Caffe pairs it after BatchNorm)
        if not blobs:
            raise NotImplementedError(
                f"Scale layer {name!r} without blobs: channel count "
                "unknown (weights-free prototxt import)")
        c = blobs[0].size
        m = nn.Scale((c, 1, 1), name=name)
        _put(m.mul.weight, blobs[0])
        # no bias blob (bias_term=false, Caffe's default): the bias is 0
        _put(m.add.bias, blobs[1] if len(blobs) > 1
             else np.zeros(c, np.float32))
        return m, None
    if t in ("Input", "Data", "DummyData"):
        return None, "input"   # its tops become graph inputs
    if t in ("SoftmaxWithLoss", "Accuracy", "Silence"):
        return None, "skip"    # training/diagnostic heads: dropped
    raise NotImplementedError(
        f"Caffe layer type {t!r} ({name}); pass custom={{'{t}': fn}}")


# ------------------------------------------------------------------ loader
def load_caffe_model(def_path: str, model_path: str,
                     custom: Optional[Dict[str, Callable]] = None) -> Module:
    """prototxt + caffemodel → a :class:`Graph` on the CPU holding the
    caffemodel's weights (the reference's ``Module.loadCaffeModel``).
    In-place layers (bottom == top, Caffe's ReLU idiom) chain; several
    bottoms (Concat/Eltwise) become a table input."""
    custom = custom or {}
    with open(def_path) as f:
        net = _parse_prototxt(f.read())
    with open(model_path, "rb") as f:
        blobs = _decode_caffemodel(f.read())

    nodes: Dict[str, Node] = {}
    inputs: List[Node] = []
    for inp in net["inputs"]:
        n = Input()
        nodes[inp] = n
        inputs.append(n)

    last: Optional[Node] = None
    for layer in net["layers"]:
        lb = blobs.get(layer["name"], [])
        mod, extra = _convert_layer(layer, lb, custom)
        if mod is None:
            if extra == "input":
                for top in layer["top"]:
                    if top not in nodes:
                        nodes[top] = Input()
                        inputs.append(nodes[top])
            continue
        bots = [nodes[b] for b in layer["bottom"] if b in nodes]
        if not bots:
            if layer["bottom"]:
                raise ValueError(f"layer {layer['name']} has unknown "
                                 f"bottoms {layer['bottom']}")
            # a bottomless first layer: an implicit graph input feeds it
            n = Input()
            inputs.append(n)
            bots = [n]
        node = mod(bots if len(bots) > 1 else bots[0])
        for top in layer["top"]:
            nodes[top] = node
        last = node
    return Graph(inputs, [last], name=net["name"] or "CaffeNet")

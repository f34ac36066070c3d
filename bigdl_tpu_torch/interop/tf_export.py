"""TensorFlow GraphDef exporter (port of ``bigdl_tpu/interop/tf_export.py``).

Saves a model as a GraphDef: Sequential chains of Linear /
SpatialConvolution / pooling (a max pool with explicit padding as a
``-inf`` ``PadV2`` and a VALID pool, which the reference package's exporter
refuses) / BatchNorm (folded to scale and shift, the
inference form) / activations / Reshape / Flatten / Dropout (Identity),
and ``ConcatTable`` branches joined by ``CAddTable`` (``AddN``),
``CMulTable``/``CMaxTable`` or ``JoinTable`` (ResNet's residual blocks).
Weights are ``Const`` nodes (a frozen graph) by default, or
``VariableV2`` + ``Assign`` with ``trainable=True`` (the folded BatchNorm
statistics stay Consts).  ``load_tf_graph`` on the file reproduces the
model's eval-mode outputs; the file's bytes are the reference package's
for the same weights.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module, Remat, Sequential
from bigdl_tpu_torch.utils import protowire as pw


_DT_FLOAT, _DT_INT32 = 1, 3


def _tensor_proto(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = _DT_INT32 if np.issubdtype(arr.dtype, np.integer) else _DT_FLOAT
    arr = arr.astype(np.int32 if dt == _DT_INT32 else np.float32)
    t = pw.enc_varint(1, dt)
    shape = b"".join(pw.enc_bytes(2, pw.enc_varint(1, d))
                     for d in arr.shape)
    t += pw.enc_bytes(2, shape)
    t += pw.enc_bytes(4, arr.tobytes())
    return t


def _attr(key: str, payload: bytes) -> bytes:
    return pw.enc_bytes(5, pw.enc_str(1, key) + pw.enc_bytes(2, payload))


def _attr_tensor(key: str, arr) -> bytes:
    return _attr(key, pw.enc_bytes(8, _tensor_proto(arr)))


def _attr_type(key: str, dt: int = _DT_FLOAT) -> bytes:
    return _attr(key, pw.enc_varint(6, dt))


def _attr_s(key: str, s: str) -> bytes:
    return _attr(key, pw.enc_bytes(2, s.encode()))


def _attr_b(key: str, v: bool) -> bytes:
    return _attr(key, pw.enc_varint(5, 1 if v else 0))


def _attr_ilist(key: str, vals) -> bytes:
    lst = b"".join(pw.enc_varint(3, int(v)) for v in vals)
    return _attr(key, pw.enc_bytes(1, lst))


class _GraphBuilder:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.counter = 0

    def fresh(self, base: str) -> str:
        self.counter += 1
        return f"{base}_{self.counter}"

    def node(self, name: str, op: str, inputs: Sequence[str] = (),
             *attrs: bytes) -> str:
        body = pw.enc_str(1, name) + pw.enc_str(2, op)
        for i in inputs:
            body += pw.enc_str(3, i)
        for a in attrs:
            body += a
        self.nodes.append(pw.enc_bytes(1, body))
        return name

    trainable = False  # const() emits VariableV2+Assign when True

    def const(self, base: str, arr) -> str:
        arr = np.asarray(arr)
        is_int = np.issubdtype(arr.dtype, np.integer)
        dt = _DT_INT32 if is_int else _DT_FLOAT
        if self.trainable and not is_int and arr.ndim >= 1:
            # weight as a trainable VariableV2 with a Const initializer
            # wired through Assign — the layout load_tf_graph's variable
            # resolution consumes (reference un-frozen checkpoints)
            name = self.fresh(base)
            init = self.node(f"{name}/init", "Const", (),
                             _attr_tensor("value", arr),
                             _attr_type("dtype", dt))
            shape = b"".join(pw.enc_bytes(2, pw.enc_varint(1, d))
                             for d in arr.shape)
            self.node(name, "VariableV2", (),
                      _attr("shape", pw.enc_bytes(7, shape)),
                      _attr_type("dtype", dt))
            self.node(f"{name}/assign", "Assign", (name, init),
                      _attr_type("T", dt))
            return name
        return self.node(self.fresh(base), "Const", (),
                         _attr_tensor("value", arr),
                         _attr_type("dtype", dt))

    def const_frozen(self, base: str, arr) -> str:
        """Always a Const, regardless of ``trainable`` (for values that
        are data, not weights — folded BN stats, shape vectors)."""
        prev = self.trainable
        self.trainable = False
        try:
            return self.const(base, arr)
        finally:
            self.trainable = prev


def _pad_mode(m) -> str:
    ph, pw_ = m.pad
    if ph == -1 or pw_ == -1:
        return "SAME"
    if ph == 0 and pw_ == 0:
        return "VALID"
    raise NotImplementedError(
        f"{type(m).__name__} with explicit padding {m.pad} has no TF "
        "conv/pool padding-string equivalent; re-export with pad=0 or -1")


def _host(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _children(m: Module) -> List[Module]:
    return list(m._modules.values())


def _out_shape(m: Module, in_shape) -> tuple:
    """The output shape of one eval-mode forward of ``m`` on zeros of
    ``in_shape`` (a tuple of shapes for a table-valued module)."""
    p = next(iter(m.parameters()), None)
    dev = p.device if p is not None else torch.device("cpu")
    training = m.training
    m.eval()
    try:
        with torch.no_grad():
            out = m(torch.zeros(tuple(in_shape), device=dev))
    finally:
        m.train(training)
    if isinstance(out, (tuple, list)):
        return tuple(tuple(o.shape) for o in out)
    return tuple(out.shape)


def _emit(g: _GraphBuilder, m: Module, cur, shape: tuple):
    if isinstance(m, Remat):
        return _emit(g, m.inner, cur, shape)  # an execution hint only
    t = type(m).__name__
    if isinstance(m, Sequential):
        for c in _children(m):
            cur, shape = _emit(g, c, cur, shape)
        return cur, shape
    # table ops: branch structures (ConcatTable fan-out, the C*Table
    # reducers) map onto plain TF dataflow
    if t == "ConcatTable":
        outs = [_emit(g, c, cur, shape) for c in _children(m)]
        return [o for o, _ in outs], tuple(s for _, s in outs)
    if isinstance(cur, list):
        if t == "CAddTable":
            return g.node(g.fresh("addn"), "AddN", tuple(cur),
                          _attr_type("T")), shape[0]
        if t in ("CMulTable", "CMaxTable"):
            op = "Mul" if t == "CMulTable" else "Maximum"
            out = cur[0]
            for nxt in cur[1:]:
                out = g.node(g.fresh(op.lower()), op, (out, nxt),
                             _attr_type("T"))
            return out, shape[0]
        if t == "JoinTable":
            axis = g.const("axis", np.asarray(m.dimension, np.int32))
            out = g.node(g.fresh("concat"), "ConcatV2",
                         tuple(cur) + (axis,), _attr_type("T"))
            cat = list(shape[0])
            cat[m.dimension] = sum(s[m.dimension] for s in shape)
            return out, tuple(cat)
        raise NotImplementedError(
            f"TF export: table op {t} after ConcatTable is not mapped")
    out_shape = _out_shape(m, shape)
    if t == "Linear":
        w = g.const("weight", _host(m.weight))
        out = g.node(g.fresh("matmul"), "MatMul", (cur, w),
                     _attr_b("transpose_b", True), _attr_type("T"))
        if m.bias is not None:
            b = g.const("bias", _host(m.bias))
            out = g.node(g.fresh("biasadd"), "BiasAdd", (out, b),
                         _attr_type("T"))
        return out, out_shape
    if t == "SpatialConvolution":
        if m.n_group != 1:
            raise NotImplementedError("grouped conv export")
        wn = g.const("kernel", np.transpose(_host(m.weight), (2, 3, 1, 0)))
        df = m.format
        strides = ([1, m.stride[0], m.stride[1], 1] if df == "NHWC"
                   else [1, 1, m.stride[0], m.stride[1]])
        ph, pw_ = m.pad
        if ph > 0 or pw_ > 0:
            # explicit symmetric padding: a zero Pad node and a VALID conv
            pads = ([[0, 0], [ph, ph], [pw_, pw_], [0, 0]] if df == "NHWC"
                    else [[0, 0], [0, 0], [ph, ph], [pw_, pw_]])
            pc = g.const("pads", np.asarray(pads, np.int32))
            cur = g.node(g.fresh("pad"), "Pad", (cur, pc), _attr_type("T"))
            pad_str = "VALID"
        else:
            pad_str = _pad_mode(m)
        dils = ([1, m.dilation[0], m.dilation[1], 1] if df == "NHWC"
                else [1, 1, m.dilation[0], m.dilation[1]])
        out = g.node(g.fresh("conv"), "Conv2D", (cur, wn),
                     _attr_s("padding", pad_str),
                     _attr_s("data_format", df),
                     _attr_ilist("strides", strides),
                     _attr_ilist("dilations", dils), _attr_type("T"))
        if m.bias is not None:
            b = g.const("bias", _host(m.bias))
            out = g.node(g.fresh("biasadd"), "BiasAdd", (out, b),
                         _attr_s("data_format", df), _attr_type("T"))
        return out, out_shape
    if t in ("SpatialMaxPooling", "SpatialAveragePooling"):
        df = m.format
        ks = ([1, m.kernel[0], m.kernel[1], 1] if df == "NHWC"
              else [1, 1, m.kernel[0], m.kernel[1]])
        st = ([1, m.stride[0], m.stride[1], 1] if df == "NHWC"
              else [1, 1, m.stride[0], m.stride[1]])
        op = "MaxPool" if t == "SpatialMaxPooling" else "AvgPool"
        ph, pw_ = m.pad
        if op == "MaxPool" and (ph > 0 or pw_ > 0) and not m.ceil_mode:
            # explicit padding (ResNet's stem pool): a -inf PadV2 node and
            # a VALID pool are exactly equivalent.  The reference package's
            # exporter refuses this layer; its importer reads the file.
            pads = ([[0, 0], [ph, ph], [pw_, pw_], [0, 0]] if df == "NHWC"
                    else [[0, 0], [0, 0], [ph, ph], [pw_, pw_]])
            pc = g.const("pads", np.asarray(pads, np.int32))
            neg = g.const("pad_value", np.asarray(-np.inf, np.float32))
            cur = g.node(g.fresh("pad"), "PadV2", (cur, pc, neg),
                         _attr_type("T"))
            pad_str = "VALID"
        else:
            pad_str = _pad_mode(m)
        return g.node(g.fresh(op.lower()), op, (cur,),
                      _attr_s("padding", pad_str),
                      _attr_s("data_format", df),
                      _attr_ilist("ksize", ks), _attr_ilist("strides", st),
                      _attr_type("T")), out_shape
    if t in ("SpatialBatchNormalization", "BatchNormalization"):
        # the inference fold y = x*scale + shift, as numpy computes it in
        # the reference (its running statistics stay Consts even under
        # trainable=True: they are not weights)
        mean, var = _host(m.running_mean), _host(m.running_var)
        gamma = _host(m.weight) if m.affine else np.ones_like(mean)
        beta = _host(m.bias) if m.affine else np.zeros_like(mean)
        scale = gamma / np.sqrt(var + m.eps)
        shift = beta - mean * scale
        if t == "SpatialBatchNormalization" and m.format == "NCHW":
            scale = scale[:, None, None]
            shift = shift[:, None, None]
        sc = g.const_frozen("bn_scale", scale.astype(np.float32))
        sh = g.const_frozen("bn_shift", shift.astype(np.float32))
        out = g.node(g.fresh("bn_mul"), "Mul", (cur, sc), _attr_type("T"))
        return g.node(g.fresh("bn_add"), "Add", (out, sh),
                      _attr_type("T")), out_shape
    if t in ("Reshape", "View", "Flatten"):
        tgt = g.const("shape", np.asarray((-1,) + tuple(out_shape[1:]),
                                          np.int32))
        return g.node(g.fresh("reshape"), "Reshape", (cur, tgt),
                      _attr_type("T")), out_shape
    if t == "Dropout":
        return g.node(g.fresh("dropout_identity"), "Identity", (cur,),
                      _attr_type("T")), out_shape
    simple = {"ReLU": "Relu", "ReLU6": "Relu6", "Tanh": "Tanh",
              "Sigmoid": "Sigmoid", "SoftMax": "Softmax",
              "LogSoftMax": "LogSoftmax", "ELU": "Elu",
              "SoftPlus": "Softplus", "Identity": "Identity",
              "Abs": "Abs", "Exp": "Exp", "Sqrt": "Sqrt",
              "Square": "Square"}
    if t in simple:
        return g.node(g.fresh(t.lower()), simple[t], (cur,),
                      _attr_type("T")), out_shape
    raise NotImplementedError(f"TF export for module {t}")


def save_tf_graph(model: Module, path: str, input_shape: Sequence[int],
                  input_name: str = "input", output_name: str = "output",
                  trainable: bool = False) -> Tuple[str, str]:
    """Export ``model`` as a GraphDef.  ``input_shape`` includes the batch
    axis (the shapes only make Reshape targets static; any batch feeds the
    placeholder).  Returns (input_name, output_name); ``load_tf_graph(path,
    [input], [output])`` reads it back.  ``trainable=False`` freezes the
    weights as Consts; ``trainable=True`` writes them as VariableV2 nodes
    with Assign initializers, which the importer makes parameters."""
    g = _GraphBuilder()
    g.trainable = trainable
    g.node(input_name, "Placeholder", (), _attr_type("dtype"))
    last, _ = _emit(g, model, input_name, tuple(input_shape))
    g.node(output_name, "Identity", (last,), _attr_type("T"))
    with open(path, "wb") as f:
        f.write(b"".join(g.nodes))
    return input_name, output_name

"""Caffe model exporter: prototxt plus caffemodel (port of
``bigdl_tpu/interop/caffe_export.py``).

Walks a :class:`Graph` or :class:`Sequential` of the classic CNN layer set,
converts each module to Caffe ``LayerParameter`` s and writes the text
prototxt (topology and hyper-parameters) and the binary caffemodel (weight
blobs keyed by layer name), byte-identical to the reference package's
files for the same model and weights.  BatchNorm becomes ``BatchNorm``
(its running statistics, scale factor 1) plus ``Scale`` (its affine
weights).  ``ConcatTable`` is not mapped: build branches as a Graph.

Wire schema used (caffe.proto):
  NetParameter: name=1, layer=100
  LayerParameter: name=1, type=2, bottom=3, top=4, blobs=7
  BlobProto: data=5 (packed float), shape=7 {dim=1}
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.module import Module, Remat, Sequential
from bigdl_tpu_torch.utils import protowire as pw


class _Layer:
    """One emitted Caffe layer: prototxt text params + weight blobs."""

    __slots__ = ("name", "type", "bottoms", "tops", "param_text", "blobs")

    def __init__(self, name, type_, bottoms, tops, param_text="", blobs=()):
        self.name = name
        self.type = type_
        self.bottoms = list(bottoms)
        self.tops = list(tops)
        self.param_text = param_text
        self.blobs = list(blobs)


def _np(t) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def _convert(mod: Module, name: str) -> List[Tuple[str, str, list]]:
    """module → [(caffe type, param text, blobs)] — one entry per emitted
    layer (BN with affine emits BatchNorm + Scale, the Caffe idiom)."""
    if isinstance(mod, nn.SpatialConvolution):
        kh, kw = mod.kernel
        sh, sw = mod.stride
        ph, pw_ = mod.pad
        dh, dw = mod.dilation
        if dh != dw:
            raise NotImplementedError(
                f"Caffe dilation is isotropic; conv {name!r} has "
                f"dilation {(dh, dw)}")
        txt = (f"  convolution_param {{\n"
               f"    num_output: {mod.n_output_plane}\n"
               f"    bias_term: {'true' if mod.with_bias else 'false'}\n"
               f"    kernel_h: {kh}\n    kernel_w: {kw}\n"
               f"    stride_h: {sh}\n    stride_w: {sw}\n"
               f"    pad_h: {ph}\n    pad_w: {pw_}\n"
               f"    group: {mod.n_group}\n"
               + (f"    dilation: {dh}\n" if dh == dw and dh != 1 else "")
               + "  }")
        blobs = [_np(mod.weight)]
        if mod.with_bias:
            blobs.append(_np(mod.bias))
        return [("Convolution", txt, blobs)]
    if isinstance(mod, nn.Linear):
        txt = (f"  inner_product_param {{\n"
               f"    num_output: {mod.output_size}\n"
               f"    bias_term: {'true' if mod.with_bias else 'false'}\n"
               f"  }}")
        blobs = [_np(mod.weight)]
        if mod.with_bias:
            blobs.append(_np(mod.bias))
        return [("InnerProduct", txt, blobs)]
    if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        pool = "MAX" if isinstance(mod, nn.SpatialMaxPooling) else "AVE"
        kh, kw = mod.kernel
        sh, sw = mod.stride
        ph, pw_ = mod.pad
        txt = (f"  pooling_param {{\n    pool: {pool}\n"
               f"    kernel_h: {kh}\n    kernel_w: {kw}\n"
               f"    stride_h: {sh}\n    stride_w: {sw}\n"
               f"    pad_h: {ph}\n    pad_w: {pw_}\n  }}")
        return [("Pooling", txt, [])]
    if isinstance(mod, nn.SpatialBatchNormalization):
        out = []
        mean, var = _np(mod.running_mean), _np(mod.running_var)
        txt = (f"  batch_norm_param {{\n    use_global_stats: true\n"
               f"    eps: {mod.eps}\n  }}")
        out.append(("BatchNorm", txt,
                    [mean, var, np.asarray([1.0], np.float32)]))
        if mod.affine:
            out.append(("Scale", "  scale_param {\n    bias_term: true\n  }",
                        [_np(mod.weight), _np(mod.bias)]))
        return out
    if isinstance(mod, nn.Scale):
        return [("Scale", "  scale_param {\n    bias_term: true\n  }",
                 [_np(mod.mul.weight).reshape(-1),
                  _np(mod.add.bias).reshape(-1)])]
    if isinstance(mod, nn.SpatialCrossMapLRN):
        txt = (f"  lrn_param {{\n    local_size: {mod.size}\n"
               f"    alpha: {mod.alpha}\n    beta: {mod.beta}\n"
               f"    k: {mod.k}\n  }}")
        return [("LRN", txt, [])]
    if isinstance(mod, nn.Dropout):
        return [("Dropout",
                 f"  dropout_param {{\n    dropout_ratio: {mod.p}\n  }}",
                 [])]
    if isinstance(mod, nn.JoinTable):
        return [("Concat",
                 f"  concat_param {{\n    axis: {mod.dimension}\n  }}", [])]
    simple = {nn.ReLU: "ReLU", nn.Tanh: "TanH", nn.Sigmoid: "Sigmoid",
              nn.SoftMax: "Softmax", nn.Flatten: "Flatten"}
    for cls, t in simple.items():
        if type(mod) is cls:
            return [(t, "", [])]
    if isinstance(mod, nn.CAddTable):
        return [("Eltwise", "  eltwise_param {\n    operation: SUM\n  }", [])]
    if isinstance(mod, nn.CMulTable):
        return [("Eltwise", "  eltwise_param {\n    operation: PROD\n  }", [])]
    if isinstance(mod, nn.CMaxTable):
        return [("Eltwise", "  eltwise_param {\n    operation: MAX\n  }", [])]
    if isinstance(mod, nn.Identity):
        return []
    raise NotImplementedError(
        f"no Caffe mapping for {type(mod).__name__} ({name}); reference "
        "CaffePersister supports the classic CNN layer set only")


def _emit(mod: Module, bottom: str, layers: List[_Layer],
          used: Dict[str, int]) -> str:
    """Emit `mod` (expanding Sequential chains), return its top name."""
    if isinstance(mod, Remat):
        # an execution hint only: export the wrapped module
        return _emit(mod.inner, bottom, layers, used)
    if isinstance(mod, Sequential):
        top = bottom
        for child in mod._modules.values():
            top = _emit(child, top, layers, used)
        return top
    converted = _convert(mod, mod.name)
    top = bottom
    for type_, txt, blobs in converted:
        base = mod.name if len(converted) == 1 else \
            f"{mod.name}_{type_.lower()}"
        n = used.get(base, 0)
        used[base] = n + 1
        lname = base if n == 0 else f"{base}_{n}"
        layers.append(_Layer(lname, type_, [top], [lname], txt, blobs))
        top = lname
    return top


def save_caffe(module: Module, prototxt_path: str, model_path: str,
               input_shapes: Optional[Sequence[Sequence[int]]] = None
               ) -> None:
    """Write ``module`` as Caffe prototxt + caffemodel (reference
    ``CaffePersister.persist``).

    Supports :class:`nn.Graph` and :class:`nn.Sequential` trees over the
    classic CNN layer set (Convolution/InnerProduct/Pooling/BN/LRN/
    activations/Concat/Eltwise).  ``input_shapes`` (one ``[N,C,H,W]``
    per graph input) is emitted as ``input_shape`` so Caffe can
    materialize the net; omitted dims are left for the consumer.
    """
    layers: List[_Layer] = []
    used: Dict[str, int] = {}
    input_names: List[str] = []

    if isinstance(module, Graph):
        tops: Dict[int, str] = {}
        for i, inp in enumerate(module.input_nodes):
            nm = "data" if len(module.input_nodes) == 1 else f"data{i}"
            tops[id(inp)] = nm
            input_names.append(nm)
        for node in module._order:
            bots = [tops[id(b)] for b in node.inputs]
            mod = node.module
            if isinstance(mod, Sequential) or len(bots) == 1:
                top = _emit(mod, bots[0], layers, used)
            else:
                converted = _convert(mod, mod.name)
                if len(converted) != 1:
                    raise NotImplementedError(
                        f"multi-input module {mod.name} must convert to "
                        "exactly one Caffe layer")
                type_, txt, blobs = converted[0]
                n = used.get(mod.name, 0)
                used[mod.name] = n + 1
                lname = mod.name if n == 0 else f"{mod.name}_{n}"
                layers.append(_Layer(lname, type_, bots, [lname], txt,
                                     blobs))
                top = lname
            tops[id(node)] = top
    else:
        input_names.append("data")
        _emit(module, "data", layers, used)

    net_name = module.name or "BigDLNet"
    # ---- prototxt
    lines = [f'name: "{net_name}"']
    for i, nm in enumerate(input_names):
        lines.append(f'input: "{nm}"')
        if input_shapes is not None:
            dims = "".join(f"\n  dim: {int(d)}" for d in input_shapes[i])
            lines.append(f"input_shape {{{dims}\n}}")
    for l in layers:
        body = [f'layer {{', f'  name: "{l.name}"', f'  type: "{l.type}"']
        for b in l.bottoms:
            body.append(f'  bottom: "{b}"')
        for t in l.tops:
            body.append(f'  top: "{t}"')
        if l.param_text:
            body.append(l.param_text)
        body.append("}")
        lines.append("\n".join(body))
    with open(prototxt_path, "w") as f:
        f.write("\n".join(lines) + "\n")

    # ---- caffemodel
    out = bytearray()
    out += pw.enc_str(1, net_name)
    for l in layers:
        msg = bytearray()
        msg += pw.enc_str(1, l.name)
        msg += pw.enc_str(2, l.type)
        for b in l.bottoms:
            msg += pw.enc_str(3, b)
        for t in l.tops:
            msg += pw.enc_str(4, t)
        for blob in l.blobs:
            shape = b"".join(pw.enc_varint(1, int(d)) for d in blob.shape)
            bp = pw.enc_packed_floats(5, blob.reshape(-1).tolist()) \
                + pw.enc_bytes(7, shape)
            msg += pw.enc_bytes(7, bp)
        out += pw.enc_bytes(100, bytes(msg))
    with open(model_path, "wb") as f:
        f.write(bytes(out))

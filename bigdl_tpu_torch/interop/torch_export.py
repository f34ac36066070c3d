"""Torch7 nn-module trees: export and import (port of
``bigdl_tpu/interop/torch_export.py``).

A Torch7 model file is the module object itself: class name plus field
table (weight/bias/gradWeight/gradBias arrays and the hyper-parameters),
what BigDL's ``ConvertModel --to torch`` writes and ``Module.loadTorch``
reads.  Export walks the port's modules into that layout (weights as f64
``DoubleTensor`` s, as the reference writes them, so the files are
byte-identical); import builds port modules on the CPU from it.  The
Lua-object wire layout is ``torch_format``'s.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.torch_format import load_t7, save_t7
from bigdl_tpu_torch.nn.module import Module, Remat, Sequential


def _np(t) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def _obj(cls: str, **fields) -> Dict[str, Any]:
    return {"_torch_class": cls,
            "fields": {k: v for k, v in fields.items() if v is not None}}


def _with_grads(fields: Dict[str, Any]) -> Dict[str, Any]:
    if "weight" in fields:
        fields["gradWeight"] = np.zeros_like(fields["weight"])
    if fields.get("bias") is not None:
        fields["gradBias"] = np.zeros_like(fields["bias"])
    return fields


def _weights(mod) -> Dict[str, Any]:
    return _with_grads({"weight": _np(mod.weight),
                        "bias": None if mod.bias is None else _np(mod.bias)})


_SIMPLE = {nn.ReLU: "nn.ReLU", nn.Tanh: "nn.Tanh", nn.Sigmoid: "nn.Sigmoid",
           nn.SoftMax: "nn.SoftMax", nn.LogSoftMax: "nn.LogSoftMax",
           nn.Identity: "nn.Identity"}


def module_to_torch(mod: Module) -> Dict[str, Any]:
    """One module (and its weights) as a Torch7 object tree."""
    if isinstance(mod, Remat):
        return module_to_torch(mod.inner)  # an execution hint only
    if isinstance(mod, Sequential):
        return _obj("nn.Sequential", modules=[
            module_to_torch(c) for c in mod._modules.values()])
    if isinstance(mod, nn.Linear):
        return _obj("nn.Linear", **_weights(mod))
    if isinstance(mod, nn.SpatialConvolution):
        (kh, kw), (sh, sw), (ph, pw) = mod.kernel, mod.stride, mod.pad
        return _obj("nn.SpatialConvolution",
                    nInputPlane=mod.n_input_plane,
                    nOutputPlane=mod.n_output_plane,
                    kW=kw, kH=kh, dW=sw, dH=sh, padW=pw, padH=ph,
                    **_weights(mod))
    if isinstance(mod, (nn.SpatialMaxPooling, nn.SpatialAveragePooling)):
        (kh, kw), (sh, sw), (ph, pw) = mod.kernel, mod.stride, mod.pad
        extra = {} if isinstance(mod, nn.SpatialMaxPooling) \
            else {"count_include_pad": mod.count_include_pad}
        return _obj(f"nn.{type(mod).__name__}", kW=kw, kH=kh, dW=sw, dH=sh,
                    padW=pw, padH=ph, ceil_mode=mod.ceil_mode, **extra)
    if isinstance(mod, nn.SpatialBatchNormalization):
        f: Dict[str, Any] = {"running_mean": _np(mod.running_mean),
                             "running_var": _np(mod.running_var),
                             "eps": mod.eps, "momentum": mod.momentum,
                             "affine": mod.affine, "nOutput": mod.n_output}
        if mod.affine:
            f = _with_grads({**f, "weight": _np(mod.weight),
                             "bias": _np(mod.bias)})
        return _obj("nn.SpatialBatchNormalization", **f)
    if isinstance(mod, nn.LookupTable):
        return _obj("nn.LookupTable",
                    **_with_grads({"weight": _np(mod.weight)}))
    if isinstance(mod, nn.SpatialCrossMapLRN):
        return _obj("nn.SpatialCrossMapLRN", size=mod.size, alpha=mod.alpha,
                    beta=mod.beta, k=mod.k)
    if isinstance(mod, nn.Dropout):
        return _obj("nn.Dropout", p=mod.p)
    if isinstance(mod, nn.Reshape):
        return _obj("nn.Reshape", size=list(mod.size))
    if isinstance(mod, nn.Flatten):
        # torch's idiom for flatten-all-but-batch
        return _obj("nn.View", numElements=-1, size=[-1])
    for cls, tname in _SIMPLE.items():
        if type(mod) is cls:
            return _obj(tname)
    raise NotImplementedError(
        f"no Torch7 mapping for {type(mod).__name__} (the classic torch nn "
        "layer set only)")


def save_torch_module(module: Module, path: str) -> None:
    """Write ``module`` as a Torch7 nn object tree (``.t7``)."""
    save_t7(path, module_to_torch(module))


# --------------------------------------------------------------- importing
def _put(t: torch.Tensor, arr) -> None:
    with torch.no_grad():
        t.copy_(torch.from_numpy(
            np.asarray(arr, np.float32).reshape(tuple(t.shape))))


def torch_to_module(tree) -> Module:
    """A Torch7 object tree (from :func:`load_t7`) as a port module on the
    CPU with its weights (the reference's ``Module.loadTorch``)."""
    if not (isinstance(tree, dict) and "_torch_class" in tree):
        raise ValueError(f"not a torch module object: {type(tree)}")
    cls = tree["_torch_class"].split(".")[-1]
    f = tree.get("fields", {}) or {}

    def arr(key):
        v = f.get(key)
        return None if v is None else np.asarray(v, np.float32)

    def sized(key, default=None):
        v = f.get(key, default)
        return int(v) if v is not None else None

    if cls == "Sequential":
        return nn.Sequential(*[torch_to_module(m)
                               for m in f.get("modules", [])])
    if cls == "Linear":
        w, b = arr("weight"), arr("bias")
        m = nn.Linear(w.shape[1], w.shape[0], with_bias=b is not None)
        _put(m.weight, w)
        if b is not None:
            _put(m.bias, b)
        return m
    if cls in ("SpatialConvolution", "SpatialConvolutionMM"):
        w, b = arr("weight"), arr("bias")
        n_out = sized("nOutputPlane", w.shape[0])
        m = nn.SpatialConvolution(
            sized("nInputPlane"), n_out, sized("kW"), sized("kH"),
            sized("dW", 1), sized("dH", 1), sized("padW", 0),
            sized("padH", 0), with_bias=b is not None)
        _put(m.weight, w)
        if b is not None:
            _put(m.bias, b)
        return m
    if cls in ("SpatialMaxPooling", "SpatialAveragePooling"):
        kw = {"ceil_mode": bool(f.get("ceil_mode", False))}
        if cls == "SpatialAveragePooling":
            kw["count_include_pad"] = bool(f.get("count_include_pad", True))
        return getattr(nn, cls)(
            sized("kW"), sized("kH"), sized("dW", 1), sized("dH", 1),
            sized("padW", 0), sized("padH", 0), **kw)
    if cls == "SpatialBatchNormalization":
        mean = arr("running_mean")
        m = nn.SpatialBatchNormalization(
            sized("nOutput", mean.shape[0]), eps=float(f.get("eps", 1e-5)),
            momentum=float(f.get("momentum", 0.1)),
            affine=bool(f.get("affine", arr("weight") is not None)))
        if m.affine:
            _put(m.weight, arr("weight"))
            _put(m.bias, arr("bias"))
        _put(m.running_mean, mean)
        _put(m.running_var, arr("running_var"))
        return m
    if cls == "LookupTable":
        w = arr("weight")
        m = nn.LookupTable(w.shape[0], w.shape[1])
        _put(m.weight, w)
        return m
    if cls == "SpatialCrossMapLRN":
        return nn.SpatialCrossMapLRN(
            sized("size", 5), float(f.get("alpha", 1.0)),
            float(f.get("beta", 0.75)), float(f.get("k", 1.0)))
    if cls == "Dropout":
        return nn.Dropout(float(f.get("p", 0.5)))
    if cls == "Reshape":
        return nn.Reshape(tuple(int(d) for d in f.get("size", [])))
    if cls == "View":
        size = [int(d) for d in np.ravel(np.asarray(f.get("size", [-1])))]
        if size == [-1]:     # flatten-all-but-batch (the export idiom)
            return nn.Flatten()
        return nn.View(tuple(size))
    simple = {"ReLU": nn.ReLU, "Tanh": nn.Tanh, "Sigmoid": nn.Sigmoid,
              "SoftMax": nn.SoftMax, "LogSoftMax": nn.LogSoftMax,
              "Identity": nn.Identity}
    if cls in simple:
        return simple[cls]()
    raise NotImplementedError(f"torch class nn.{cls} is not mapped")


def load_torch_module(path: str) -> Module:
    """A ``.t7`` holding a Torch7 nn module tree, as a port module."""
    return torch_to_module(load_t7(path))

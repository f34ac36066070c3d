"""Keras 1.2 JSON definition importer (port of
``bigdl_tpu/interop/keras_format.py``).

A Keras-1.2.2 ``model.to_json()`` document maps onto the deferred
``bigdl_tpu_torch.keras`` wrappers, which carry the Keras-1.2 layer
surface and shape inference, so the converter is a config translation.
``set_keras_weights`` installs a flat list of arrays in Keras order;
``load_keras_hdf5_weights`` reads that list from a Keras HDF5 file
through ``h5py``, imported inside the function, so the package imports
without it.  (``keras`` is imported inside the functions too: it builds
on ``optim``, which imports this package.)
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

import numpy as np
import torch


def _batchless_shape(bis) -> tuple:
    """batch_input_shape -> batch-less tuple; a dynamic (null) dim past
    the batch raises."""
    dims = bis[1:]
    if any(d is None for d in dims):
        raise NotImplementedError(
            f"dynamic (null) input dimensions {bis} are not supported; "
            "fix the shape in the Keras config before import")
    return tuple(int(d) for d in dims)


def _layer_from_config(entry: Dict[str, Any]):
    from bigdl_tpu_torch import keras as K
    cls = entry["class_name"]
    cfg = entry.get("config", {})

    def input_shape():
        bis = cfg.get("batch_input_shape")
        if bis:
            return _batchless_shape(bis)
        if cfg.get("input_dim"):
            return (int(cfg["input_dim"]),)
        return None

    common = {"input_shape": input_shape(), "name": cfg.get("name")}
    if cls == "Dense":
        return K.Dense(int(cfg["output_dim"]),
                       activation=cfg.get("activation"),
                       bias=cfg.get("bias", True), **common)
    if cls == "Activation":
        return K.Activation(cfg["activation"], **common)
    if cls == "Dropout":
        return K.Dropout(float(cfg.get("p", 0.5)), **common)
    if cls == "Flatten":
        return K.Flatten(**common)
    if cls == "Reshape":
        return K.Reshape(tuple(cfg["target_shape"]), **common)
    if cls == "Convolution2D":
        return K.Convolution2D(
            int(cfg["nb_filter"]), int(cfg["nb_row"]), int(cfg["nb_col"]),
            activation=cfg.get("activation"),
            border_mode=cfg.get("border_mode", "valid"),
            subsample=tuple(cfg.get("subsample", (1, 1))),
            dim_ordering=cfg.get("dim_ordering", "th"),
            bias=cfg.get("bias", True), **common)
    if cls == "Convolution1D":
        return K.Convolution1D(
            int(cfg["nb_filter"]), int(cfg["filter_length"]),
            activation=cfg.get("activation"),
            subsample_length=int(cfg.get("subsample_length", 1)), **common)
    if cls in ("MaxPooling2D", "AveragePooling2D"):
        klass = K.MaxPooling2D if cls == "MaxPooling2D" \
            else K.AveragePooling2D
        return klass(pool_size=tuple(cfg.get("pool_size", (2, 2))),
                     strides=(tuple(cfg["strides"])
                              if cfg.get("strides") else None),
                     border_mode=cfg.get("border_mode", "valid"),
                     dim_ordering=cfg.get("dim_ordering", "th"), **common)
    if cls == "GlobalAveragePooling2D":
        return K.GlobalAveragePooling2D(
            dim_ordering=cfg.get("dim_ordering", "th"), **common)
    if cls == "GlobalMaxPooling2D":
        return K.GlobalMaxPooling2D(
            dim_ordering=cfg.get("dim_ordering", "th"), **common)
    if cls == "ZeroPadding2D":
        return K.ZeroPadding2D(tuple(cfg.get("padding", (1, 1))),
                               dim_ordering=cfg.get("dim_ordering", "th"),
                               **common)
    if cls == "BatchNormalization":
        return K.BatchNormalization(
            epsilon=float(cfg.get("epsilon", 1e-3)),
            momentum=float(cfg.get("momentum", 0.99)),
            dim_ordering=cfg.get("dim_ordering", "th"), **common)
    if cls == "Embedding":
        return K.Embedding(int(cfg["input_dim"]), int(cfg["output_dim"]),
                           input_length=cfg.get("input_length"), **common)
    if cls in ("LSTM", "GRU", "SimpleRNN"):
        klass = {"LSTM": K.LSTM, "GRU": K.GRU,
                 "SimpleRNN": K.SimpleRNN}[cls]
        return klass(int(cfg["output_dim"]),
                     return_sequences=cfg.get("return_sequences", False),
                     go_backwards=cfg.get("go_backwards", False), **common)
    raise NotImplementedError(
        f"Keras 1.2 layer {cls!r} is not mapped")


def load_keras_json(json_str_or_path: str):
    """Keras-1.2 ``model.to_json()`` (the text or a file path) -> a
    topology: ``Sequential`` JSON gives a :class:`keras.Sequential`,
    functional ``Model`` JSON an ``nn.Graph`` wrapped in
    :class:`keras.Model`."""
    from bigdl_tpu_torch import keras as K
    text = json_str_or_path
    if not text.lstrip().startswith("{"):
        with open(json_str_or_path) as f:
            text = f.read()
    doc = json.loads(text)
    cls = doc.get("class_name")
    if cls == "Sequential":
        model = K.Sequential()
        for entry in doc.get("config", []):
            model.add(_layer_from_config(entry))
        return model
    if cls == "Model":
        return _load_functional_model(doc["config"])
    raise NotImplementedError(f"Keras model class {cls!r}")


def _load_functional_model(cfg: dict) -> "keras.Model":
    """A functional-API graph: layers connected by ``inbound_nodes``, each
    wrapper built once its input shape is known, walked in the listed
    (topological) order; a multi-input layer (Merge) receives a node
    list.  A layer with several ``inbound_nodes`` entries is built ONCE
    and applied per call, so its graph nodes share the module: tied
    weights.  Graph tensors are keyed by ``(layer_name, node_index)``."""
    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch.keras.layers import infer_output_shape
    from bigdl_tpu_torch.nn.graph import Graph, Input as GInput

    nodes: Dict[tuple, Any] = {}
    shapes: Dict[tuple, tuple] = {}

    def src_key(ib_entry) -> tuple:
        # inbound ref = [layer_name, node_index, tensor_index, ...]
        return (ib_entry[0], int(ib_entry[1]) if len(ib_entry) > 1 else 0)

    for entry in cfg.get("layers", []):
        name = entry.get("name") or entry["config"].get("name")
        lcls = entry["class_name"]
        inbound = entry.get("inbound_nodes") or []
        if lcls == "InputLayer":
            nodes[(name, 0)] = GInput()
            bis = entry["config"].get("batch_input_shape")
            shapes[(name, 0)] = _batchless_shape(bis or [None])
            continue
        if lcls == "Merge":
            cfg_m = entry["config"]
            mode = cfg_m.get("mode", "sum")
            axis = int(cfg_m.get("concat_axis", -1))
            core = K.Merge(mode=mode, concat_axis=axis).build(None)
            for call_ix, ib in enumerate(inbound):
                srcs = [src_key(s) for s in ib]
                nodes[(name, call_ix)] = core([nodes[s] for s in srcs])
                s0 = shapes[srcs[0]]
                if mode == "concat":
                    # Keras concat_axis counts the batch dim; the shapes
                    # here are batch-less
                    ax = axis - 1 if axis > 0 else len(s0) + axis
                    cat = list(s0)
                    cat[ax] = sum(shapes[s][ax] for s in srcs)
                    shapes[(name, call_ix)] = tuple(cat)
                else:
                    shapes[(name, call_ix)] = s0
            continue
        if not inbound:
            raise NotImplementedError(
                f"layer {name!r} ({lcls}) has no inbound nodes")
        core = None
        built_shape = None
        for call_ix, ib in enumerate(inbound):
            srcs = [src_key(s) for s in ib]
            if len(srcs) != 1:
                raise NotImplementedError(
                    f"layer {name!r} ({lcls}) with {len(srcs)} inbound "
                    "tensors")
            in_shape = shapes[srcs[0]]
            if core is None:
                core = _layer_from_config(entry).build(in_shape)
                built_shape = in_shape
            elif in_shape != built_shape:
                raise NotImplementedError(
                    f"shared layer {name!r} called with differing input "
                    f"shapes {built_shape} vs {in_shape}")
            shapes[(name, call_ix)] = infer_output_shape(core, in_shape)
            nodes[(name, call_ix)] = core(nodes[srcs[0]])

    # bind inputs in the DECLARED order (cfg["input_layers"]), which may
    # differ from the order Keras lists the layers in
    in_keys = [src_key(i) for i in cfg.get("input_layers", [])]
    if not in_keys:  # fall back to listing order
        in_keys = [(e.get("name") or e["config"].get("name"), 0)
                   for e in cfg.get("layers", [])
                   if e["class_name"] == "InputLayer"]
    inputs = [nodes[i] for i in in_keys]
    out_keys = [src_key(o) for o in cfg.get("output_layers", [])]
    graph = Graph(inputs, [nodes[o] for o in out_keys],
                  name=cfg.get("name", "KerasModel"))
    return K.Model(graph.initialize(0))


def _children(m: torch.nn.Module):
    """The modules ``m``'s weight tree nests, in the reference's order:
    the inner module of a ``Recurrent``/``TimeDistributed`` (a wrapper
    whose tree is its inner module's), else the children, index-keyed
    ones by index; None for a leaf."""
    from bigdl_tpu_torch.interop.jax_weights import _wrapped
    inner = _wrapped(m)
    if inner is not None:
        return [inner]
    kids = list(m.named_children())
    if not kids:
        return None
    if all(k.isdigit() for k, _ in kids):
        kids.sort(key=lambda kv: int(kv[0]))
    return [c for _, c in kids]


def set_keras_weights(model: "keras.Sequential",
                      weights: List[np.ndarray]) -> None:
    """Install a flat Keras-order weight list (each layer's
    ``get_weights()`` concatenated) into the built core module, in
    place.  Keras Dense stores W as (in, out): it is transposed into
    (out, in); a ``dim_ordering="tf"`` conv kernel (kh, kw, in, out)
    becomes OIHW.  Keras-1.2 BatchNormalization saves FOUR arrays
    (gamma, beta, running_mean, running_std), and its ``running_std``
    holds the *variance*, so it is installed as ``running_var``
    unchanged."""
    core = model.core_module()
    w_ix = 0

    def take():
        nonlocal w_ix
        w = np.asarray(weights[w_ix])
        w_ix += 1
        return w

    def put(t: torch.Tensor, w: np.ndarray) -> None:
        t.copy_(torch.from_numpy(np.ascontiguousarray(w, np.float32)
                                 ).reshape(t.shape))

    def fill(module):
        p = dict(module.named_parameters(recurse=False))
        s = dict(module.named_buffers(recurse=False))
        if "running_mean" in s:
            # BatchNormalization: gamma, beta, mean, std(=var)
            if "weight" in p:
                put(p["weight"], take())
                put(p["bias"], take())
            put(s["running_mean"], take())
            put(s["running_var"], take())
            return
        if "weight" in p:
            w = take()
            tgt = tuple(p["weight"].shape)
            if w.ndim == 2 and w.shape == tgt[::-1]:
                w = w.T               # Keras Dense (in,out) -> (out,in)
            elif w.ndim == 4 and w.shape != tgt:
                # Keras th conv kernels are already (out,in,kh,kw);
                # tf ordering (kh,kw,in,out) -> OIHW
                w = np.transpose(w, (3, 2, 0, 1))
            put(p["weight"], w)
        if p.get("bias") is not None:
            put(p["bias"], take())

    def walk(module):
        children = _children(module)
        if children is None:
            fill(module)
            return
        for c in children:
            walk(c)

    with torch.no_grad():
        walk(core)
    if w_ix != len(weights):
        raise ValueError(f"consumed {w_ix} of {len(weights)} weight arrays")


def load_keras_hdf5_weights(model: "keras.Sequential", h5_path: str) -> None:
    """Load weights from a Keras-1.2 HDF5 file (needs ``h5py``)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5py is not installed; extract the weight arrays yourself "
            "and call set_keras_weights(model, arrays)") from e
    arrays: List[np.ndarray] = []
    with h5py.File(h5_path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        names = [n.decode() if isinstance(n, bytes) else n
                 for n in grp.attrs.get("layer_names", [])]
        for lname in names:
            g = grp[lname]
            wn = [n.decode() if isinstance(n, bytes) else n
                  for n in g.attrs.get("weight_names", [])]
            for w in wn:
                arrays.append(np.asarray(g[w]))
    set_keras_weights(model, arrays)

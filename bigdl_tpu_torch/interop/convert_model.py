"""Model conversion CLI (port of ``bigdl_tpu/interop/convert_model.py``).

``--from {bigdl,caffe,torch,tensorflow,keras} --to {bigdl,caffe,torch}``,
with ``--prototxt`` for Caffe sources, ``--tf_inputs``/``--tf_outputs`` for
TensorFlow sources, ``--weights`` (a Keras HDF5 file) for Keras JSON
sources and ``--quantize`` for int8 post-training quantization of a BigDL
target.  The model is moved once to ``--device`` (default
``cuda``, which must exist; ``cpu`` when asked), where the ``--quantize``
parity check runs the float and the int8 model on one probe batch.

Usage:
    python -m bigdl_tpu_torch.interop.convert_model \\
        --from caffe --prototxt net.prototxt --input net.caffemodel \\
        --to bigdl --output model.bigdl [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

def load_model(fmt: str, path: str, *, prototxt=None, tf_inputs=None,
               tf_outputs=None, weights=None):
    """A model from an interop file, on the CPU.  A Keras JSON definition
    takes its weights from ``weights``: a Keras HDF5 file's path, or the
    arrays themselves in Keras order (``set_keras_weights``)."""
    fmt = fmt.lower()
    if fmt == "bigdl":
        from bigdl_tpu_torch.interop.bigdl_format import load_bigdl_module
        return load_bigdl_module(path)
    if fmt == "caffe":
        if not prototxt:
            raise ValueError("the caffe format needs a prototxt")
        from bigdl_tpu_torch.interop.caffe_format import load_caffe_model
        return load_caffe_model(prototxt, path)
    if fmt == "torch":
        from bigdl_tpu_torch.interop.torch_export import load_torch_module
        return load_torch_module(path)
    if fmt in ("tf", "tensorflow"):
        if not (tf_inputs and tf_outputs):
            raise ValueError(
                "the tensorflow format needs tf_inputs and tf_outputs")
        from bigdl_tpu_torch.interop.tf_format import load_tf_graph
        return load_tf_graph(path, inputs=tf_inputs, outputs=tf_outputs)
    if fmt == "keras":
        from bigdl_tpu_torch.interop.keras_format import (
            load_keras_hdf5_weights, load_keras_json, set_keras_weights)
        model = load_keras_json(path)
        if isinstance(weights, str):
            load_keras_hdf5_weights(model, weights)
        elif weights is not None:
            set_keras_weights(model, list(weights))
        return model.core_module()
    raise ValueError(f"unknown model format {fmt!r}; expected "
                     "bigdl|caffe|torch|tensorflow|keras")


def _load(args):
    try:
        return load_model(
            args.src_fmt, args.input, prototxt=args.prototxt,
            tf_inputs=args.tf_inputs.split(",") if args.tf_inputs else None,
            tf_outputs=args.tf_outputs.split(",") if args.tf_outputs
            else None, weights=args.weights)
    except ValueError as e:
        raise SystemExit(f"--from {args.src_fmt}: {e}")


def _probe_input(model):
    """(a small f32 probe batch, its spatial axes or None) shaped for the
    first Linear ((4, in)) or SpatialConvolution ((2, C, H, W) in its data
    format) met in declaration order, or (None, None) when the tree has
    neither."""
    from bigdl_tpu_torch.nn.layers import Linear, SpatialConvolution
    from bigdl_tpu_torch.nn.module import Container

    queue = [model]
    while queue:
        m = queue.pop(0)
        axes = None
        if isinstance(m, Linear):
            shape = (4, m.input_size)
        elif isinstance(m, SpatialConvolution):
            kh, kw = m.kernel
            h, w = max(8, kh), max(8, kw)
            nchw = m.format == "NCHW"
            shape = ((2, m.n_input_plane, h, w) if nchw
                     else (2, h, w, m.n_input_plane))
            axes = (2, 3) if nchw else (1, 2)
        elif isinstance(m, Container):
            queue = list(m._modules.values()) + queue
            continue
        else:
            continue
        return np.random.default_rng(0).standard_normal(shape) \
            .astype(np.float32), axes
    return None, None


PROBE_SIZES = (8, 32, 64, 128, 224)


def _probe_outputs(source, quantized, x, axes, device):
    """Both models' outputs on the probe ``x``, or on the same images grown
    (edge-padded) to the first of ``PROBE_SIZES`` the network takes: a
    ResNet needs an ImageNet-sized image to reach its last pool.  The
    reference's CLI tries the first layer's size only."""
    last = None
    sizes = [] if axes is None else [
        s for s in PROBE_SIZES if s > max(x.shape[a] for a in axes)]
    for size in [None] + sizes:
        xs = x
        if size is not None:
            pad = [(0, 0)] * x.ndim
            for a in axes:
                pad[a] = (0, size - x.shape[a])
            xs = np.pad(x, pad, mode="edge")
        xt = torch.from_numpy(xs).to(device)
        try:
            with torch.no_grad():
                y0 = source.eval()(xt).float().cpu().numpy()
        except RuntimeError as e:  # the input is too small for the net
            last = e
            continue
        with torch.no_grad():
            y1 = quantized.eval()(xt).float().cpu().numpy()
        return y0, y1
    raise SystemExit(f"quantize parity: no probe size runs the model "
                     f"({last})")


def _validate_quantized(source, quantized, tol, device):
    """The ``--quantize`` gate: the int8 model must agree with the float
    source on a probe batch within ``tol`` of max|y| (relative), or the
    conversion stops before anything is saved."""
    x, axes = _probe_input(source)
    if x is None:
        print("quantize parity: no Linear/SpatialConvolution in the "
              "model tree; forward check skipped")
        return None
    y0, y1 = _probe_outputs(source, quantized, x, axes, device)
    err = float(np.max(np.abs(y1 - y0))) / max(float(np.max(np.abs(y0))),
                                               1e-6)
    if err > tol:
        raise SystemExit(
            f"--quantize parity check FAILED: max relative error "
            f"{err:.4f} > tolerance {tol} — refusing to save the "
            f"quantized model (raise --quantize-tolerance to override)")
    print(f"quantize parity: max relative error {err:.4f} "
          f"(tolerance {tol}, probe {tuple(x.shape)} grown as needed)")
    return err


def _save(model, args):
    model = model.cpu()
    if args.dst_fmt == "bigdl":
        from bigdl_tpu_torch.interop.bigdl_format import save_bigdl_module
        save_bigdl_module(model, args.output)
    elif args.dst_fmt == "caffe":
        from bigdl_tpu_torch.interop.caffe_export import save_caffe
        save_caffe(model, args.output_def or args.output + ".prototxt",
                   args.output)
    elif args.dst_fmt == "torch":
        from bigdl_tpu_torch.interop.torch_export import save_torch_module
        save_torch_module(model, args.output)
    else:
        raise SystemExit(f"unknown target format {args.dst_fmt}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Convert models between formats")
    p.add_argument("--from", dest="src_fmt", required=True,
                   choices=["bigdl", "caffe", "torch", "tf", "tensorflow",
                            "keras"])
    p.add_argument("--to", dest="dst_fmt", required=True,
                   choices=["bigdl", "caffe", "torch"])
    p.add_argument("--input", required=True, help="source model file")
    p.add_argument("--output", required=True, help="destination file")
    p.add_argument("--prototxt", help="Caffe source net definition")
    p.add_argument("--output-def", dest="output_def",
                   help="Caffe target prototxt path "
                        "(default: <output>.prototxt)")
    p.add_argument("--tf_inputs", help="comma-separated TF input nodes")
    p.add_argument("--tf_outputs", help="comma-separated TF output nodes")
    p.add_argument("--weights", help="Keras HDF5 weight file")
    p.add_argument("--quantize", action="store_true",
                   help="int8-quantize before saving (bigdl target only)")
    p.add_argument("--quantize-mode", dest="quantize_mode",
                   choices=["weight_only", "dynamic"],
                   help="int8 activation mode (default: "
                        "Config.int8_activation_mode)")
    p.add_argument("--quantize-tolerance", dest="quantize_tolerance",
                   type=float, default=0.05,
                   help="max relative forward error accepted by the "
                        "--quantize parity check (default 0.05)")
    p.add_argument("--device", default="cuda",
                   help="device the model runs on (default cuda, which "
                        "must exist; cpu when asked)")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.engine import resolve_device
    device = resolve_device(args.device)
    model = _load(args).to(device)
    if args.quantize:
        if args.dst_fmt != "bigdl":
            raise SystemExit("--quantize is only supported with --to bigdl")
        from bigdl_tpu_torch.nn.quantized import quantize
        source = model
        model = quantize(model, mode=args.quantize_mode)
        _validate_quantized(source, model, args.quantize_tolerance, device)
    _save(model, args)
    print(f"converted {args.input} ({args.src_fmt}) -> "
          f"{args.output} ({args.dst_fmt})")


if __name__ == "__main__":
    main()

"""TF op implementations on torch tensors, keyed by TF op name (port of
``bigdl_tpu/ops/registry.py``).

Each op is ``fn(attrs, *inputs) -> out``; ``attrs`` is the decoded NodeDef
attr dict.  Inputs are torch tensors or numpy arrays (the importer keeps
constant-folded values as numpy, so shape, axis and size arguments stay
on the host); an op computes on the device of its tensor inputs and
returns torch tensors (tuples for multi-output ops; numpy object arrays
for strings).  Integer and float results take the reference's dtypes
with 64-bit types off: int32 and float32.

Convolutions and pools take TF's ``data_format`` (NHWC by default) and
padding strings.  ``SAME`` pads more at the end when the total is odd,
so the pads are applied with ``F.pad`` (``-inf`` for max pooling; average
pooling divides by the number of real elements) before an unpadded
``F.conv2d``/``F.max_pool2d``.

Random ops seed a ``torch.Generator`` from the node's ``seed``/``seed2``
attributes and its name, as the reference seeds its keys: deterministic
per node, but not the reference's numbers (torch's generator is not
JAX's).  They draw on the CPU, so the card and the CPU get the same
values.

TensorArrays: the flow value IS the (size, *element) storage; writes are
out-of-place index updates, so an array can be a loop variable and
autograd runs through it.  The element shape is unknown until the first
write (:class:`TAPending`); the importer's loop executor probes the body
once to allocate it.

Nothing here builds a kernel: the imported graph runs as PyTorch ops.
"""

from __future__ import annotations

import io
import math
import zlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import same_pads

OPS: Dict[str, Callable] = {}


def register_op(name: str):
    def deco(fn):
        OPS[name] = fn
        return fn
    return deco


def get_op(name: str) -> Callable:
    if name not in OPS:
        raise NotImplementedError(
            f"TF op {name!r} not implemented (bigdl_tpu_torch.ops registry "
            f"has {len(OPS)} ops)")
    return OPS[name]


# ------------------------------------------------------------- conversion
_CANON = {torch.float64: torch.float32, torch.int64: torch.int32}


def _t(x, device=None) -> torch.Tensor:
    """``x`` as a tensor (numpy and Python values converted, 64-bit types
    narrowed as the reference's arrays are) on ``device`` if given."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype in (np.int64, np.uint64):
            arr = arr.astype(np.int32)
        if not arr.flags.writeable:  # e.g. a GraphDef's tensor_content
            arr = arr.copy()
        x = torch.from_numpy(np.ascontiguousarray(arr))
    elif x.dtype in _CANON:
        x = x.to(_CANON[x.dtype])
    return x if device is None or x.device == device else x.to(device)


def _tt(*xs):
    """Every argument as a tensor on one device: the first non-CPU device
    among the tensor arguments, else the CPU."""
    dev = None
    for x in xs:
        if isinstance(x, torch.Tensor) and (dev is None
                                            or x.device.type != "cpu"):
            dev = x.device
    out = tuple(_t(x, dev) for x in xs)
    return out if len(out) != 1 else out[0]


def _np(x) -> np.ndarray:
    """A static argument (shape, axis, size) on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _axes(axis_input) -> tuple:
    return tuple(int(v) for v in _np(axis_input).reshape(-1))


def _s(v) -> str:
    return v.decode() if isinstance(v, bytes) else v


# TF DataType enum -> torch dtype (64-bit narrowed, as the reference's)
_TF_DT = {1: torch.float32, 2: torch.float32, 3: torch.int32,
          4: torch.uint8, 5: torch.int16, 6: torch.int8, 9: torch.int32,
          10: torch.bool, 14: torch.bfloat16, 19: torch.float16}


def _float_like(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


# ------------------------------------------------------------- passthrough
@register_op("Identity")
@register_op("StopGradient")
@register_op("PreventGradient")
def _identity(attrs, x):
    return x


@register_op("Cast")
def _cast(attrs, x):
    dt = int(attrs.get("DstT", attrs.get("dstT", 1)))
    mapping = {1: torch.float32, 2: torch.float32, 3: torch.int32,
               9: torch.int32, 10: torch.bool, 14: torch.bfloat16}
    return _tt(x).to(mapping.get(dt, torch.float32))


# ------------------------------------------------------------------- math
def _promote(a, b):
    """Both operands in one dtype, by the reference's rule for a
    numpy/Python scalar meeting an array: the array's dtype wins, and two
    arrays promote as JAX's array types do for the types used here."""
    a_np, b_np = not isinstance(a, torch.Tensor), not isinstance(b, torch.Tensor)
    a, b = _tt(a, b)
    if a.dtype == b.dtype:
        return a, b
    if a_np and a.dim() == 0 and not b_np:
        return a.to(b.dtype), b
    if b_np and b.dim() == 0 and not a_np:
        return a, b.to(a.dtype)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _div(a, b):
    if not a.is_floating_point():
        a, b = a.float(), b.float()
    return a / b


def _floor_div(a, b):
    if a.is_floating_point():
        return torch.floor(a / b)
    return torch.div(a, b, rounding_mode="floor")


_BINOPS = {
    "Add": torch.add, "AddV2": torch.add, "Sub": torch.sub,
    "Mul": torch.mul, "RealDiv": _div, "Div": _div,
    "Maximum": torch.maximum, "Minimum": torch.minimum, "Pow": torch.pow,
    "FloorDiv": _floor_div, "Mod": torch.remainder,
    "SquaredDifference": lambda a, b: (a - b) ** 2,
    "Equal": torch.eq, "NotEqual": torch.ne,
    "Greater": torch.gt, "GreaterEqual": torch.ge,
    "Less": torch.lt, "LessEqual": torch.le,
    "LogicalAnd": torch.logical_and, "LogicalOr": torch.logical_or,
}
for _name, _fn in _BINOPS.items():
    OPS[_name] = (lambda f: lambda attrs, a, b: f(*_promote(a, b)))(_fn)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_UNOPS = {
    "Neg": torch.neg, "Abs": torch.abs, "Exp": torch.exp, "Log": torch.log,
    "Sqrt": torch.sqrt, "Rsqrt": lambda x: 1.0 / torch.sqrt(x),
    "Square": lambda x: torch.square(
        x.to(torch.int32) if x.dtype == torch.bool else x),
    "Floor": torch.floor, "Ceil": torch.ceil,
    "Round": torch.round, "Sign": torch.sign,
    "Reciprocal": torch.reciprocal, "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid, "Relu": torch.relu,
    "Relu6": lambda x: torch.clamp(x, 0.0, 6.0), "Elu": F.elu,
    "Softplus": _softplus, "Softsign": lambda x: x / (1 + torch.abs(x)),
    "LogicalNot": torch.logical_not, "Erf": torch.erf, "Selu": F.selu,
}
# ops the reference computes in floating point whatever the input
_FLOAT_UNOPS = {"Exp", "Log", "Sqrt", "Rsqrt", "Tanh", "Sigmoid", "Elu",
                "Softplus", "Softsign", "Erf", "Selu", "Reciprocal"}
for _name, _fn in _UNOPS.items():
    OPS[_name] = (lambda f, fl: lambda attrs, x: f(
        _float_like(_tt(x)) if fl else _tt(x)))(_fn, _name in _FLOAT_UNOPS)


@register_op("AddN")
def _addn(attrs, *xs):
    xs = _tt(*xs) if len(xs) > 1 else (_tt(xs[0]),)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("MatMul")
def _matmul(attrs, a, b):
    a, b = _tt(a, b)
    if attrs.get("transpose_a", False):
        a = a.T
    if attrs.get("transpose_b", False):
        b = b.T
    return a @ b


@register_op("BatchMatMul")
@register_op("BatchMatMulV2")
def _batch_matmul(attrs, a, b):
    a, b = _tt(a, b)
    if attrs.get("adj_x", False):
        a = a.transpose(-1, -2)
    if attrs.get("adj_y", False):
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register_op("Softmax")
def _softmax(attrs, x):
    return torch.softmax(_tt(x), dim=-1)


@register_op("LogSoftmax")
def _log_softmax(attrs, x):
    return torch.log_softmax(_tt(x), dim=-1)


@register_op("L2Loss")
def _l2loss(attrs, x):
    x = _tt(x)
    return torch.sum(x * x) / 2.0


@register_op("Select")
@register_op("SelectV2")
def _select(attrs, c, a, b):
    c, a, b = _tt(c, a, b)
    a, b = _promote(a, b)
    return torch.where(c.bool(), a, b)


# ------------------------------------------------------------- reductions
def _reduce_all(x, ax, keep):
    return torch.all(x.bool(), dim=ax, keepdim=keep) if ax else \
        torch.all(x.bool())


def _sum_dtype(x):
    """The dtype of a sum or product of ``x`` in the reference (JAX at
    32 bits): int32 for bool and signed integers, uint32 for unsigned
    ones, the input's own for floats.  torch would widen to int64."""
    if x.is_floating_point() or x.is_complex():
        return x.dtype
    if x.dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return torch.uint32
    return torch.int32


def _make_reduce(kind):
    def op(attrs, x, axis):
        x = _tt(x)
        keep = bool(attrs.get("keep_dims", attrs.get("keepdims", False)))
        ax = _axes(axis)
        if not ax and _np(axis).size == 0:
            ax = tuple(range(x.dim()))
        ax = tuple(a % x.dim() for a in ax) if x.dim() else ()
        if kind == "Sum":
            out = torch.sum(x, dim=ax, keepdim=keep) if ax else x.clone()
            return out.to(_sum_dtype(x))
        if kind == "Mean":
            return torch.mean(_float_like(x), dim=ax, keepdim=keep) \
                if ax else _float_like(x).clone()
        if kind in ("Max", "Min"):
            f = torch.amax if kind == "Max" else torch.amin
            return f(x, dim=ax, keepdim=keep) if ax else x.clone()
        if kind == "Prod":
            out = x
            for a in sorted(ax, reverse=True):
                out = torch.prod(out, dim=a, keepdim=keep)
            return out.to(_sum_dtype(x))
        b = x.bool()
        f = torch.all if kind == "All" else torch.any
        out = b
        for a in sorted(ax, reverse=True):
            out = f(out, dim=a, keepdim=keep)
        return out
    return op


for _kind in ("Sum", "Mean", "Max", "Min", "Prod", "All", "Any"):
    OPS[_kind] = _make_reduce(_kind)


@register_op("ArgMax")
def _argmax(attrs, x, axis):
    return torch.argmax(_tt(x), dim=int(_np(axis))).int()


@register_op("ArgMin")
def _argmin(attrs, x, axis):
    return torch.argmin(_tt(x), dim=int(_np(axis))).int()


# ------------------------------------------------------------ shape ops
@register_op("Reshape")
def _reshape(attrs, x, shape):
    return _tt(x).reshape(tuple(int(v) for v in _np(shape).reshape(-1)))


@register_op("Squeeze")
def _squeeze(attrs, x):
    x = _tt(x)
    dims = attrs.get("squeeze_dims", attrs.get("axis", []))
    if dims:
        return x.squeeze(tuple(int(d) % x.dim() for d in dims))
    return x.squeeze()


@register_op("ExpandDims")
def _expand_dims(attrs, x, axis):
    x = _tt(x)
    a = int(_np(axis))
    return x.unsqueeze(a if a >= 0 else x.dim() + 1 + a)


@register_op("Shape")
def _shape(attrs, x):
    return torch.tensor(tuple(_tt(x).shape), dtype=torch.int32)


@register_op("Rank")
def _rank(attrs, x):
    return torch.tensor(_tt(x).dim(), dtype=torch.int32)


@register_op("Size")
def _size(attrs, x):
    return torch.tensor(_tt(x).numel(), dtype=torch.int32)


@register_op("Fill")
def _fill(attrs, shape, value):
    return _tt(value).expand(_shape_of(shape)).clone()


@register_op("Pack")
def _pack(attrs, *xs):
    xs = _tt(*xs) if len(xs) > 1 else (_tt(xs[0]),)
    return torch.stack(xs, dim=int(attrs.get("axis", 0)))


@register_op("Unpack")
def _unpack(attrs, x):
    return tuple(torch.unbind(_tt(x), dim=int(attrs.get("axis", 0))))


@register_op("ConcatV2")
def _concat_v2(attrs, *args):
    *xs, axis = args
    xs = _tt(*xs) if len(xs) > 1 else (_tt(xs[0]),)
    return torch.cat(xs, dim=int(_np(axis)))


@register_op("Concat")
def _concat(attrs, axis, *xs):
    xs = _tt(*xs) if len(xs) > 1 else (_tt(xs[0]),)
    return torch.cat(xs, dim=int(_np(axis)))


@register_op("Slice")
def _slice(attrs, x, begin, size):
    x = _tt(x)
    begin = [int(v) for v in _np(begin).reshape(-1)]
    size = [int(v) for v in _np(size).reshape(-1)]
    idx = tuple(slice(b, x.shape[i] if s == -1 else b + s)
                for i, (b, s) in enumerate(zip(begin, size)))
    return x[idx]


def _index_dim(x, dim, sl):
    """``x`` sliced along ``dim`` by a Python slice, negative steps
    included (torch slicing takes positive steps only)."""
    start, stop, step = sl.indices(x.shape[dim])
    if step > 0:
        return x[(slice(None),) * dim + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=x.device)
    return x.index_select(dim, idx)


@register_op("StridedSlice")
def _strided_slice(attrs, x, begin, end, strides):
    # basic masks only (begin/end/shrink masks as bit fields)
    if int(attrs.get("ellipsis_mask", 0)) or \
            int(attrs.get("new_axis_mask", 0)):
        raise NotImplementedError(
            "StridedSlice ellipsis_mask/new_axis_mask not supported")
    x = _tt(x)
    begin = [int(v) for v in _np(begin).reshape(-1)]
    end = [int(v) for v in _np(end).reshape(-1)]
    strides = [int(v) for v in _np(strides).reshape(-1)]
    bm = int(attrs.get("begin_mask", 0))
    em = int(attrs.get("end_mask", 0))
    sa = int(attrs.get("shrink_axis_mask", 0))
    out = x
    dim = 0
    for i in range(len(begin)):
        if (sa >> i) & 1:
            out = out.select(dim, begin[i])
            continue
        b = None if (bm >> i) & 1 else begin[i]
        e = None if (em >> i) & 1 else end[i]
        out = _index_dim(out, dim, slice(b, e, strides[i]))
        dim += 1
    return out


@register_op("Transpose")
def _transpose(attrs, x, perm):
    return _tt(x).permute(tuple(int(v) for v in _np(perm).reshape(-1)))


@register_op("Pad")
@register_op("PadV2")
def _pad(attrs, x, paddings, *rest):
    x = _tt(x)
    pads = [(int(a), int(b)) for a, b in _np(paddings).reshape(-1, 2)]
    cv = float(_np(rest[0])) if rest else 0.0
    flat = [p for a, b in reversed(pads) for p in (a, b)]
    return F.pad(x, flat, value=cv)


@register_op("Tile")
def _tile(attrs, x, multiples):
    return torch.tile(_tt(x), tuple(int(v) for v in
                                    _np(multiples).reshape(-1)))


def _take(params, indices, ax):
    params, indices = _tt(params, indices)
    ax = ax % params.dim()
    idx = indices.long() % params.shape[ax]
    out = params.index_select(ax, idx.reshape(-1))
    return out.reshape(params.shape[:ax] + idx.shape
                       + params.shape[ax + 1:])


@register_op("GatherV2")
@register_op("Gather")
def _gather(attrs, params, indices, *axis):
    return _take(params, indices, int(_np(axis[0])) if axis else 0)


@register_op("OneHot")
def _one_hot(attrs, indices, depth, on_value, off_value):
    indices, on, off = _tt(indices, on_value, off_value)
    d = int(_np(depth))
    oh = (indices.long()[..., None]
          == torch.arange(d, device=indices.device)).float()
    return oh * on + (1.0 - oh) * off


# --------------------------------------------------------- nn/image ops
def _data_format(attrs) -> str:
    return _s(attrs.get("data_format", b"NHWC")) or "NHWC"


def _padding(attrs, default=b"SAME") -> str:
    return _s(attrs.get("padding", default))


@register_op("BiasAdd")
def _bias_add(attrs, x, b):
    x, b = _tt(x, b)
    if _data_format(attrs) == "NCHW" and x.dim() == 4:
        return x + b[None, :, None, None]
    return x + b


# the TF-0.x name: no data_format attr, always channel-last broadcast
OPS["BiasAddV1"] = lambda attrs, x, b: _bias_add({}, x, b)


def _conv_nd(x, w_oi, strides, dilations, padding, groups=1):
    """Convolution of a channels-second ``x`` by an O, I, *k weight with
    TF padding (``SAME``/``VALID``) applied by ``F.pad``."""
    nd = x.dim() - 2
    pads = []
    for i in range(nd):
        if padding == "SAME":
            pads.append(same_pads(x.shape[2 + i], w_oi.shape[2 + i],
                                  strides[i], dilations[i]))
        else:
            pads.append((0, 0))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat)
    conv = F.conv2d if nd == 2 else F.conv3d
    return conv(x, w_oi, stride=tuple(strides), dilation=tuple(dilations),
                groups=groups)


def _conv_geometry(attrs, df, n=4):
    strides = [int(s) for s in attrs.get("strides", [1] * n)]
    dil = [int(d) for d in attrs.get("dilations", [1] * n)]
    if df.startswith("NC"):
        return strides[2:], dil[2:]
    return strides[1:-1], dil[1:-1]


@register_op("Conv2D")
def _conv2d(attrs, x, w):
    # w: HWIO (TF's kernel layout)
    x, w = _tt(x, w)
    df = _data_format(attrs)
    st, dil = _conv_geometry(attrs, df)
    w_oi = w.permute(3, 2, 0, 1)
    if df == "NHWC":
        y = _conv_nd(x.permute(0, 3, 1, 2), w_oi, st, dil, _padding(attrs))
        return y.permute(0, 2, 3, 1)
    return _conv_nd(x, w_oi, st, dil, _padding(attrs))


@register_op("DepthwiseConv2dNative")
def _depthwise_conv(attrs, x, w):
    x, w = _tt(x, w)
    df = _data_format(attrs)
    st, dil = _conv_geometry(attrs, df)
    H, W, C, M = w.shape
    # the reference's layout: (H, W, M, C) flattened to C*M out features
    w2 = w.permute(0, 1, 3, 2).reshape(H, W, 1, C * M).permute(3, 2, 0, 1)
    if df == "NHWC":
        y = _conv_nd(x.permute(0, 3, 1, 2), w2, st, dil, _padding(attrs),
                     groups=C)
        return y.permute(0, 2, 3, 1)
    return _conv_nd(x, w2, st, dil, _padding(attrs), groups=C)


def _pool(attrs, x, avg=False):
    # ksize/strides come in the graph's data-format order: the windowed
    # axes are the ones whose window or stride is not 1
    x = _tt(x)
    ks = [int(v) for v in attrs.get("ksize", [1, 2, 2, 1])]
    st = [int(v) for v in attrs.get("strides", [1, 2, 2, 1])]
    pad = _padding(attrs, b"VALID")
    dims = [i for i in range(x.dim()) if ks[i] != 1 or st[i] != 1]
    if len(dims) > 2:
        raise NotImplementedError(f"pooling over {len(dims)} axes")
    default = [2, 3] if _data_format(attrs) == "NCHW" else [1, 2]
    dims = sorted(dims + [d for d in default if d not in dims][:2 - len(dims)])
    rest = [d for d in range(x.dim()) if d not in dims]
    perm = rest + dims
    xp = x.permute(perm)
    k = [ks[d] for d in dims]
    s = [st[d] for d in dims]
    lead = xp.shape[:-2]
    xp = xp.reshape((-1, 1) + tuple(xp.shape[-2:]))
    pads = [same_pads(xp.shape[2 + i], k[i], s[i], 1) if pad == "SAME"
            else (0, 0) for i in range(2)]
    flat = [pads[1][0], pads[1][1], pads[0][0], pads[0][1]]
    if avg:
        ones = torch.ones_like(xp[:1, :1])
        summed = F.avg_pool2d(F.pad(xp, flat), k, s, divisor_override=1)
        cnt = F.avg_pool2d(F.pad(ones, flat), k, s, divisor_override=1)
        y = summed / cnt
    else:
        y = F.max_pool2d(F.pad(xp, flat, value=-math.inf), k, s)
    y = y.reshape(tuple(lead) + tuple(y.shape[-2:]))
    inv = [perm.index(i) for i in range(x.dim())]
    return y.permute(inv)


@register_op("MaxPool")
def _max_pool(attrs, x):
    return _pool(attrs, x)


@register_op("AvgPool")
def _avg_pool(attrs, x):
    return _pool(attrs, x, avg=True)


@register_op("FusedBatchNorm")
@register_op("FusedBatchNormV2")
@register_op("FusedBatchNormV3")
def _fused_bn(attrs, x, scale, offset, mean, var):
    x, scale, offset, mean, var = _tt(x, scale, offset, mean, var)
    eps = float(attrs.get("epsilon", 1e-3))
    shape = (1, -1, 1, 1) if _data_format(attrs) == "NCHW" else (1, 1, 1, -1)
    inv = 1.0 / torch.sqrt(var + eps)
    return ((x - mean.reshape(shape)) * inv.reshape(shape)
            * scale.reshape(shape) + offset.reshape(shape))


@register_op("SoftmaxCrossEntropyWithLogits")
def _softmax_ce(attrs, logits, labels):
    logits, labels = _tt(logits, labels)
    return -torch.sum(labels * torch.log_softmax(logits, dim=-1), dim=-1)


# -------------------------------------------------------------- random ops
def _op_generator(attrs) -> torch.Generator:
    """A CPU generator seeded from the node's seed attrs AND its graph
    name (the executor passes ``_node_name``), as the reference derives
    its key: TF graphs usually leave seed/seed2 at 0, and one seed for
    every same-shape variable would make their weights identical."""
    s = int(attrs.get("seed", 0)) * 2654435761 + int(attrs.get("seed2", 0))
    s ^= zlib.crc32(str(attrs.get("_node_name", "")).encode())
    return torch.Generator().manual_seed(s & 0x7FFFFFFF)


def _shape_of(shape):
    return tuple(int(v) for v in _np(shape).reshape(-1))


@register_op("RandomUniform")
def _random_uniform(attrs, shape):
    return torch.rand(_shape_of(shape), generator=_op_generator(attrs))


@register_op("RandomStandardNormal")
def _random_normal(attrs, shape):
    return torch.randn(_shape_of(shape), generator=_op_generator(attrs))


@register_op("TruncatedNormal")
def _truncated_normal(attrs, shape):
    # inverse CDF of the normal restricted to [-2, 2]
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
        (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(_shape_of(shape), generator=_op_generator(attrs),
                   dtype=torch.float64)
    p = lo + u * (hi - lo)
    x = math.sqrt(2) * torch.special.erfinv(2 * p - 1)
    return torch.clamp(x, -2.0, 2.0).float()


@register_op("RandomShuffle")
def _random_shuffle(attrs, value):
    """Shuffle along dim 0 (TF RandomShuffle), seeded like the other
    random ops."""
    value = _tt(value)
    perm = torch.randperm(value.shape[0], generator=_op_generator(attrs))
    return value[perm.to(value.device)]


# ----------------------------------------------------- the wider op surface
def _trunc_div(a, b):
    a, b = _promote(a, b)
    if a.is_floating_point():
        return torch.trunc(a / b)
    return torch.div(a, b, rounding_mode="trunc")


_UNOPS_R3 = {
    "Log1p": torch.log1p, "Expm1": torch.expm1, "Erfc": torch.erfc,
    "Lgamma": torch.lgamma, "Digamma": torch.digamma,
    "IsNan": torch.isnan, "IsInf": torch.isinf, "IsFinite": torch.isfinite,
    "Rint": lambda x: torch.round(_float_like(x)), "Sin": torch.sin,
    "Cos": torch.cos,
    "Tan": torch.tan, "Asin": torch.asin, "Acos": torch.acos,
    "Atan": torch.atan, "Sinh": torch.sinh, "Cosh": torch.cosh,
    "Inv": torch.reciprocal,
}
for _name, _fn in _UNOPS_R3.items():
    OPS[_name] = (lambda f: lambda attrs, x: f(_tt(x)))(_fn)
OPS["TruncateDiv"] = lambda attrs, a, b: _trunc_div(a, b)
OPS["TruncateMod"] = lambda attrs, a, b: torch.fmod(*_promote(a, b))
# floored modulo: the result takes the divisor's sign
OPS["FloorMod"] = lambda attrs, a, b: torch.remainder(*_promote(a, b))


@register_op("Range")
def _range(attrs, start, limit, delta):
    # the shape depends on the values: the inputs are host constants
    vals = [_np(v).item() for v in (start, limit, delta)]
    out = torch.arange(*vals)
    return out.int() if out.dtype == torch.int64 else out.float()


@register_op("LinSpace")
def _linspace(attrs, start, stop, num):
    return torch.linspace(float(_np(start)), float(_np(stop)),
                          int(_np(num)))


@register_op("TopK")
@register_op("TopKV2")
def _top_k(attrs, x, *k):
    x = _tt(x)
    kk = int(_np(k[0])) if k else int(attrs.get("k", 1))
    # sorted, ties by the lower index (a stable descending sort)
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :kk], idx[..., :kk].int()


@register_op("InTopK")
@register_op("InTopKV2")
def _in_top_k(attrs, predictions, targets, *k):
    predictions, targets = _tt(predictions, targets)
    kk = int(_np(k[0])) if k else int(attrs.get("k", 1))
    # the target is in the top k if fewer than k classes score strictly
    # higher; a row with any non-finite prediction says False
    tgt = torch.gather(predictions, 1, targets.long()[:, None])
    higher = torch.sum(predictions > tgt, dim=1)
    return (higher < kk) & torch.all(torch.isfinite(predictions), dim=1)


@register_op("Split")
def _split(attrs, axis, value):
    value = _tt(value)
    n = int(attrs.get("num_split", 1))
    ax = int(_np(axis))
    return tuple(torch.split(value, value.shape[ax] // n, dim=ax))


@register_op("SplitV")
def _split_v(attrs, value, size_splits, axis):
    value = _tt(value)
    sizes = [int(v) for v in _np(size_splits).reshape(-1)]
    ax = int(_np(axis))
    if -1 in sizes:
        rest = value.shape[ax] - sum(s for s in sizes if s >= 0)
        sizes = [rest if s == -1 else s for s in sizes]
    return tuple(torch.split(value, sizes, dim=ax))


def _segment_sum(data, ids, num):
    data, ids = _tt(data, ids)
    flat = data.reshape((-1,) + tuple(data.shape[ids.dim():]))
    ids = ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < num)
    out = torch.zeros((num,) + tuple(flat.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids[keep], flat[keep])


@register_op("SegmentSum")
def _segment_sum_op(attrs, data, segment_ids):
    ids = _np(segment_ids)  # the output's size depends on the values
    num = int(ids.max()) + 1 if ids.size else 0
    return _segment_sum(data, ids, num)


@register_op("UnsortedSegmentSum")
def _unsorted_segment_sum(attrs, data, segment_ids, num_segments):
    data = _tt(data)
    ids = _tt(segment_ids)
    if data.dim() == 1:
        ids = ids.reshape(-1)
    return _segment_sum(data, ids, int(_np(num_segments)))


@register_op("Cumsum")
def _cumsum(attrs, x, axis):
    x = _tt(x)
    if x.dtype == torch.bool:  # the reference sums bools as int32
        x = x.to(torch.int32)
    ax = int(_np(axis))
    rev = bool(attrs.get("reverse", False))
    ex = bool(attrs.get("exclusive", False))
    if rev:
        x = torch.flip(x, (ax,))
    out = torch.cumsum(x, dim=ax).to(x.dtype)
    if ex:
        out = out - x
    if rev:
        out = torch.flip(out, (ax,))
    return out


@register_op("LRN")
def _lrn(attrs, x):
    # NHWC only; denom = (bias + alpha*sqsum)^beta, alpha NOT divided by
    # the window size (unlike torch's LRN)
    x = _tt(x)
    dr = int(attrs.get("depth_radius", 5))
    bias = float(attrs.get("bias", 1.0))
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 0.5))
    acc = F.pad(x * x, (dr, dr)).unfold(-1, 2 * dr + 1, 1).sum(-1)
    return x / torch.pow(bias + alpha * acc, beta)


@register_op("Conv3D")
def _conv3d(attrs, x, w):
    # w: DHWIO; x NDHWC (TF's Conv3D default)
    x, w = _tt(x, w)
    strides = [int(s) for s in attrs.get("strides", [1, 1, 1, 1, 1])]
    y = _conv_nd(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 strides[1:4], [1, 1, 1], _padding(attrs))
    return y.permute(0, 2, 3, 4, 1)


@register_op("ResizeBilinear")
def _resize_bilinear(attrs, x, size):
    """TF1 coordinates: src = dst*scale (align_corners=False, the default)
    or src = dst*(in-1)/(out-1) (align_corners=True), not half-pixel
    centers."""
    out_h, out_w = (int(v) for v in _np(size).reshape(-1))
    x = _tt(x).float()  # TF always returns float32
    in_h, in_w = x.shape[1], x.shape[2]
    align = bool(attrs.get("align_corners", False))

    def coords(out_n, in_n):
        r = torch.arange(out_n, device=x.device, dtype=torch.float32)
        if align and out_n > 1:
            return r * ((in_n - 1) / (out_n - 1))
        return r * (in_n / out_n)

    def interp(v, src, axis, in_n):
        lo = torch.clamp(torch.floor(src).long(), 0, in_n - 1)
        hi = torch.clamp(lo + 1, 0, in_n - 1)
        frac = (src - lo).to(v.dtype)
        shape = [1] * v.dim()
        shape[axis] = -1
        a = v.index_select(axis, lo)
        b = v.index_select(axis, hi)
        return a + (b - a) * frac.reshape(shape)

    y = interp(x, coords(out_h, in_h), 1, in_h)
    return interp(y, coords(out_w, in_w), 2, in_w)


@register_op("ResizeNearestNeighbor")
def _resize_nn(attrs, x, size):
    out_h, out_w = (int(v) for v in _np(size).reshape(-1))
    x = _tt(x)
    in_h, in_w = x.shape[1], x.shape[2]
    align = bool(attrs.get("align_corners", False))

    def idx(out_n, in_n):
        r = torch.arange(out_n, device=x.device, dtype=torch.float32)
        if align and out_n > 1:
            i = torch.round(r * ((in_n - 1) / (out_n - 1)))
        else:
            i = torch.floor(r * (in_n / out_n))
        return torch.clamp(i.long(), 0, in_n - 1)

    y = x.index_select(1, idx(out_h, in_h))
    return y.index_select(2, idx(out_w, in_w))


@register_op("ReverseV2")
def _reverse_v2(attrs, x, axis):
    return torch.flip(_tt(x), _axes(axis))


@register_op("InvertPermutation")
def _invert_permutation(attrs, x):
    return torch.argsort(_tt(x), stable=True).int()


@register_op("Where")
def _where(attrs, c):
    # the output's shape depends on the values: a host constant
    return torch.from_numpy(np.argwhere(_np(c)).astype(np.int32))


# ----------------------------------------------- host-side decode/parsing
# These run on the host over numpy/bytes (input-pipeline ops) and keep the
# host's dtypes, 64-bit ones included, as the reference's do.
def _to_bytes_list(x):
    if isinstance(x, (bytes, bytearray)):
        return [bytes(x)]
    arr = np.asarray(x, dtype=object).reshape(-1)
    return [bytes(v) for v in arr]


# TF DataType enum -> numpy dtype of the raw bytes (bf16 read as uint16)
_RAW_NP = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
           5: np.int16, 6: np.int8, 9: np.int64, 10: np.bool_,
           14: np.uint16, 17: np.uint16, 19: np.float16, 22: np.uint32}


@register_op("DecodeRaw")
def _decode_raw(attrs, data):
    dt = int(attrs.get("out_type", 1))
    if dt not in _RAW_NP:
        raise NotImplementedError(f"DecodeRaw out_type {dt}")
    dtype = np.dtype(_RAW_NP[dt])
    if not bool(attrs.get("little_endian", True)) and dtype.itemsize > 1:
        dtype = dtype.newbyteorder(">")
    out = [np.frombuffer(p, dtype=dtype).astype(dtype.newbyteorder("="))
           for p in _to_bytes_list(data)]
    arr = np.stack(out) if len(out) > 1 else out[0]
    if dt == 14:
        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _decode_image(attrs, contents, channels_default=0):
    from PIL import Image
    channels = int(attrs.get("channels", channels_default))
    img = Image.open(io.BytesIO(_to_bytes_list(contents)[0]))
    if channels == 0:
        # TF's default: the source image's channel count
        channels = {"L": 1, "LA": 2, "RGBA": 4}.get(img.mode, 3)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(channels)
    if mode is None:
        raise NotImplementedError(f"decode with channels={channels}")
    arr = np.array(img.convert(mode), np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


@register_op("DecodeJpeg")
def _decode_jpeg(attrs, contents):
    return torch.from_numpy(_decode_image(attrs, contents).copy())


@register_op("DecodePng")
def _decode_png(attrs, contents):
    return torch.from_numpy(_decode_image(attrs, contents).copy())


def _gif_frames(data):
    from PIL import Image, ImageSequence
    img = Image.open(io.BytesIO(data))
    return np.stack([np.asarray(f.convert("RGB"), np.uint8)
                     for f in ImageSequence.Iterator(img)])


@register_op("DecodeImage")
def _decode_any_image(attrs, contents):
    """Format-sniffing decode (TF DecodeImage).  GIFs come back (frames,
    H, W, C) unless ``expand_animations=False`` (the first frame);
    ``dtype`` converts as TF's convert_image_dtype does (uint8 ints, [0, 1]
    floats)."""
    data = _to_bytes_list(contents)[0]
    if data[:6] in (b"GIF87a", b"GIF89a"):
        out = _gif_frames(data)
        if not bool(attrs.get("expand_animations", True)):
            out = out[0]
    else:
        out = _decode_image(attrs, data)
    dt = int(attrs.get("dtype", 4))  # DT_UINT8=4
    if dt in (1, 2, 19):             # float32/float64/half -> [0, 1]
        out = (out.astype({1: np.float32, 2: np.float64,
                           19: np.float16}[dt]) / 255.0)
        return torch.from_numpy(out)
    if dt != 4:
        raise NotImplementedError(f"DecodeImage dtype {dt}")
    return torch.from_numpy(np.ascontiguousarray(out))


@register_op("DecodeGif")
def _decode_gif(attrs, contents):
    """All frames, (num_frames, H, W, 3) uint8."""
    return torch.from_numpy(_gif_frames(_to_bytes_list(contents)[0]))


@register_op("ApproximateEqual")
def _approximate_equal(attrs, x, y):
    x, y = _promote(x, y)
    return torch.abs(x - y) < float(attrs.get("tolerance", 1e-5))


@register_op("Dilation2D")
def _dilation2d(attrs, input, filter):
    """Grey-scale morphological dilation, NHWC: per channel,
    out[b,y,x,c] = max_{dy,dx} input[b, y*s+dy*r, x*s+dx*r, c]
    + filter[dy,dx,c]."""
    input, filter = _tt(input, filter)
    strides = [int(v) for v in attrs.get("strides", [1, 1, 1, 1])]
    rates = [int(v) for v in attrs.get("rates", [1, 1, 1, 1])]
    N, H, W, C = input.shape
    KH, KW, _ = filter.shape
    sh, sw = strides[1], strides[2]
    rh, rw = rates[1], rates[2]
    eff_kh, eff_kw = (KH - 1) * rh + 1, (KW - 1) * rw + 1
    if _padding(attrs) == "SAME":
        OH, OW = -(-H // sh), -(-W // sw)
        ph = max((OH - 1) * sh + eff_kh - H, 0)
        pw = max((OW - 1) * sw + eff_kw - W, 0)
        pads = (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    else:
        OH = (H - eff_kh) // sh + 1
        OW = (W - eff_kw) // sw + 1
        pads = (0, 0, 0, 0, 0, 0)
    xp = F.pad(input, pads, value=-math.inf)
    out = None
    for dy in range(KH):
        for dx in range(KW):
            win = xp[:, dy * rh:dy * rh + (OH - 1) * sh + 1:sh,
                     dx * rw:dx * rw + (OW - 1) * sw + 1:sw, :]
            cand = win + filter[dy, dx]
            out = cand if out is None else torch.maximum(out, cand)
    return out


@register_op("Substr")
def _substr(attrs, input, pos, length):
    """Substrings of byte strings (host-side; strings never reach the
    device)."""
    shape = np.shape(input)
    flat = np.asarray(input, object).reshape(-1)
    p = np.broadcast_to(_np(pos), shape).reshape(-1)
    n = np.broadcast_to(_np(length), shape).reshape(-1)
    out = []
    for s, pi, ni in zip(flat, p, n):
        b = s if isinstance(s, bytes) else str(s).encode()
        out.append(b[int(pi):int(pi) + int(ni)])
    return np.asarray(out, object).reshape(shape)


@register_op("Assert")
def _assert(attrs, condition, *data):
    """TF Assert: checks the condition (one host read) and passes it on."""
    if not bool(_np(condition).all()):
        raise AssertionError(
            f"imported TF Assert failed: {[_np(d) for d in data]}")
    return condition


@register_op("NoOp")
def _noop(attrs):
    return ()


# --------------------------------------------------------- TensorArray
class TAHandle:
    """Opaque handle value of TensorArrayV3:0 (size/dtype metadata)."""

    __slots__ = ("name", "size", "dtype")

    def __init__(self, name, size, dtype):
        self.name, self.size, self.dtype = name, size, dtype


class TAPending:
    """Flow of a TensorArray whose element shape is not known yet."""

    __slots__ = ("size", "dtype")

    def __init__(self, size, dtype):
        self.size, self.dtype = size, dtype


def _ta_alloc(flow, value, leading_from_value=False):
    if not isinstance(flow, TAPending):
        return flow
    elem = value.shape[1:] if leading_from_value else value.shape
    return torch.zeros((flow.size,) + tuple(elem), dtype=value.dtype,
                       device=value.device)


@register_op("TensorArrayV3")
def _tensor_array(attrs, size):
    size = int(_np(size))
    dt = _TF_DT.get(int(attrs.get("dtype", 1)), torch.float32)
    return (TAHandle(attrs.get("_node_name"), size, dt),
            TAPending(size, dt))


def _index(i, device):
    return _t(i, device).long()


@register_op("TensorArrayWriteV3")
def _ta_write(attrs, handle, index, value, flow):
    value = _tt(value)
    flow = _ta_alloc(flow, value)
    idx = _index(index, flow.device).reshape(1)
    return flow.index_put((idx,), value.to(flow.dtype)[None])


@register_op("TensorArrayReadV3")
def _ta_read(attrs, handle, index, flow):
    if isinstance(flow, TAPending):
        raise NotImplementedError(
            "TensorArrayReadV3 before any write: element shape unknown")
    return flow.index_select(0, _index(index, flow.device).reshape(1))[0]


@register_op("TensorArrayGatherV3")
def _ta_gather(attrs, handle, indices, flow):
    if isinstance(flow, TAPending):
        raise NotImplementedError(
            "TensorArrayGatherV3 before any write: element shape unknown")
    idx = _index(indices, flow.device)
    return flow.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(flow.shape[1:]))


@register_op("TensorArrayScatterV3")
def _ta_scatter(attrs, handle, indices, value, flow):
    value = _tt(value)
    flow = _ta_alloc(flow, value, leading_from_value=True)
    return flow.index_put((_index(indices, flow.device),),
                          value.to(flow.dtype))


@register_op("TensorArraySizeV3")
def _ta_size(attrs, handle, flow):
    return torch.tensor(handle.size, dtype=torch.int32)


@register_op("TensorArrayCloseV3")
def _ta_close(attrs, handle):
    return torch.zeros((), dtype=torch.float32)


def decode_example(data: bytes) -> dict:
    """A serialized tf.train.Example as {name: values}: BytesList →
    list[bytes]; FloatList → float32 ndarray; Int64List → int64 ndarray."""
    from bigdl_tpu_torch.utils import protowire as pw
    out: dict = {}
    for features_bytes in pw.decode_message(data).get(1, []):
        for entry_bytes in pw.decode_message(features_bytes).get(1, []):
            entry = pw.decode_message(entry_bytes)
            key = pw.as_str(entry[1][0])
            feature = pw.decode_message(entry[2][0])
            if 1 in feature:     # BytesList
                out[key] = list(pw.decode_message(feature[1][0]).get(1, []))
            elif 2 in feature:   # FloatList (packed or not)
                vals: list = []
                for v in pw.decode_message(feature[2][0]).get(1, []):
                    vals.extend(pw.unpack_packed(v, "float")
                                if isinstance(v, bytes)
                                else [pw.as_float(v)])
                out[key] = np.asarray(vals, np.float32)
            elif 3 in feature:   # Int64List
                vals = []
                for v in pw.decode_message(feature[3][0]).get(1, []):
                    vals.extend(pw.as_sint(x) for x in (
                        pw.unpack_packed(v, "varint")
                        if isinstance(v, bytes) else [v]))
                out[key] = np.asarray(vals, np.int64)
            else:
                out[key] = []
    return out


@register_op("ParseExample")
def _parse_example(attrs, serialized, names, *keys_and_defaults):
    """The dense features of TF's ParseExample: inputs (serialized, names,
    sparse_keys..., dense_keys..., dense_defaults...) with the counts in
    attrs Nsparse/Ndense; one batched array per dense key (byte features
    as object arrays)."""
    n_sparse = int(attrs.get("Nsparse", 0))
    n_dense = int(attrs.get("Ndense", 0))
    if n_sparse:
        raise NotImplementedError("ParseExample sparse features")
    dense_keys = [_s(np.asarray(keys_and_defaults[i]).item())
                  for i in range(n_dense)]
    dense_shapes = attrs.get("dense_shapes", [()] * n_dense)
    records = _to_bytes_list(serialized)
    outs = []
    for ki, key in enumerate(dense_keys):
        rows = []
        for rec in records:
            feats = decode_example(rec)
            if key not in feats:
                raise KeyError(f"feature {key!r} missing from Example")
            v = feats[key]
            if isinstance(v, list):  # bytes feature
                v = np.asarray(v, dtype=object)
            shape = dense_shapes[ki] if ki < len(dense_shapes) else ()
            if shape:
                v = np.asarray(v).reshape(
                    [int(d) for d in np.asarray(shape).reshape(-1)])
            rows.append(v)
        arr = np.stack(rows)
        outs.append(arr if arr.dtype == object else torch.from_numpy(arr))
    return tuple(outs) if len(outs) > 1 else outs[0]

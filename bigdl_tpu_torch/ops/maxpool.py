"""Max-pool backward, first-match (port of ``bigdl_tpu/ops/pallas_pool.py``).

:func:`maxpool2d` is the differentiable 2-D max pool of the port's
``SpatialMaxPooling``: its forward is ``F.max_pool2d`` over the input
padded with ``-inf`` (exact), and its backward routes each output window's
gradient to the FIRST position, in row-major ``(dh, dw)`` order over the
window's real positions, whose value equals the window's maximum (compared
in f32); overlapping windows add up in the input's dtype, one ``(dh, dw)``
offset after another.  That is the reference's first-match rule and order,
and the rule of its default ``select-and-scatter`` backward too.

The device of the tensor picks the version.  A CUDA tensor launches the
hand-written Hopper kernel (``csrc/maxpool_bwd.cu``, :func:`launch`) or
raises; a CPU tensor runs the plain version :func:`maxpool_bwd_reference`.
There is no ``impl`` knob, no ``supported()`` gate and no fallback: the
kernel takes any N, C, H, W, stride, padding and ceil-mode geometry, in
NCHW or NHWC (four strides per tensor), in f32, bf16 or f16.

Tensors here are indexed ``(N, C, H, W)``; an NHWC layer passes its
``x.permute(0, 3, 1, 2)`` view, which is ``channels_last`` in memory, and
gets its gradient back in the same layout.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its path went through the kernel.  The C entry point picks
one of two variants by layout, alignment and window size alone and says
which: ``tiled_nhwc`` (one launch, no scratch, whole 16-byte channel
vectors a thread: channels-innermost tensors whose channel rows split into
16-byte vectors, 16-byte-aligned bases, 32-bit offsets, windows of fewer
than 255 positions, as at ResNet's NHWC stem) and ``two_pass`` (everything
else: NCHW, ragged C, unaligned views, 64-bit offsets).
``variant_launches`` counts each beside ``launches``, and ``last_variant``
holds the last launch's ``(variant, gi positions a tile, channel vectors a
block, blocks)``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build

#: kernel launches since the last reset (a plain int; reset by assigning 0)
launches = 0
VARIANTS = ("two_pass", "tiled_nhwc")
#: launches of each variant since the last reset (reset with
#: :func:`reset_counts`)
variant_launches = dict.fromkeys(VARIANTS, 0)
#: (variant, gi positions a tile, channel vectors a block, blocks) of the
#: last launch
last_variant = None

Pads = Tuple[Tuple[int, int], Tuple[int, int]]  # ((h_lo, h_hi), (w_lo, w_hi))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns = None  # the C entry points, see _kernel_fns


def maxpool_bwd_reference(x, y, g, kernel, stride, pads: Pads):
    """Plain version of the kernel: the input gradient of a first-match
    max pool, in ``x``'s dtype and layout.  The reference's own loop:
    for each window offset ``(dh, dw)`` in row-major order, the windows
    whose position at that offset is real compare it with their maximum in
    f32; a window not yet taken sends its gradient there, and the sum is
    taken in ``x``'s dtype."""
    N, C, H, W = x.shape
    OH, OW = y.shape[2:]
    (kh, kw), (sh, sw) = kernel, stride
    (ph, _), (pw, _) = pads
    gi = torch.zeros_like(x)
    taken = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    yf = y.float()
    for dh in range(kh):
        # windows oh whose row oh*sh - ph + dh lies in [0, H)
        i0 = max(0, -((dh - ph) // sh))
        i1 = min(OH, -((dh - ph - H) // sh))
        if i0 >= i1:
            continue
        r0 = i0 * sh - ph + dh
        rows = slice(r0, r0 + (i1 - i0 - 1) * sh + 1, sh)
        for dw in range(kw):
            j0 = max(0, -((dw - pw) // sw))
            j1 = min(OW, -((dw - pw - W) // sw))
            if j0 >= j1:
                continue
            c0 = j0 * sw - pw + dw
            cols = slice(c0, c0 + (j1 - j0 - 1) * sw + 1, sw)
            hit = x[:, :, rows, cols].float() == yf[:, :, i0:i1, j0:j1]
            t = taken[:, :, i0:i1, j0:j1]
            fresh = hit & ~t
            taken[:, :, i0:i1, j0:j1] = t | hit
            contrib = g[:, :, i0:i1, j0:j1] * fresh.to(g.dtype)
            gi[:, :, rows, cols] = gi[:, :, rows, cols] + contrib.to(x.dtype)
    return gi


def reset_counts() -> None:
    """Set ``launches`` and every ``variant_launches`` count to 0."""
    global launches
    launches = 0
    for v in VARIANTS:
        variant_launches[v] = 0


def _kernel_fns():
    """``(variant chooser, kernel)``: the C entry points with their ctypes
    signatures, resolved on first use (that builds the libraries) and
    kept."""
    global _fns
    if _fns is None:
        lib = _build.load("maxpool_bwd")
        pick, fn = lib.bigdl_maxpool_bwd_variant, lib.bigdl_maxpool_bwd
        geometry = [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int]
        pick.restype = fn.restype = ctypes.c_int
        pick.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + geometry
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + geometry
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        _fns = (pick, fn)
    return _fns


def launch(x, y, g, kernel, stride, pads: Pads):
    """Launch the kernel (what :func:`maxpool_bwd_reference` takes and
    returns).  Raises on anything the kernel does not take."""
    global launches, last_variant
    dev = x.device
    if dev.type != "cuda":
        raise RuntimeError(f"the max-pool backward kernel runs on CUDA, not "
                           f"{dev}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the max-pool backward takes f32, bf16 or f16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or y.dim() != 4 or tuple(g.shape) != tuple(y.shape) \
            or y.shape[:2] != x.shape[:2]:
        raise ValueError(f"x (N, C, H, W) and y, g (N, C, OH, OW) expected, "
                         f"got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(g.shape)}")
    for name, t in (("y", y), ("g", g)):
        if t.device != dev or t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} on {t.device}, x is "
                            f"{x.dtype} on {dev}")
    (kh, kw), (sh, sw) = kernel, stride
    (ph, _), (pw, _) = pads
    gi = torch.empty_like(x)  # x's layout when x is dense, else contiguous
    if x.numel() == 0 or y.numel() == 0:
        return gi.zero_()
    channels_last = int(x.stride(1) == 1 and x.shape[1] > 1)
    dims = (ctypes.c_longlong * 12)(*x.shape, *y.shape[2:], kh, kw, sh, sw,
                                    ph, pw)
    strides = (ctypes.c_longlong * 16)(*x.stride(), *y.stride(), *g.stride(),
                                       *gi.stride())
    ptrs = (x.data_ptr(), y.data_ptr(), g.data_ptr(), gi.data_ptr())
    pick, fn = _kernel_fns()
    code = _DTYPE_CODE[x.dtype]
    variant = pick(code, *ptrs, dims, strides, channels_last)
    # two_pass's scratch: the first-match offset of every window
    idx = None if variant == 1 else torch.empty(
        y.numel(), device=dev,
        dtype=torch.uint8 if kh * kw < 255 else torch.int32)
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(code, *ptrs, None if idx is None else idx.data_ptr(), dims,
                 strides, channels_last, stream, info)
    if err != 0:
        raise RuntimeError(f"max-pool backward kernel launch failed: "
                           f"cudaError {err} (x {tuple(x.shape)}, y "
                           f"{tuple(y.shape)}, kernel {kernel}, stride "
                           f"{stride}, pads {pads})")
    launches += 1
    name = VARIANTS[info[0]]
    variant_launches[name] += 1
    last_variant = (name,) + tuple(info[1:])
    return gi


def maxpool_bwd(x, y, g, kernel, stride, pads: Pads):
    """The first-match input gradient: the kernel for a CUDA tensor, the
    plain version for a CPU one."""
    if x.device.type == "cuda":
        return launch(x, y, g, kernel, stride, pads)
    if x.device.type == "cpu":
        return maxpool_bwd_reference(x, y, g, kernel, stride, pads)
    raise RuntimeError(f"the max-pool backward has no version for "
                       f"{x.device}")


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride, pads):
        (h_lo, h_hi), (w_lo, w_hi) = pads
        xp = F.pad(x, (w_lo, w_hi, h_lo, h_hi), value=float("-inf")) \
            if any((h_lo, h_hi, w_lo, w_hi)) else x
        y = F.max_pool2d(xp, kernel, stride)
        ctx.save_for_backward(x, y)
        ctx.geometry = (kernel, stride, pads)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return maxpool_bwd(x, y, g, *ctx.geometry), None, None, None


def maxpool2d(x, kernel, stride, pads: Pads):
    """2-D max pool of an ``(N, C, H, W)``-indexed tensor (any layout)
    with ``-inf`` padding ``pads``; differentiable, with the first-match
    backward above."""
    return _MaxPool2d.apply(x, tuple(kernel), tuple(stride),
                            tuple(tuple(p) for p in pads))

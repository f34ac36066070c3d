"""Fused LSTM cell: forward and elementwise backward.

Port of ``bigdl_tpu/ops/pallas_lstm.py``.  :func:`lstm_cell` computes
``z = zx + h @ w_t`` and the whole gate chain (i|f|g|o, ``forget_bias``
inside the sigmoid of f) in one pass, and is differentiable: its backward
recomputes the gates from the f32 ``z`` the forward kept, emits ``dz`` and
``dc_prev`` in a second pass, and leaves the two products ``dh_prev = dz @
w_t.T`` and ``dw_t = h.T @ dz`` to ``torch.matmul``, as the reference
leaves them to XLA.  Each cotangent is cast to its primal's dtype.

The device of ``zx`` picks the version.  A CUDA tensor launches the
hand-written Hopper kernels (``csrc/lstm_cell.cu``: :func:`launch_fwd`,
:func:`launch_bwd`) or raises; a CPU tensor runs the plain versions
:func:`lstm_cell_fwd_reference` and :func:`lstm_cell_bwd_reference`.
There is no knob, no shape gate and no fallback: the kernels mask ragged
H and N themselves.

``fwd_launches`` and ``bwd_launches`` count kernel launches (never
plain-version calls), so a run can show that its path went through them.
``last_fwd_shape`` holds the last forward launch's ``(CTAs, cluster size,
copy width in bytes, batch rows a cluster)``: the forward spreads the
recurrent product's K=H over a cluster of CTAs.  ``last_bwd_shape`` holds
the last backward launch's ``(blocks, threads a block)``: a 2-D grid of
batch rows by runs of hidden units, one a thread.
:func:`launch_bwd_empty` launches an empty kernel of the backward's grid,
the floor under the backward's time.
"""

from __future__ import annotations

import ctypes

import torch

from bigdl_tpu_torch.ops import _build

#: kernel launches since the last reset (plain ints; reset by assigning 0)
fwd_launches = 0
bwd_launches = 0
#: (CTAs, cluster size, copy width in bytes, batch rows a cluster) of the
#: last forward launch
last_fwd_shape = None
#: (blocks, threads a block) of the last backward launch
last_bwd_shape = None

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_fns = {}  # C entry points, see _kernel_fn


def _gates(z: torch.Tensor, forget_bias: float):
    """(i, f, g, o) activated from the f32 pre-activation ``z``."""
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    return (torch.sigmoid(zi), torch.sigmoid(zf + forget_bias),
            torch.tanh(zg), torch.sigmoid(zo))


def lstm_cell_fwd_reference(zx, h, c, w_t, forget_bias: float = 0.0):
    """Plain version of the forward kernel: ``(h', c', z)``, with h', c'
    in ``zx``'s dtype and ``z`` in f32."""
    z = zx.float() + h.float() @ w_t.float()
    i, f, g, o = _gates(z, forget_bias)
    c_new = f * c.float() + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(zx.dtype), c_new.to(zx.dtype), z


def lstm_cell_bwd_reference(z, c, dh, dc, forget_bias: float = 0.0):
    """Plain version of the backward kernel: ``(dz, dc_prev)``, ``dz`` in
    f32 and ``dc_prev`` in ``c``'s dtype."""
    c32, dh, dc = c.float(), dh.float(), dc.float()
    i, f, g, o = _gates(z, forget_bias)
    tc = torch.tanh(f * c32 + i * g)
    dct = dc + dh * o * (1.0 - tc * tc)
    dz = torch.cat([dct * g * i * (1.0 - i), dct * c32 * f * (1.0 - f),
                    dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
    return dz, (dct * f).to(c.dtype)


def _kernel_fn(name: str):
    """A kernel's C entry point with its ctypes signature, resolved on
    first use (that builds the libraries) and kept."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("lstm_cell"), f"bigdl_lstm_cell_{name}")
        fn.restype = ctypes.c_int
        n_ptr = 7 if name == "fwd" else 6  # tensors, N, H, bias, stream, info
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float] + [ctypes.c_void_p] * 2)
        _fns[name] = fn
    return fn


def _check(tensors, shapes, dtypes, dev):
    for (name, t), shape, dtype in zip(tensors, shapes, dtypes):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the cell on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dtype} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}"
                            + ("" if t.is_contiguous() else " strided"))


def _launch(name, code, args, N, H, forget_bias, dev, *extra):
    fn = _kernel_fn(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(code, *(t.data_ptr() for t in args), N, H,
                 float(forget_bias), stream, *extra)
    if err != 0:
        raise RuntimeError(f"LSTM cell {name} kernel launch failed: cudaError "
                           f"{err} (N={N}, H={H})")


def launch_fwd(zx, h, c, w_t, forget_bias: float = 0.0):
    """Launch the forward kernel (what :func:`lstm_cell_fwd_reference`
    takes and returns).  Raises on anything the kernel does not take."""
    global fwd_launches, last_fwd_shape
    dev = zx.device
    if dev.type != "cuda":
        raise RuntimeError(f"the LSTM cell kernel runs on CUDA, not {dev}")
    if zx.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel B2f (the LSTM cell forward) has no "
                        f"{zx.dtype} form: the LSTM cell takes f32, bf16 "
                        f"or f16")
    N, H = h.shape
    _check((("zx", zx), ("h", h), ("c", c), ("w_t", w_t)),
           ((N, 4 * H), (N, H), (N, H), (H, 4 * H)), (zx.dtype,) * 4, dev)
    h_new = torch.empty_like(h)
    c_new = torch.empty_like(c)
    z = torch.empty((N, 4 * H), dtype=torch.float32, device=dev)
    if N:
        info = (ctypes.c_int * 4)()
        _launch("fwd", _DTYPE_CODE[zx.dtype], (zx, h, c, w_t, h_new, c_new, z),
                N, H, forget_bias, dev, info)
        fwd_launches += 1
        last_fwd_shape = tuple(info)
    return h_new, c_new, z


def _bwd_args(z, c, dh, dc):
    dev = z.device
    if dev.type != "cuda":
        raise RuntimeError(f"the LSTM cell kernel runs on CUDA, not {dev}")
    if c.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel B2b (the LSTM cell backward) has no "
                        f"{c.dtype} form: the LSTM cell takes f32, bf16 "
                        f"or f16")
    N, H = c.shape
    _check((("z", z), ("c", c), ("dh", dh), ("dc", dc)),
           ((N, 4 * H), (N, H), (N, H), (N, H)),
           (torch.float32,) + (c.dtype,) * 3, dev)
    return dev, N, H


def launch_bwd(z, c, dh, dc, forget_bias: float = 0.0):
    """Launch the backward kernel (what :func:`lstm_cell_bwd_reference`
    takes and returns).  Raises on anything the kernel does not take."""
    global bwd_launches, last_bwd_shape
    dev, N, H = _bwd_args(z, c, dh, dc)
    dz = torch.empty_like(z)
    dc_prev = torch.empty_like(c)
    if N:
        info = (ctypes.c_int * 2)()
        _launch("bwd", _DTYPE_CODE[c.dtype], (z, c, dh, dc, dz, dc_prev),
                N, H, forget_bias, dev, info)
        bwd_launches += 1
        last_bwd_shape = tuple(info)
    return dz, dc_prev


def launch_bwd_empty(z, c, dh, dc):
    """An empty kernel launched with the grid and block that
    :func:`launch_bwd` would launch for these tensors (its launch floor);
    returns that ``(blocks, threads a block)``.
    Not counted in ``bwd_launches``."""
    dev, N, H = _bwd_args(z, c, dh, dc)
    info = (ctypes.c_int * 2)()
    if N:  # z and c stand in for the outputs, fresh tensors of their kind
        _launch("bwd_empty", _DTYPE_CODE[c.dtype], (z, c, dh, dc, z, c), N,
                H, 0.0, dev, info)
    return tuple(info)


def _fwd(zx, h, c, w_t, forget_bias):
    if zx.device.type == "cuda":
        return launch_fwd(zx, h, c, w_t, forget_bias)
    if zx.device.type == "cpu":
        return lstm_cell_fwd_reference(zx, h, c, w_t, forget_bias)
    raise RuntimeError(f"the LSTM cell has no version for {zx.device}")


def _bwd(z, c, dh, dc, forget_bias):
    if z.device.type == "cuda":
        return launch_bwd(z, c, dh, dc, forget_bias)
    return lstm_cell_bwd_reference(z, c, dh, dc, forget_bias)


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, zx, h, c, w_t, forget_bias):
        h_new, c_new, z = _fwd(zx, h, c, w_t, forget_bias)
        ctx.save_for_backward(z, c, h, w_t)
        ctx.forget_bias = forget_bias
        ctx.zx_dtype = zx.dtype
        return h_new, c_new

    @staticmethod
    def backward(ctx, dh, dc):
        z, c, h, w_t = ctx.saved_tensors
        dz, dc_prev = _bwd(z, c, dh.to(c.dtype).contiguous(),
                           dc.to(c.dtype).contiguous(), ctx.forget_bias)
        dh_prev = (dz @ w_t.float().T).to(h.dtype)
        dw_t = (h.float().T @ dz).to(w_t.dtype)
        return dz.to(ctx.zx_dtype), dh_prev, dc_prev, dw_t, None


def lstm_cell(zx, h, c, w_t, *, forget_bias: float = 0.0):
    """Fused LSTM cell, the twin of the reference's ``lstm_cell``.

    Args mirror ``nn.recurrent.LSTM.step_hoisted``: ``zx`` (N, 4H) is the
    hoisted input projection plus bias, ``h``/``c`` (N, H) the carried
    state, ``w_t`` (H, 4H) the transposed recurrent weight slice, all f32,
    all bf16 or all f16 and contiguous.  Returns ``(h_new, c_new)`` in ``zx``'s
    dtype; differentiable in all four inputs."""
    return _LSTMCell.apply(zx, h, c, w_t, float(forget_bias))

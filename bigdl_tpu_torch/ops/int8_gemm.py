"""int8 mixed-precision GEMM with the quantized epilogue fused.

Port of ``bigdl_tpu/ops/pallas_int8_gemm.py``: ``y = (x @ wq.T) * scale_o
(+ bias)`` in two modes that share one definition of the math.

- ``weight_only``: f32/bf16/f16 activations against the int8 (O, K)
  panel, f32 accumulate;
- ``dynamic``: activations quantized per tensor by :func:`dyn_quantize`
  (amax * f32(1/127), round half to even, clip +-127), int8 x int8 with
  an exact integer sum, dequantized by ``x_scale * w_scale_o``.

The device of ``x`` picks the version.  A CUDA tensor launches the
hand-written Hopper kernel (``csrc/int8_gemm.cu``) or raises; a CPU tensor
runs :func:`int8_matmul_reference`, the plain version.  There is no knob
and no fallback from one to the other.

The epilogue is one rounding: XLA on the CPU contracts the reference's
``acc * scale + bias`` into an FMA, and the kernel uses ``__fmaf_rn``.
The plain version gets the same single rounding from float64 (exact
int8 product; round-to-odd before the one cast to f32), so in dynamic mode
it equals the JAX reference and the kernel bitwise.  PyTorch has no int32
matmul on the card, which is one more reason the plain product is float64:
for int8 operands it is exact up to K ~ 2**53 / 127**2.

``launches`` counts kernel launches (never plain-version calls), so a run
can show that its main path went through the kernel.  The C entry point
picks one of four variants and says which: ``wgmma_dynamic`` (s8 ``wgmma``
fed by TMA) and ``wgmma_weight_only`` (bf16 ``wgmma`` over the exact
three-way split of f32 activations, :func:`split_bf16x3`; one pass for
bf16 activations, one f16 pass for f16 ones) wherever TMA can describe
the operands, else ``mma_dynamic`` and ``mma_weight_only`` (the same
arithmetic through warp-level ``mma.sync``, K zero-filled to the next k32
or k16: K not a multiple of 16, as at ResNet-50's stem and the quantized
recurrent cells, or an unaligned base).
``variant_launches`` counts each beside ``launches``, and ``last_variant``
holds the last launch's ``(variant, tile rows, tile columns, stages,
blocks)``; an ``mma_*`` variant's stages are the K chunks it takes through
shared memory one after another (1: all of K at once).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bigdl_tpu_torch.ops import _build

MODES = ("weight_only", "dynamic")

#: kernel launches since the last reset (plain int; reset by assigning 0)
launches = 0
VARIANTS = ("mma_weight_only", "mma_dynamic", "wgmma_dynamic",
            "wgmma_weight_only")
#: launches of each variant since the last reset (reset with
#: :func:`reset_counts`)
variant_launches = dict.fromkeys(VARIANTS, 0)
#: (variant, tile rows, tile columns, stages, blocks) of the last launch
last_variant = None

# int32 accumulator: K * 127 * 127 must stay below 2**31
_MAX_K_DYNAMIC = (2 ** 31 - 1) // (127 * 127)
_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                 torch.float16: 3}
_fn = None  # the C entry point, see _kernel_fn


# f32(1/127).  The reference writes ``amax / 127.0``, but XLA rewrites a
# division by a constant into a multiplication by the constant's f32
# reciprocal, so that is what the reference computes under jit (on the
# CPU and in the TPU program alike); for about 5% of f32 amax values the
# two differ by one ulp.  The division of x by the scale stays a true
# division in both.
_INV_127 = float(torch.tensor(1 / 127, dtype=torch.float32))


def dyn_quantize(x: torch.Tensor):
    """Per-tensor dynamic symmetric int8 quantization: ``(int8 values,
    scale)`` with ``scale = max(amax, 1e-8) * f32(1/127)`` in ``x``'s
    dtype, then a true division and rounding half to even (the jitted
    reference's ``dyn_quantize``, bit for bit).  In f16, 1e-8 and the
    scale of an amax below about 2^-18 are 0: ``x / scale`` is then NaN
    where x is 0, which becomes 0 as XLA's float-to-int conversion makes
    it (a C cast of NaN is undefined), and +-inf elsewhere, +-127."""
    amax = torch.clamp(x.abs().max(), min=1e-8)
    scale = amax * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8), scale


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: Optional[torch.Tensor]) -> torch.Tensor:
    """``fmaf(a, b, c)`` for f32 tensors, rounded once: the product of two
    f32 values is exact in float64; the sum is rounded to odd (TwoSum
    error, then a step to the odd neighbour when inexact), and rounding
    to odd at 53 bits followed by rounding to nearest at 24 bits equals
    rounding the exact value to nearest once."""
    p = a.double() * b.double()
    if c is None:
        return p.float()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def split_bf16x3(x: torch.Tensor):
    """``(hi, mid, lo)`` bf16 tensors whose sum is the f32 ``x``: the
    per-element arithmetic of the weight_only kernels, kept here so
    that the CPU can test it (no main path calls it).  ``hi`` is ``x`` with
    the low 16 bits of its pattern cleared (truncation, so ``hi`` never
    overflows near f32's largest value), ``r = x - hi`` (0 where ``x`` is
    its own ``hi``, as an infinity is), ``mid`` is ``r`` truncated the same
    way, and ``lo`` is ``r - mid`` truncated the same way.  Each subtraction
    is exact in f32, and ``lo`` is exact in bf16 for ``|x| >= 2**-110`` and
    0; below that the three are off by less than ``2**-133``, bf16's least
    subnormal."""
    def truncated(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    hi = truncated(x)
    r = torch.where(x == hi, torch.zeros_like(x), x - hi)
    mid = truncated(r)
    return hi.bfloat16(), mid.bfloat16(), truncated(r - mid).bfloat16()


def int8_matmul_reference(xin: torch.Tensor, wq: torch.Tensor,
                          scale_row: torch.Tensor,
                          bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of the kernel on already-prepared operands:
    ``xin`` (N, K) f32/bf16/f16 or int8, ``wq`` (O, K) int8, ``scale_row`` and
    ``bias_row`` (O,) f32.  float64 product, accumulator rounded to f32,
    then a single-rounding ``acc * scale + bias``."""
    acc = (xin.double() @ wq.double().T).float()
    return fma_f32(acc, scale_row, bias_row)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                mode: str = "weight_only") -> torch.Tensor:
    """Quantized ``x @ wq.T (+ bias)`` — the primitive behind
    ``nn/quantized.py``.

    Args:
      x: (N, K) f32/bf16/f16 activations.
      wq: (O, K) int8 weights (symmetric per output channel).
      wscale: (O,) or (O, 1) f32 per-output-channel scales.
      bias: optional (O,) f32.
      mode: ``"weight_only"`` or ``"dynamic"``.

    Returns f32 (N, O), on ``x``'s device: the kernel for a CUDA tensor,
    the plain version for a CPU tensor.
    """
    if mode not in MODES:
        raise ValueError(
            f"int8 activation mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_matmul wants x (N, K) and wq (O, K); got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"kernel B4 (the int8 GEMM) has no {x.dtype} form: "
                        f"int8_matmul takes f32/bf16/f16 activations")
    xin, scale_row = prepare_operands(x, wscale, mode)
    bias_row = None if bias is None else bias.float().reshape(-1).contiguous()
    return int8_gemm(xin, wq, scale_row, bias_row)


def prepare_operands(x: torch.Tensor, wscale: torch.Tensor, mode: str):
    """``(GEMM activations, contiguous f32 (O,) scale row)`` for ``mode``:
    ``x`` and the weight scales as they are in weight_only; in dynamic
    ``dyn_quantize(x)`` and ``x_scale * w_scale_o`` (the reference's
    scale-row precompute).  Shared by every caller of :func:`int8_gemm`."""
    scale_row = wscale.reshape(-1).float()
    if mode == "dynamic":
        xq, xs = dyn_quantize(x)
        return xq, (xs * scale_row).float().contiguous()
    return x, scale_row.contiguous()


def int8_gemm(xin: torch.Tensor, wq: torch.Tensor, scale_row: torch.Tensor,
              bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """The GEMM on prepared operands (see :func:`int8_matmul_reference`):
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xin.device.type == "cuda":
        return launch(xin, wq, scale_row, bias_row)
    if xin.device.type == "cpu":
        return int8_matmul_reference(xin, wq, scale_row, bias_row)
    raise RuntimeError(f"the int8 GEMM has no version for {xin.device}")


def reset_counts() -> None:
    """Set ``launches`` and every ``variant_launches`` count to 0."""
    global launches
    launches = 0
    for v in VARIANTS:
        variant_launches[v] = 0


def _kernel_fn():
    """The kernel's C entry point with its ctypes signature, resolved on
    first use (that builds the library) and kept."""
    global _fn
    if _fn is None:
        fn = _build.load("int8_gemm").bigdl_int8_gemm
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
        _fn = fn
    return _fn


def launch(xin: torch.Tensor, wq: torch.Tensor, scale_row: torch.Tensor,
           bias_row: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the CUDA kernel on prepared operands (what
    :func:`int8_matmul_reference` takes); the mode follows ``xin``'s dtype
    (int8 = dynamic).  Raises on anything the kernel does not take."""
    global launches, last_variant
    dev = xin.device
    if dev.type != "cuda":
        raise RuntimeError(f"the int8 GEMM kernel runs on CUDA, not {dev}")
    if xin.dtype not in _X_DTYPE_CODE:
        raise TypeError(f"kernel activations must be f32, bf16, f16 or "
                        f"int8, got {xin.dtype}")
    mode = 1 if xin.dtype == torch.int8 else 0
    M, K = xin.shape
    O = wq.shape[0]
    if mode == 1 and K > _MAX_K_DYNAMIC:
        raise ValueError(f"K={K} overflows the int32 accumulator "
                         f"(max {_MAX_K_DYNAMIC})")
    if wq.dtype != torch.int8 or tuple(wq.shape) != (O, K):
        raise TypeError(f"wq must be int8 ({O}, {K}), got {wq.dtype} "
                        f"{tuple(wq.shape)}")
    for name, t in (("wq", wq), ("scale", scale_row), ("bias", bias_row)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in (("scale", scale_row), ("bias", bias_row)):
        if t is not None and (t.dtype != torch.float32
                              or t.numel() != O or not t.is_contiguous()):
            raise TypeError(f"{name} must be contiguous f32 ({O},)")
    y = torch.empty((M, O), dtype=torch.float32, device=dev)
    if M == 0:
        return y
    xin = xin.contiguous()
    wq = wq.contiguous()
    fn = _kernel_fn()
    info = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(mode, _X_DTYPE_CODE[xin.dtype], int(bias_row is not None),
                 xin.data_ptr(), wq.data_ptr(), scale_row.data_ptr(),
                 None if bias_row is None else bias_row.data_ptr(),
                 y.data_ptr(), M, K, O, stream, info)
    if err != 0:
        raise RuntimeError(f"int8 GEMM kernel launch failed: cudaError {err} "
                           f"(M={M}, K={K}, O={O}, x {xin.dtype})")
    launches += 1
    variant = VARIANTS[info[0]]
    variant_launches[variant] += 1
    last_variant = (variant,) + tuple(info[1:])
    return y

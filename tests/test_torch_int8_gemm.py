"""Port of the int8 GEMM (kernel B4): the plain version against the JAX
reference (the kernel itself is held to the plain version on the card in
``test_torch_gpu.py``).

Tolerances:
- dynamic: BITWISE.  The int8 x int8 sum is exact in both packages, and
  both epilogues round once (XLA on the CPU contracts ``acc*scale+bias``
  into an FMA; the port emulates that FMA from float64).
- weight_only: ``rtol=1e-5, atol=1e-5*max|y|``.  The port's plain product
  is float64, the reference sums in f32; the measured relative error is
  below 1e-6 at these shapes.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card
import jax.numpy as jnp

from bigdl_tpu.ops.pallas_int8_gemm import dyn_quantize as jax_dyn_quantize
from bigdl_tpu.ops.pallas_int8_gemm import int8_matmul as jax_int8_matmul
from bigdl_tpu_torch.ops import int8_gemm
from bigdl_tpu_torch.ops.int8_gemm import (dyn_quantize, fma_f32,
                                           int8_matmul,
                                           int8_matmul_reference,
                                           split_bf16x3)

# (N, K, O): the ResNet-50 stem's ragged K=147/O=64 at 1, 3 and 37 rows,
# 128-aligned shapes the Pallas kernel takes, and a ragged O like the FC's
RAGGED = [(1, 147, 64), (3, 147, 64), (37, 147, 64), (5, 64, 1000)]
ALIGNED = [(8, 256, 128), (37, 128, 128)]


def _operands(n, k, o, seed=0):
    rng = np.random.default_rng(seed + n * 7919 + k * 31 + o)
    x = rng.normal(0, 1, (n, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (o, k)).astype(np.int8)
    ws = rng.uniform(0.001, 0.02, (o, 1)).astype(np.float32)
    b = rng.normal(0, 1, (o,)).astype(np.float32)
    return x, wq, ws, b


def _jax(x, wq, ws, b, mode, impl):
    fn = jax.jit(lambda x, wq, ws, b: jax_int8_matmul(
        x, wq, ws, b, mode=mode, impl=impl,
        interpret=True if impl == "pallas" else None))
    return np.asarray(fn(x, wq, ws, b))


def _port(x, wq, ws, b, mode):
    t = (lambda a: None if a is None else torch.from_numpy(a))
    return int8_matmul(t(x), t(wq), t(ws), t(b), mode=mode).numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("mode", ["dynamic", "weight_only"])
@pytest.mark.parametrize("shape", RAGGED + ALIGNED,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_xla(shape, mode, bias):
    x, wq, ws, b = _operands(*shape)
    b = b if bias else None
    want = _jax(x, wq, ws, b, mode, "xla")
    got = _port(x, wq, ws, b, mode)
    assert got.shape == want.shape and got.dtype == np.float32
    if mode == "dynamic":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("mode", ["dynamic", "weight_only"])
@pytest.mark.parametrize("shape", ALIGNED, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret(shape, mode):
    x, wq, ws, b = _operands(*shape, seed=1)
    want = _jax(x, wq, ws, b, mode, "pallas")
    got = _port(x, wq, ws, b, mode)
    if mode == "dynamic":
        np.testing.assert_array_equal(got, want)
    else:
        _close(got, want)


def test_bf16_weight_only_within_tolerance():
    x, wq, ws, b = _operands(37, 147, 64, seed=2)
    want = np.asarray(jax.jit(lambda x, wq, ws, b: jax_int8_matmul(
        x.astype(jnp.bfloat16), wq, ws, b, mode="weight_only",
        impl="xla"))(x, wq, ws, b))
    got = int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(wq),
                      torch.from_numpy(ws), torch.from_numpy(b)).numpy()
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dyn_quantize_bitwise(dtype):
    """Swept over amax magnitudes: a true ``amax / 127`` differs from the
    jitted reference (``amax * f32(1/127)``) for about 5% of f32 amax."""
    rng = np.random.default_rng(3)
    fn = jax.jit(jax_dyn_quantize)
    for i in range(60):
        x = (rng.normal(0, 1, (8, 33)) * np.exp(rng.uniform(-6, 6))
             ).astype(np.float32)
        if i == 0:
            x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # ties: round half to even
        qj, sj = fn(jnp.asarray(x).astype(dtype))
        qt, st = dyn_quantize(torch.from_numpy(x).to(getattr(torch, dtype)))
        np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
        assert float(np.asarray(sj, np.float32)) == float(st.float())


def _exact_fma_f32(a, b, c):
    """Round the exact a*b+c to the nearest f32, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    winners = [v for v, d in zip(cands, dist) if d == best]
    return min(winners, key=lambda v: int(np.float32(v).view(np.int32)) & 1)


def test_fma_emulation_rounds_once():
    # 4097*4097 = 2**24 + 8193 is an exact f32 midpoint; a tiny c must
    # push it up or down — plain float64 rounding would land on the tie
    a = np.array([4097, 4097, 4097, 3, 1], np.float32)
    b = np.array([4097, 4097, 4097, 1 / 3, 1e-8], np.float32)
    c = np.array([2.0 ** -30, -2.0 ** -30, 0, 1e-9, 1], np.float32)
    rng = np.random.default_rng(4)
    a = np.concatenate([a, rng.normal(0, 1e3, 300).astype(np.float32)])
    b = np.concatenate([b, rng.normal(0, 1e-2, 300).astype(np.float32)])
    c = np.concatenate([c, rng.normal(0, 1e-4, 300).astype(np.float32)])
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma_f32(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(16785410) and got[1] == np.float32(16785408)


def test_wrapper_refuses_bad_inputs():
    x, wq, ws, b = (torch.from_numpy(a) for a in _operands(3, 8, 4))
    with pytest.raises(ValueError, match="mode"):
        int8_matmul(x, wq, ws, b, mode="static")
    with pytest.raises(TypeError, match="f32/bf16"):
        int8_matmul(x.double(), wq, ws, b)
    with pytest.raises(ValueError, match=r"\(N, K\)"):
        int8_matmul(x[:, :5], wq, ws, b)
    with pytest.raises(RuntimeError, match="no version"):
        int8_matmul(x.to("meta"), wq.to("meta"), ws.to("meta"))
    with pytest.raises(RuntimeError, match="CUDA"):
        int8_gemm.launch(x, wq, ws.reshape(-1), b)


def test_cpu_path_does_not_count_launches():
    before = int8_gemm.launches
    _port(*_operands(3, 147, 64), "dynamic")
    assert int8_gemm.launches == before


# ---------------------------------------------------------------------------
# The wgmma_weight_only kernel's three-way split of f32 activations (its
# arithmetic kept on the CPU as ``split_bf16x3``).

def _split_sum(x):
    parts = split_bf16x3(torch.from_numpy(x))
    assert all(p.dtype == torch.bfloat16 for p in parts)
    return sum(p.double() for p in parts).numpy()


def test_split_bf16x3_is_exact():
    """hi + mid + lo == x exactly, summed in float64, for every f32 of
    magnitude 2^-110 or more and for +-0: random normals, every power of
    two, random values across the whole range with both signs, and the
    values next to f32's largest (where rounding hi to nearest would
    overflow bf16)."""
    rng = np.random.default_rng(6)
    fmax = np.finfo(np.float32).max
    pow2 = np.exp2(np.arange(-110.0, 128.0))
    wide = (rng.uniform(1, 2, 8192) * np.exp2(rng.integers(-110, 127, 8192))
            * rng.choice([-1.0, 1.0], 8192))
    near_max = np.array([fmax, -fmax, 3.39e38, -3.3e38, 2.0 ** 127 * 1.99])
    x = np.concatenate([rng.normal(0, 1, 8192), pow2, -pow2, wide, near_max,
                        [np.nextafter(np.float32(fmax), np.float32(0))],
                        [0.0, -0.0]]).astype(np.float32)
    assert np.isfinite(x).all()
    np.testing.assert_array_equal(_split_sum(x), x.astype(np.float64))


def test_split_bf16x3_below_2_pow_minus_110():
    """Subnormals and normals below 2^-110 split within less than 2^-133
    (bf16's least subnormal; no three bf16 values can hold every bit of
    them); infinities are their own hi and NaN stays NaN."""
    rng = np.random.default_rng(7)
    tiny = np.concatenate([
        rng.uniform(1, 2, 4096) * np.exp2(rng.integers(-126, -110, 4096)),
        rng.uniform(0, 2.0 ** -126, 4096),
        [1e-45, -1e-45, 2.0 ** -149, 2.0 ** -126 * (1 - 2.0 ** -23)]]
    ).astype(np.float32)
    err = np.abs(_split_sum(tiny) - tiny.astype(np.float64))
    assert err.max() < 2.0 ** -133
    hi, mid, lo = split_bf16x3(torch.tensor([np.inf, -np.inf, np.nan]))
    assert hi[0] == np.inf and hi[1] == -np.inf and torch.isnan(hi[2])
    assert torch.equal(mid[:2], torch.zeros(2, dtype=torch.bfloat16))
    assert torch.equal(lo[:2], torch.zeros(2, dtype=torch.bfloat16))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_split_products_within_kernel_limit(bias):
    """The kernel's sum at K=4608 (stage 4 of ResNet-50): for each 64-wide
    stage, each k16 slice's hi, mid and lo products with the int8 weights
    (each product exact in f32, each slice's sum rounded once, as the
    tensor cores' at best) added into a fresh f32 accumulator, which is
    added into the running sum; then the one-rounding epilogue.  Within
    the kernel check's limit (``rtol=1e-5, atol=1e-5*max|y|``) of the plain
    version ``int8_matmul_reference``."""
    M, K, O = 37, 4608, 64
    x, wq, ws, b = (torch.from_numpy(a) for a in _operands(M, K, O, seed=8))
    scale = ws.reshape(-1).contiguous()
    b = b if bias else None
    terms = split_bf16x3(x)
    w = wq.double()
    total = torch.zeros(M, O)
    for k0 in range(0, K, 64):
        acc = torch.zeros(M, O)
        for kk in range(k0, k0 + 64, 16):
            for t in terms:
                acc = acc + (t[:, kk:kk + 16].double()
                             @ w[:, kk:kk + 16].T).float()
        total = total + acc
    got = fma_f32(total, scale, b)
    want = int8_matmul_reference(x, wq, scale, b)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    # the hi terms alone (bf16 activations' one pass) are not enough
    lone = fma_f32(terms[0].double().matmul(w.T).float(), scale, b)
    assert (lone - want).abs().max() > 1e-5 * want.abs().max()


# The mma variants' order of summation (K not a multiple of 16: the
# quantized recurrent cells' projections of [x_t, h], K = 100 + 128, and
# ResNet-50's stem, K = 147): K zero-filled to the next k16 (k32 for
# dynamic), each k16 slice's hi, mid and lo products (one for bf16 or f16
# x) into the 64-wide stage's fresh f32 accumulator, the stages added into
# the tile's sum in K order; dynamic an exact integer sum.
MMA_SHAPES = [(128, 228, 512), (128, 228, 256), (128, 228, 128),
              (37, 147, 64)]


def _mma_weight_only(x, wq, scale, b):
    M, K = x.shape
    pad = -K % 16
    xp = torch.nn.functional.pad(x.float(), (0, pad))
    w = torch.nn.functional.pad(wq, (0, pad)).double()
    if x.dtype == torch.float32:
        terms = split_bf16x3(xp)
    else:  # bf16 or f16 x: one exact pass against the upcast panel
        terms = (xp.to(x.dtype),)
    total = torch.zeros(M, wq.shape[0])
    for k0 in range(0, K + pad, 64):
        acc = torch.zeros_like(total)
        for kk in range(k0, min(k0 + 64, K + pad), 16):
            for t in terms:
                acc = acc + (t[:, kk:kk + 16].double()
                             @ w[:, kk:kk + 16].T).float()
        total = total + acc
    return fma_f32(total, scale, b)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", MMA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mma_weight_only_order_within_kernel_limit(shape, bias, xdtype):
    """The mma_weight_only kernel's sum, emulated, within the kernel
    check's limit (``rtol=1e-5, atol=1e-5*max|y|``) of the plain version
    ``int8_matmul_reference`` on the same (f32, bf16 or f16) rows."""
    x, wq, ws, b = (torch.from_numpy(a) for a in _operands(*shape, seed=9))
    x = x.to(getattr(torch, xdtype))
    scale = ws.reshape(-1).contiguous()
    b = b if bias else None
    got = _mma_weight_only(x, wq, scale, b)
    want = int8_matmul_reference(x, wq, scale, b)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", MMA_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_mma_dynamic_order_is_bitwise(shape, bias):
    """The mma_dynamic kernel's sum, emulated (int8 rows zero-filled to the
    next k32, one int32 sum a k32 slice, the slices added in K order),
    then the one-rounding epilogue: bitwise the plain version."""
    x, wq, ws, b = (torch.from_numpy(a) for a in _operands(*shape, seed=10))
    xq, xs = dyn_quantize(x)
    scale = (xs * ws.reshape(-1)).float().contiguous()
    b = b if bias else None
    K = x.shape[1]
    pad = -K % 32
    xi = torch.nn.functional.pad(xq, (0, pad)).long()
    wi = torch.nn.functional.pad(wq, (0, pad)).long()
    acc = torch.zeros(x.shape[0], wq.shape[0], dtype=torch.long)
    for k in range(0, K + pad, 32):
        acc += xi[:, k:k + 32] @ wi[:, k:k + 32].T
    assert acc.abs().max() < 2 ** 31
    got = fma_f32(acc.float(), scale, b)
    assert torch.equal(got, int8_matmul_reference(xq, wq, scale, b))


def _round_toward_zero(d: torch.Tensor) -> torch.Tensor:
    """float64 -> f32, truncated toward zero."""
    f = d.float()
    over = f.double().abs() > d.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def test_stage_sums_bound_a_truncating_accumulator():
    """Why the kernel adds each 64-wide stage's products into a fresh
    accumulator and then into the tile's sum with IEEE adds: the tensor
    cores' f32 accumulation is not an IEEE add, and were each k16 add
    truncated toward zero, one accumulator over K=4608 would reach the
    kernel check's limit, while fresh stage accumulators stay far inside
    it (the limit as in ``test_split_products_within_kernel_limit``)."""
    M, K, O = 37, 4608, 64
    x, wq, ws, _ = (torch.from_numpy(a) for a in _operands(M, K, O, seed=0))
    scale = ws.reshape(-1).contiguous()
    want = int8_matmul_reference(x, wq, scale, None)
    limit = 1e-5 * want.abs() + 1e-5 * want.abs().max()
    terms, w = split_bf16x3(x), wq.double()
    one = torch.zeros(M, O)
    total = torch.zeros(M, O)
    for k0 in range(0, K, 64):
        acc = torch.zeros(M, O)
        for kk in range(k0, k0 + 64, 16):
            for t in terms:
                part = t[:, kk:kk + 16].double() @ w[:, kk:kk + 16].T
                one = _round_toward_zero(one.double() + part)
                acc = _round_toward_zero(acc.double() + part)
        total = total + acc
    ratio = {name: ((fma_f32(v, scale, None) - want).abs() / limit).max()
             for name, v in (("one", one), ("stages", total))}
    assert ratio["one"] > 0.5
    assert ratio["stages"] < 0.1

"""The port's first-match max-pool backward (kernel B1's plain version,
``ops/maxpool.py``) and ``SpatialMaxPooling``'s gradient on the CPU against
the reference's Pallas kernel ``maxpool_nhwc_with_pallas_bwd``, run in
interpret mode, and against its default ``reduce_window`` gradient
(select-and-scatter, also first-match).

Inputs are integer-valued, so windows hold exact ties and the first-match
rule decides where each gradient lands; one case is post-ReLU, where a
window's maximum is often an exact 0 held by several positions.
Tolerances: f32 ``atol=1e-5`` (the reference test's own), bitwise where
windows do not overlap (each position gets at most one gradient).  bf16:
against the Pallas kernel, which adds in the same order, within one bf16
ulp; against select-and-scatter, which adds the same terms in another
order with a bf16 rounding after each, one ulp of ``max|g|`` for each
window that covers a position (``atol = n_cover * 2^-7 * max|g|``).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from bigdl_tpu.ops import pallas_pool  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.ops import maxpool  # noqa: E402

# the reference test's four CASES (tests/test_round4_perf.py) and the
# ResNet-50 stem (3x3/2 pad 1) at N=2, H=16; each with the SpatialMaxPooling
# (pad, ceil_mode) that gives its padding
CASES = {
    "3x3s2_lo0_hi1": ((2, 16, 16, 64), (3, 3), (2, 2), ((0, 1), (0, 1)),
                      (0, True)),
    "3x3s1_p1": ((1, 8, 8, 128), (3, 3), (1, 1), ((1, 1), (1, 1)),
                 (1, False)),
    "2x2s2": ((1, 12, 12, 8), (2, 2), (2, 2), ((0, 0), (0, 0)), (0, False)),
    "3x3s2_p1_c160": ((1, 14, 14, 160), (3, 3), (2, 2), ((1, 1), (1, 1)),
                      (1, False)),
    "stem": ((2, 16, 16, 64), (3, 3), (2, 2), ((1, 1), (1, 1)), (1, False)),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    """The reference's Pallas kernel under the Pallas interpreter."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pallas_pool.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _inputs(shape, relu=False, seed=0):
    rng = np.random.default_rng(seed)
    if relu:
        x = np.maximum(rng.normal(0, 1, shape), 0.0).astype(np.float32)
    else:
        x = rng.integers(-4, 5, shape).astype(np.float32)
    return x


_CACHE = {}


def _reference(x, kernel, stride, pads, jdtype, pallas):
    """(y, g, gradient) of the reference, NHWC numpy in f32; kept per
    input, so both formats of a case share one (slow) interpreted run."""
    key = (x.tobytes(), x.shape, kernel, stride, pads, jdtype, pallas)
    if key not in _CACHE:
        _CACHE[key] = _run_reference(x, kernel, stride, pads, jdtype, pallas)
    return _CACHE[key]


def _run_reference(x, kernel, stride, pads, jdtype, pallas):
    xj = jnp.asarray(x, jdtype)
    dims, strides = (1,) + kernel + (1,), (1,) + stride + (1,)
    full = ((0, 0),) + pads + ((0, 0),)
    y = lax.reduce_window(xj, -jnp.inf, lax.max, dims, strides, full)
    g = jnp.cos(jnp.arange(y.size, dtype=jnp.float32)).reshape(
        y.shape).astype(jdtype)
    if pallas:
        def pool(v):
            return pallas_pool.maxpool_nhwc_with_pallas_bwd(v, dims, strides,
                                                            full)
    else:
        def pool(v):
            return lax.reduce_window(v, -jnp.inf, lax.max, dims, strides,
                                     full)
    _, vjp = jax.vjp(pool, xj)
    (gi,) = vjp(g)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(y), f32(g), f32(gi)


def _port_plain(x, y, g, kernel, stride, pads, tdtype, fmt):
    """The port's plain B1 on the same numbers, in ``fmt``'s layout;
    the gradient comes back NHWC numpy f32."""
    to = lambda a: torch.from_numpy(np.array(a)).to(tdtype)  # noqa: E731
    xt, yt, gt = to(x), to(y), to(g)
    if fmt == "NHWC":  # the NCHW-indexed views of NHWC tensors
        xt, yt, gt = (t.permute(0, 3, 1, 2) for t in (xt, yt, gt))
    else:
        xt, yt, gt = (t.permute(0, 3, 1, 2).contiguous()
                      for t in (xt, yt, gt))
    gi = maxpool.maxpool_bwd_reference(xt, yt, gt, kernel, stride, pads)
    assert gi.dtype == tdtype and gi.stride() == xt.stride()
    return gi.permute(0, 2, 3, 1).float().numpy()


def _layer_grad(x, g, kernel, stride, layer_args, tdtype, fmt):
    """(y, gradient) of the port's SpatialMaxPooling, NHWC numpy f32."""
    (kh, kw), (sh, sw), (pad, ceil) = kernel, stride, layer_args
    layer = nn.SpatialMaxPooling(kw, kh, sw, sh, pad, pad, ceil_mode=ceil,
                                 format=fmt)
    xt = torch.from_numpy(x).to(tdtype)
    gt = torch.from_numpy(np.array(g)).to(tdtype)
    if fmt == "NCHW":
        xt, gt = (t.permute(0, 3, 1, 2).contiguous() for t in (xt, gt))
    xt.requires_grad_(True)
    y = layer(xt)
    y.backward(gt)
    y, gi = y.detach(), xt.grad
    if fmt == "NCHW":
        y, gi = y.permute(0, 2, 3, 1), gi.permute(0, 2, 3, 1)
    return y.float().numpy(), gi.float().numpy()


def _assert_within_one_ulp(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    # one bf16 ulp of the larger magnitude: 2^(exponent - 7)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    assert np.all(np.abs(got - want) <= ulp), \
        np.max(np.abs(got - want) / ulp)


def _overlapping(kernel, stride):
    return kernel[0] > stride[0] or kernel[1] > stride[1]


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b1_matches_pallas_kernel(interpret, case, dtype, fmt):
    shape, kernel, stride, pads, _ = CASES[case]
    x = _inputs(shape)
    y, g, want = _reference(x, kernel, stride, pads, DTYPES[dtype][0], True)
    got = _port_plain(x, y, g, kernel, stride, pads, DTYPES[dtype][1], fmt)
    if not _overlapping(kernel, stride):
        np.testing.assert_array_equal(got, want)
    _assert_within_one_ulp(got, want, dtype)


@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_gradient_matches_pallas_kernel(interpret, case, dtype, fmt):
    shape, kernel, stride, pads, layer_args = CASES[case]
    x = _inputs(shape, seed=1)
    y, g, want = _reference(x, kernel, stride, pads, DTYPES[dtype][0], True)
    y_port, got = _layer_grad(x, g, kernel, stride, layer_args,
                              DTYPES[dtype][1], fmt)
    np.testing.assert_array_equal(y_port, y)  # the forward is exact
    if not _overlapping(kernel, stride):
        np.testing.assert_array_equal(got, want)
    _assert_within_one_ulp(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_b1_matches_select_and_scatter(case, dtype):
    shape, kernel, stride, pads, _ = CASES[case]
    x = _inputs(shape, seed=2)
    y, g, want = _reference(x, kernel, stride, pads, DTYPES[dtype][0], False)
    got = _port_plain(x, y, g, kernel, stride, pads, DTYPES[dtype][1], "NHWC")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        return
    n_cover = -(-kernel[0] // stride[0]) * -(-kernel[1] // stride[1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=n_cover * 2.0 ** -7 * np.abs(g).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_post_relu_ties_at_the_stem(interpret, dtype):
    """After a ReLU about half the positions are an exact 0, so all-zero
    windows are common and the first real position must take them."""
    shape, kernel, stride, pads, layer_args = CASES["stem"]
    x = _inputs(shape, relu=True, seed=3)
    y, g, want = _reference(x, kernel, stride, pads, DTYPES[dtype][0], True)
    assert (y == 0).any()  # windows whose maximum is a tie of zeros
    _, got = _layer_grad(x, g, kernel, stride, layer_args, DTYPES[dtype][1],
                         "NHWC")
    _assert_within_one_ulp(got, want, dtype)


def test_ceil_mode_odd_size_matches_reference_layer():
    """BigDL ceil mode on an odd size: the reference's default layer
    (reduce_window) and the port's, forward and gradient."""
    from bigdl_tpu import nn as jnn
    x = _inputs((2, 3, 11, 11), seed=4)
    jl = jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, ceil_mode=True)
    g = None

    def loss(v):
        y, _ = jl.apply({}, {}, v)
        return jnp.sum(y * g)

    y_ref, _ = jl.apply({}, {}, jnp.asarray(x))
    g = jnp.asarray(np.cos(np.arange(y_ref.size)).reshape(y_ref.shape),
                    jnp.float32)
    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    layer = nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, ceil_mode=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = layer(xt)
    yt.backward(torch.from_numpy(np.asarray(g)))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=0)


def test_cpu_tensors_never_launch_the_kernel():
    before = maxpool.launches
    x = torch.randn(2, 3, 9, 9, requires_grad=True)
    nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1)(x).sum().backward()
    assert maxpool.launches == before
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        maxpool.launch(x.detach(), x.detach()[:, :, :4, :4],
                       x.detach()[:, :, :4, :4], (3, 3), (2, 2),
                       ((1, 1), (1, 1)))

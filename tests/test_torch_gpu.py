"""The port on the card: the hand-written int8 GEMM, LSTM cell and max-pool
backward kernels against their plain versions, the quantized serving slice,
one PTB training block, a small NHWC ResNet's training and a LeNet-5 block
(validation and a snapshot included) against the same model on the CPU;
LeNet-5 through a world-1 NCCL ``DistriOptimizer`` against
``LocalOptimizer`` on the card (bitwise with the f32 wire; the bf16 wire's
masters within ``WIRE_DRIFT_LIMIT`` of its weights), and the bf16 wire's
stochastic round against the CPU's (bitwise, same noise); B1 at VGG's
and Inception's pool geometries, and one step of VGG for CIFAR-10 and of
Inception v1 against the CPU (each step's loss within ``rtol=1e-4``, the
weights' step within a stated share of its change: their whole-model
gradients differ between two sound devices by up to percents).  Every test
here needs a CUDA card and skips without one; on the card run ``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
no JAX, so it runs where the reference package is not installed.

Tolerances: dynamic mode is BITWISE (exact integer sums, one-rounding FMA
epilogue on both sides); weight_only ``rtol=1e-5, atol=1e-5*max|y|``
(f32 sums on the card, float64 in the plain version; the wgmma variant's
products are exact, its sums f32 in another order).  Served models:
weight_only ``1e-4`` and dynamic ``1e-3`` of ``max|y|`` — see
``test_torch_serving.py`` for why dynamic mode needs more.  LSTM cell, f32:
``rtol=atol=1e-5`` (the recurrent product summed in another order; the
gates' expf/tanhf within ulps of PyTorch's); bf16 outputs within one bf16
ulp (``rtol=atol=8e-3``).  Training on the card against the CPU: losses
``rtol=1e-4``, parameters ``1e-4`` of each array's largest value.  The
max-pool backward is BITWISE against its plain version (the same terms
added in the same order and dtype), and so is the embedding bag, forward
and swapped-role weight gradient (the same FMAs in the same order); its
hand-written grouping passes give ``row_index``'s offsets and its ``perm``
over every bound exactly (entries outside every bound: on their side, in
nnz order).
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import (DataSet, Sample, SampleToMiniBatch,
                                     SparseSample, Transformer,
                                     batch_sparse_samples)
from bigdl_tpu_torch.interop import to_jax_params
from bigdl_tpu_torch.models import WideAndDeep, ptb_model, resnet_cifar
from bigdl_tpu_torch.models import resnet as tresnet
from bigdl_tpu_torch.ops import (_build, embed_bag, int8_gemm, lstm_cell,
                                 maxpool)
from bigdl_tpu_torch.ops.int8_gemm import dyn_quantize, int8_matmul_reference
from bigdl_tpu_torch.serving import ModelRegistry

pytestmark = pytest.mark.gpu

# (M, K, O): the stem's ragged K=147/O=64 at 1, 3 and 37 rows (the SIMT
# variants: TMA cannot describe a 147-byte int8 weight row), the FC's
# O=1000, aligned shapes, and a stage-1 3x3 conv with several row blocks;
# then, for the wgmma variants, stage 4's long K (1568, 4608, 512), the FC's
# K=2048 against O=1000 at 1, 37 and 32 rows, K=64 (half of one 128-byte K
# box) and a K >= 1024 shape whose M and O fill no whole tile; then K=64
# and K=4608 against O=1000 at 1, 32 and 37 rows (weight_only's shortest
# and longest sums), and two shapes large enough for the two-warpgroup
# tiles (128 rows against 128 or 64 columns)
SHAPES = [(1, 147, 64), (3, 147, 64), (37, 147, 64), (5, 64, 1000),
          (8, 256, 128), (37, 128, 128), (300, 576, 64),
          (1568, 4608, 512), (1, 2048, 1000), (37, 2048, 1000),
          (32, 2048, 1000), (300, 64, 256), (1001, 1152, 200),
          (1, 64, 1000), (32, 64, 1000), (37, 64, 1000), (1, 4608, 1000),
          (32, 4608, 1000), (37, 4608, 1000), (12544, 576, 128),
          (12544, 256, 64)]


def _variant(K, xdtype):
    """The variant the C entry point takes for contiguous operands."""
    mode = "dynamic" if xdtype == "int8" else "weight_only"
    return ("wgmma_" if K % 16 == 0 else "simt_") + mode


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(M, K, O, xdtype, bias, device, seed=5):
    rng = np.random.default_rng(seed + M * 7919 + K * 31 + O)
    x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (O, K)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(0.001, 0.02, O).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, O).astype(np.float32))
    x, wq, scale, b = (t.to(device) for t in (x, wq, scale, b))
    if xdtype == "int8":
        xin, xs = dyn_quantize(x)
        scale = (xs * scale).float()
    else:
        xin = x.to(getattr(torch, xdtype))
    return xin, wq, scale, b if bias else None


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain(cuda, shape, bias, xdtype):
    xin, wq, scale, b = _operands(*shape, xdtype, bias, cuda)
    before = int8_gemm.launches
    variant = _variant(shape[1], xdtype)
    before_v = int8_gemm.variant_launches[variant]
    got = int8_gemm.launch(xin, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    assert int8_gemm.variant_launches[variant] == before_v + 1
    assert int8_gemm.last_variant[0] == variant
    want = int8_matmul_reference(xin, wq, scale, b)
    if xdtype == "int8":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def test_unaligned_base_takes_simt(cuda):
    """A K that TMA could describe but a base off a 16-byte boundary goes
    to the SIMT variant, bitwise all the same."""
    xin, wq, scale, b = _operands(37, 256, 128, "int8", True, cuda)
    buf = torch.empty(xin.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = buf[1:].view(xin.shape)
    shifted.copy_(xin)
    got = int8_gemm.launch(shifted, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.last_variant[0] == "simt_dynamic"
    assert torch.equal(got, int8_matmul_reference(xin, wq, scale, b))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_unaligned_weight_only_base_takes_simt(cuda, xdtype):
    """weight_only activations off a 16-byte boundary go to the SIMT
    variant, within the same tolerance."""
    xin, wq, scale, b = _operands(37, 256, 128, xdtype, True, cuda)
    buf = torch.empty(xin.numel() + 1, dtype=xin.dtype, device=cuda)
    shifted = buf[1:].view(xin.shape)
    shifted.copy_(xin)
    got = int8_gemm.launch(shifted, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.last_variant[0] == "simt_weight_only"
    want = int8_matmul_reference(xin, wq, scale, b)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_kernel_refuses_what_it_does_not_take(cuda):
    xin, wq, scale, b = _operands(4, 16, 8, "float32", True, cuda)
    with pytest.raises(TypeError, match="f32, bf16 or int8"):
        int8_gemm.launch(xin.double(), wq, scale, b)
    with pytest.raises(TypeError, match="wq must be int8"):
        int8_gemm.launch(xin, wq.float(), scale, b)
    with pytest.raises(ValueError, match="is on cpu"):
        int8_gemm.launch(xin, wq, scale.cpu(), b)
    assert "int8_gemm" in _build._libs


@pytest.mark.parametrize("quantize", [True, "dynamic"],
                         ids=["weight_only", "dynamic"])
def test_served_on_card_matches_cpu(cuda, quantize):
    mode = "dynamic" if quantize == "dynamic" else "weight_only"
    model = resnet_cifar(8).initialize(0)
    x = np.random.default_rng(3).normal(0, 1, (5, 3, 32, 32)).astype(
        np.float32)
    with torch.inference_mode():
        want = nn.quantize(model, mode=mode)(torch.from_numpy(x)).numpy()
    with ModelRegistry(device=cuda) as reg:
        svc = reg.deploy("r", model, input_spec=((3, 32, 32), np.float32),
                         quantize=quantize, max_batch_size=8)
        int8_gemm.launches = 0
        got = reg.predict("r", x, timeout=120)
        # 9 convolutions and the classifier, one kernel launch each
        assert int8_gemm.launches == 10 * svc.stats()["dispatch_count"]
    tol = {"weight_only": 1e-4, "dynamic": 1e-3}[mode]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# (N, H): PTB-medium's, tiny, ragged, N above one 32-row batch tile (37,
# 64), and an odd H that the forward's eight K slices do not divide (its bf16
# rows take the plain-load copies)
CELL_SHAPES = [(20, 650), (1, 64), (5, 130), (37, 650), (64, 650), (20, 333)]


@pytest.mark.parametrize("fb", [0.0, 1.0], ids=["fb0", "fb1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_lstm_cell_kernels_match_plain(cuda, shape, dtype, fb):
    N, H = shape
    rng = np.random.default_rng(N * 1000 + H)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(0, 0.5, s).astype(np.float32)).to(
            cuda, getattr(torch, dtype))
    zx, h, c, w_t, dh, dc = (mk(N, 4 * H), mk(N, H), mk(N, H), mk(H, 4 * H),
                             mk(N, H), mk(N, H))
    before = (lstm_cell.fwd_launches, lstm_cell.bwd_launches)
    got = lstm_cell.launch_fwd(zx, h, c, w_t, fb)
    want = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, fb)
    z = got[2]
    got_b = lstm_cell.launch_bwd(z, c, dh, dc, fb)
    want_b = lstm_cell.lstm_cell_bwd_reference(z, c, dh, dc, fb)
    torch.cuda.synchronize()
    assert (lstm_cell.fwd_launches, lstm_cell.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    # the forward's K=H spread over clusters of 8 CTAs: 16 hidden units and
    # up to 32 batch rows a cluster; the backward a grid of batch rows by
    # runs of 128 hidden units, one a thread
    ctas, cluster = lstm_cell.last_fwd_shape[:2]
    assert cluster == 8 and ctas == -(-H // 16) * 8 * -(-N // 32)
    assert lstm_cell.last_bwd_shape == (-(-H // 128) * N, 128)
    # f32 results within 1e-5, the forward's at H=650 within 1e-4 (its
    # recurrent product sums 650 terms in another order than cuBLAS; the
    # JAX cell test's forward tolerance at that shape); bf16 within 8e-3
    for i, (g, w) in enumerate(zip(got + got_b, want + want_b)):
        assert g.dtype == w.dtype
        fwd = i < len(got)
        t = 8e-3 if g.dtype == torch.bfloat16 else \
            1e-4 if fwd and H > 130 else 1e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=t, atol=t)


def test_lstm_cell_bwd_rows_beyond_the_grid(cuda):
    """N above the grid's 65,535 rows: the backward's blocks stride over the
    batch rows; f32 within 1e-5 of the plain version."""
    N, H = 70_000, 3
    rng = np.random.default_rng(7)
    z, c, dh, dc = (torch.from_numpy(rng.normal(0, 0.5, s).astype(
        np.float32)).to(cuda) for s in ((N, 4 * H), (N, H), (N, H), (N, H)))
    got = lstm_cell.launch_bwd(z, c, dh, dc, 1.0)
    want = lstm_cell.lstm_cell_bwd_reference(z, c, dh, dc, 1.0)
    torch.cuda.synchronize()
    assert lstm_cell.last_bwd_shape == (65_535, 128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_lstm_cell_bwd_floor_takes_the_backward_grid(cuda):
    """The empty kernel launched for the floor has the backward's grid and
    writes nothing."""
    rng = np.random.default_rng(8)
    z, c, dh, dc = (torch.from_numpy(rng.normal(0, 0.5, s).astype(
        np.float32)).to(cuda) for s in ((20, 2600), (20, 650), (20, 650),
                                        (20, 650)))
    before = [t.clone() for t in (z, c, dh, dc)]
    n = lstm_cell.bwd_launches
    lstm_cell.launch_bwd(z, c, dh, dc)
    shape = lstm_cell.launch_bwd_empty(z, c, dh, dc)
    torch.cuda.synchronize()
    assert shape == lstm_cell.last_bwd_shape == (120, 128)
    assert lstm_cell.bwd_launches == n + 1
    assert all(torch.equal(a, b) for a, b in zip(before, (z, c, dh, dc)))


def test_lstm_cell_kernel_refuses_what_it_does_not_take(cuda):
    zx, h, c = (torch.zeros(2, n, device=cuda) for n in (32, 8, 8))
    w_t = torch.zeros(32, 8, device=cuda).T
    with pytest.raises(TypeError, match="strided"):
        lstm_cell.launch_fwd(zx, h, c, w_t)
    with pytest.raises(TypeError, match="f32 or bf16"):
        lstm_cell.launch_fwd(zx.double(), h, c, w_t.contiguous())
    with pytest.raises(ValueError, match="is on cpu"):
        lstm_cell.launch_fwd(zx, h.cpu(), c, w_t.contiguous())


def test_ptb_training_on_card_matches_cpu(cuda):
    """Two K=2 blocks of a small PTB model trained on the card against
    the same steps on the CPU; layer 0 goes through the kernels 12 times a
    step each way (T=12)."""
    T, steps = 12, 4
    ids = np.minimum(np.random.default_rng(0).zipf(1.4, 8 * T + 1),
                     199).astype(np.int32)
    samples = [Sample(ids[i * T:(i + 1) * T], ids[i * T + 1:(i + 1) * T + 1])
               for i in range(8)]
    runs = {}
    for dev in ("cpu", cuda):
        model = ptb_model(200, 64, 96, 2).initialize(0)
        opt = (optim.LocalOptimizer(
            model, DataSet.array(samples) >> SampleToMiniBatch(4),
            nn.TimeDistributedCriterion(nn.ClassNLLCriterion()), device=dev)
            .set_optim_method(optim.SGD(learning_rate=1.0))
            .set_gradient_clipping_by_l2_norm(5.0)
            .set_steps_per_dispatch(2)
            .set_end_when(optim.max_iteration(steps)))
        losses = []
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
        opt.optimize()
        runs[str(dev)] = (losses, to_jax_params(model)[0],
                          lstm_cell.fwd_launches, lstm_cell.bwd_launches)
    (lc, pc, fc, bc), (lg, pg, fg, bg) = runs["cpu"], runs[str(cuda)]
    assert (fc, bc) == (0, 0)
    assert fg == bg == T * steps
    np.testing.assert_allclose(lg, lc, rtol=1e-4)

    def flat(t, pre=""):
        for k, v in t.items():
            yield from (flat(v, f"{pre}{k}.") if isinstance(v, dict)
                        else [(f"{pre}{k}", v)])
    for (k, a), (_, b) in zip(flat(pg), flat(pc)):
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=k)


# (x shape (N, C, H, W), kernel, stride, pad, ceil_mode, format, dtype);
# kernel, stride and pad an int or (h, w).  After the stem, LeNet/VGG,
# Inception, ceil-mode and ragged-C cases, the kernel's other branches: a
# 5x3 window with unequal pads and a 1x1/2 (the loops), a 16x16 window
# (int32 offsets).
POOLS = [((4, 64, 32, 32), 3, 2, 1, False, "NHWC", torch.float32),
         ((4, 64, 32, 32), 3, 2, 1, False, "NHWC", torch.bfloat16),
         ((4, 64, 32, 32), 3, 2, 1, False, "NCHW", torch.float32),
         ((2, 16, 12, 12), 2, 2, 0, False, "NCHW", torch.float32),
         ((2, 32, 14, 14), 3, 1, 1, False, "NHWC", torch.bfloat16),
         ((2, 8, 27, 27), 3, 2, 0, True, "NHWC", torch.float32),
         ((2, 3, 33, 33), 3, 2, 1, False, "NHWC", torch.float32),
         ((2, 160, 14, 14), 3, 2, 1, False, "NHWC", torch.bfloat16),
         ((2, 16, 29, 30), (5, 3), 2, (2, 1), False, "NHWC", torch.float32),
         ((2, 16, 29, 30), (5, 3), 2, (2, 1), False, "NCHW", torch.bfloat16),
         ((2, 16, 28, 28), 1, 2, 0, False, "NHWC", torch.bfloat16),
         ((2, 8, 64, 64), 16, 8, 0, False, "NHWC", torch.float32),
         ((2, 8, 61, 61), 16, 8, 0, True, "NCHW", torch.bfloat16)]


def _pair(v):
    return tuple(v) if isinstance(v, tuple) else (v, v)


def _pool_id(c):
    part = lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)
    return "_".join(map(part, (*c[0], c[1], c[2], c[3], c[4], c[5],
                               str(c[6])[6:])))


def _pool_operands(case, relu, cuda, wide=False, g_channels_last=False):
    """x (NCHW-indexed; for NHWC the channels_last view of an NHWC
    tensor; with ``wide`` a strided view of a buffer of 2^31 + elements, so
    that the kernel takes 64-bit indices), y, g (contiguous, or
    channels_last with ``g_channels_last``), kernel, stride, pads."""
    (N, C, H, W), k, s, p, ceil, fmt, dtype = case
    (kh, kw), (sh, sw), (ph, pw) = _pair(k), _pair(s), _pair(p)
    rng = np.random.default_rng(N * C + H)
    shape = (N, H, W, C) if fmt == "NHWC" else (N, C, H, W)
    x = rng.normal(0, 1, shape) if relu else rng.integers(-4, 5, shape)
    x = torch.from_numpy(np.maximum(x, 0) if relu else x).to(cuda, dtype)
    if wide:
        step = -(-2 ** 31 // (N - 1))
        buf = torch.empty(step * (N - 1) + x[0].numel(), dtype=dtype,
                          device=cuda)
        x = buf.as_strided(shape, (step,) + x.stride()[1:]).copy_(x)
    if fmt == "NHWC":
        x = x.permute(0, 3, 1, 2)
    pads = nn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph, ceil_mode=ceil)._pads(
        (H, W))
    y = maxpool.maxpool2d(x, (kh, kw), (sh, sw), pads)
    g = torch.from_numpy(rng.normal(0, 1, tuple(y.shape))).to(cuda, dtype)
    if g_channels_last:
        g = g.contiguous(memory_format=torch.channels_last)
    return x, y, g, (kh, kw), (sh, sw), pads


@pytest.mark.parametrize("relu", [False, True], ids=["ints", "relu"])
@pytest.mark.parametrize("case", POOLS, ids=_pool_id)
def test_maxpool_bwd_kernel_matches_plain(cuda, case, relu):
    x, y, g, k, s, pads = _pool_operands(case, relu, cuda)
    before = maxpool.launches
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.launches == before + 1
    # g is contiguous NCHW here, so no case has every tensor channels-last
    assert maxpool.last_variant[0] == "two_pass"
    assert got.stride() == x.stride()
    assert torch.equal(got, want)


# NHWC cases whose four tensors split into 16-byte channel vectors: the
# ResNet-50 stem's geometry at batch 8, a ragged last channel slice (C=160
# bf16: 20 vectors, 16 a block), a 5x3 window with unequal pads, a 1x1/2
# window that leaves positions uncovered, a ceil-mode odd size, a 3x3/1
# window (10 covering windows a tile side)
TILED_POOLS = [((8, 64, 112, 112), 3, 2, 1, False, "NHWC"),
               ((2, 160, 14, 14), 3, 2, 1, False, "NHWC"),
               ((2, 16, 29, 30), (5, 3), 2, (2, 1), False, "NHWC"),
               ((2, 16, 28, 28), 1, 2, 0, False, "NHWC"),
               ((2, 8, 27, 27), 3, 2, 0, True, "NHWC"),
               ((2, 32, 14, 14), 3, 1, 1, False, "NHWC")]


@pytest.mark.parametrize("relu", [False, True], ids=["ints", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", TILED_POOLS, ids=lambda c: _pool_id(
    c + (torch.float32,))[:-8])
def test_maxpool_bwd_tiled_variant_matches_plain(cuda, case, dtype, relu):
    """The tiled_nhwc variant, bitwise against the plain version; the
    "ints" inputs (values in [-4, 4]) put exact ties in most windows."""
    x, y, g, k, s, pads = _pool_operands(case + (dtype,), relu, cuda,
                                         g_channels_last=True)
    before = maxpool.variant_launches["tiled_nhwc"]
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.last_variant[0] == "tiled_nhwc"
    assert maxpool.variant_launches["tiled_nhwc"] == before + 1
    assert got.stride() == x.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    ((4, 64, 32, 32), 3, 2, 1, False, "NCHW", torch.float32),
    ((2, 3, 33, 33), 3, 2, 1, False, "NHWC", torch.float32),
    ((2, 20, 16, 16), 3, 2, 1, False, "NHWC", torch.bfloat16),
    ((2, 8, 64, 64), 16, 8, 0, False, "NHWC", torch.float32)],
    ids=_pool_id)
def test_maxpool_bwd_generic_cases_take_two_pass(cuda, case):
    """NCHW, a ragged channel row (C=3 f32, C=20 bf16: no whole 16-byte
    vectors) and a 256-position window go to two_pass even with g
    channels-last, bitwise all the same."""
    x, y, g, k, s, pads = _pool_operands(case, False, cuda,
                                         g_channels_last=case[5] == "NHWC")
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.last_variant[0] == "two_pass"
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    ((2, 16, 28, 28), 3, 2, 1, False, "NHWC", torch.bfloat16),
    ((2, 16, 28, 28), (5, 3), 2, (2, 1), False, "NHWC", torch.bfloat16)],
    ids=_pool_id)
def test_maxpool_bwd_kernel_64bit_indices(cuda, case):
    """A view whose storage spans 2^31 elements or more takes the kernel's
    64-bit index arithmetic, at the stem's window and at the loops'."""
    x, y, g, k, s, pads = _pool_operands(case, False, cuda, wide=True)
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert x.stride()[0] >= 2 ** 31
    assert torch.equal(got, want)


def test_maxpool_bwd_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 6, 6, device=cuda)
    y = torch.zeros(1, 2, 3, 3, device=cuda)
    with pytest.raises(TypeError, match="f32 or bf16"):
        maxpool.launch(x.double(), y.double(), y.double(), (2, 2), (2, 2),
                       ((0, 0), (0, 0)))
    with pytest.raises(TypeError, match="is torch.float32 on cpu"):
        maxpool.launch(x, y.cpu(), y, (2, 2), (2, 2), ((0, 0), (0, 0)))
    with pytest.raises(ValueError, match="expected"):
        maxpool.launch(x, y[:, :1], y[:, :1], (2, 2), (2, 2),
                       ((0, 0), (0, 0)))


def _tiny_resnet():
    fmt = "NHWC"
    return (nn.Sequential()
            .add(tresnet._conv_bn(3, 16, 3, 1, 1, "stem", fmt))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt))
            .add(tresnet.bottleneck(16, 8, 1, fmt))
            .add(tresnet.bottleneck(32, 8, 2, fmt))
            .add(nn.SpatialAveragePooling(8, 8, 8, 8, format=fmt))
            .add(nn.Reshape((32,)))
            .add(nn.Linear(32, 10))
            .add(nn.LogSoftMax()))


def test_resnet_training_on_card_matches_cpu(cuda):
    """A small NHWC ResNet (the stem max pool through B1) trained for two
    K=2 blocks with the recipe's SGD on the card against the CPU in f32;
    then in bf16 compute on the card: finite losses, one B1 launch a
    step."""
    rng = np.random.default_rng(0)
    samples = [Sample(rng.normal(0, 1, (32, 32, 3)).astype(np.float32),
                      np.int32(i % 10)) for i in range(16)]
    steps = 4

    def run(dev, compute=None):
        model = _tiny_resnet().initialize(0)
        opt = (optim.LocalOptimizer(
            model, DataSet.array(samples) >> SampleToMiniBatch(4),
            nn.ClassNLLCriterion(), device=dev)
            .set_optim_method(optim.SGD(learning_rate=0.05, momentum=0.9,
                                        dampening=0.0, weight_decay=1e-4))
            .set_compute_dtype(compute)
            .set_steps_per_dispatch(2)
            .set_end_when(optim.max_iteration(steps)))
        losses = []
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        maxpool.launches = 0
        opt.optimize()
        return losses, model, maxpool.launches

    lc, mc, nc = run("cpu")
    lg, mg, ng = run(cuda)
    assert (nc, ng) == (0, steps)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for (k, a), (_, b) in zip(mg.state_dict().items(),
                              mc.state_dict().items()):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-4 * b.abs().max().item(),
                                       err_msg=k)
    lb, _, nb = run(cuda, torch.bfloat16)
    assert nb == steps and np.all(np.isfinite(lb))


# -------------------------------------------------------- embedding bag B3
# (name, N, V, D, nnz, table dtype, values dtype): the census wide path
# (8 ids a sample), D 16, 128 and a ragged 129, bf16 tables with bf16 and
# f32 values, a single row
BAGS = [("census", 8192, 100_000, 1, 65_536, "float32", "float32"),
        ("d16", 512, 1000, 16, 4096, "float32", "float32"),
        ("d128", 256, 500, 128, 2048, "float32", "float32"),
        ("d129", 100, 300, 129, 800, "float32", "float32"),
        ("bf16", 300, 2000, 16, 2400, "bfloat16", "bfloat16"),
        ("bf16_table", 300, 2000, 16, 2400, "bfloat16", "float32"),
        ("single_row", 1, 50, 8, 20, "float32", "float32"),
        ("one_key", 512, 1000, 1, 4096, "float32", "float32")]


def _bag_operands(case, device, seed=9):
    """Unsorted rows with duplicates, a tenth of the rows left empty, and
    a padding tail of (0, 0, 0.0) entries; for ``one_key`` every row 0 and
    every col one value."""
    name, N, V, D, nnz, tdtype, vdtype = case
    rng = np.random.default_rng(seed + N + D)
    live = np.arange(N) if N == 1 else np.arange(N)[rng.random(N) > 0.1]
    pad = nnz // 16
    rows = np.concatenate([rng.choice(live, nnz - pad),
                           np.zeros(pad, np.int64)]).astype(np.int32)
    cols = np.concatenate([rng.integers(0, V, nnz - pad),
                           np.zeros(pad, np.int64)]).astype(np.int32)
    if name == "one_key":
        rows[:] = 0
        cols[:] = V // 3
    vals = np.concatenate([rng.normal(0, 1, nnz - pad),
                           np.zeros(pad)]).astype(np.float32)
    table = rng.normal(0, 1, (V, D)).astype(np.float32)
    g = rng.normal(0, 1, (N, D)).astype(np.float32)
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(cols).to(device),
            torch.from_numpy(vals).to(device, getattr(torch, vdtype)),
            torch.from_numpy(table).to(device, getattr(torch, tdtype)),
            torch.from_numpy(g).to(device), N)


@pytest.mark.parametrize("case", BAGS, ids=lambda c: c[0])
def test_embed_bag_kernel_matches_plain(cuda, case):
    """Forward and the swapped-role weight gradient, bitwise."""
    rows, cols, vals, table, g, N = _bag_operands(case, cuda)
    before = embed_bag.launches
    got = embed_bag.launch(rows, cols, vals, table, N)
    d_table = embed_bag.launch(cols, rows, vals, g, table.shape[0])
    want = embed_bag.embedding_bag_coo_reference(rows, cols, vals, table, N)
    want_dt = embed_bag.embedding_bag_coo_reference(cols, rows, vals, g,
                                                    table.shape[0])
    torch.cuda.synchronize()
    assert embed_bag.launches == before + 2
    assert got.dtype == want.dtype == torch.result_type(table, vals)
    assert torch.equal(got, want)
    assert torch.equal(d_table, want_dt)


def _check_grouping(keys, n_keys):
    """offsets in full and perm over the bounds equal row_index's; keys
    below 0 before them and at or above n_keys after, each in nnz order."""
    perm, offsets = embed_bag.group_index(keys, n_keys)
    want_perm, want_offsets = embed_bag.row_index(keys, n_keys)
    torch.cuda.synchronize()
    dtype = embed_bag.group_plan(keys.numel(), n_keys).index_dtype
    assert perm.dtype == offsets.dtype == dtype
    assert torch.equal(offsets.long(), want_offsets)
    lo, hi = int(want_offsets[0]), int(want_offsets[-1])
    k = keys.long()
    assert torch.equal(perm[lo:hi].long(), want_perm[lo:hi])
    assert torch.equal(perm[:lo].long(), torch.nonzero(k < 0).flatten())
    assert torch.equal(perm[hi:].long(),
                       torch.nonzero(k >= n_keys).flatten())


@pytest.mark.parametrize("case", BAGS, ids=lambda c: c[0])
def test_embed_bag_grouping_matches_row_index(cuda, case):
    """The hand-written passes' (perm, offsets) equal the library's stable
    sort and searchsorted, in both roles (rows into N, cols into V)."""
    rows, cols, _, table, _, N = _bag_operands(case, cuda)
    _check_grouping(rows, N)
    _check_grouping(cols, table.shape[0])


# (nnz, n_keys, low, high): keys uniform in [low, high), with int32's
# extremes at the head where they lie in range: keys below 0 and at or
# above n_keys, all below, all above, an empty stream, chunks of several
# tiles (above 1024 x 128 entries), one key, and a key range that takes
# several windows of the fine pass (2^20 keys: 4096 a bucket)
GROUP_EDGES = [(65_536, 8192, -3000, 11_192), (65_536, 100_000, -5000,
                                                105_000),
               (4096, 1000, -2 ** 31, 0), (4096, 1000, 1000, 2 ** 31),
               (0, 1000, 0, 1000), (400_000, 5000, -10, 5010),
               (20_000, 7, 3, 4), (65_536, 2 ** 20, -100, 2 ** 20 + 100)]


@pytest.mark.parametrize("edge", GROUP_EDGES, ids=lambda e: "_".join(
    map(str, e[:2])))
def test_embed_bag_grouping_outside_keys(cuda, edge):
    """Keys outside [0, n_keys) fall outside every bound, as with
    row_index, and sort to either end in nnz order; bookkeeping only (the
    bag walk would index out of range)."""
    nnz, n_keys, low, high = edge
    rng = np.random.default_rng(nnz + n_keys)
    keys = rng.integers(low, high, nnz)
    keys[:2] = np.clip([-2 ** 31, 2 ** 31 - 1], low, high - 1)[:nnz]
    _check_grouping(torch.from_numpy(keys.astype(np.int32)).to(cuda), n_keys)


def test_embed_bag_kernel_64bit_offsets(cuda):
    """A table of V * D >= 2^31 elements takes the kernel's 64-bit index
    arithmetic."""
    V, D, N, nnz = 2 ** 24 + 1, 128, 64, 512
    table = torch.empty((V, D), dtype=torch.bfloat16, device=cuda).normal_()
    rng = np.random.default_rng(4)
    cols = rng.integers(V - 4096, V, nnz).astype(np.int32)
    cols[:8] = V - 1
    rows = torch.from_numpy(rng.integers(0, N, nnz).astype(np.int32)).to(cuda)
    cols = torch.from_numpy(cols).to(cuda)
    vals = torch.from_numpy(rng.normal(0, 1, nnz).astype(np.float32)).to(
        cuda, torch.bfloat16)
    got = embed_bag.launch(rows, cols, vals, table, N)
    want = embed_bag.embedding_bag_coo_reference(rows, cols, vals, table, N)
    torch.cuda.synchronize()
    assert V * D >= 2 ** 31 and torch.equal(got, want)


def test_embed_bag_autograd_on_card_matches_cpu(cuda):
    """``embedding_bag_coo`` on the card: two launches (forward, and the
    table's gradient), both gradients equal to the CPU's bitwise (D = 1:
    d_values is one product per entry)."""
    rows, cols, vals, table, g, N = _bag_operands(BAGS[0], "cpu")
    out = {}
    for dev in ("cpu", cuda):
        v = vals.to(dev, copy=True).requires_grad_(True)
        t = table.to(dev, copy=True).requires_grad_(True)
        before = embed_bag.launches
        y = embed_bag.embedding_bag_coo(rows.to(dev), cols.to(dev), v, t, N)
        y.backward(g.to(dev))
        out[str(dev)] = (y.cpu(), v.grad.cpu(), t.grad.cpu(),
                         embed_bag.launches - before)
    (y0, dv0, dt0, n0), (y1, dv1, dt1, n1) = out["cpu"], out[str(cuda)]
    assert (n0, n1) == (0, 2)
    assert torch.equal(y0, y1) and torch.equal(dt0, dt1)
    assert torch.equal(dv0, dv1)


def test_embed_bag_kernel_refuses_what_it_does_not_take(cuda):
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    vals = torch.ones(4, device=cuda)
    table = torch.ones(10, 3, device=cuda)
    with pytest.raises(RuntimeError, match="is on cpu"):
        embed_bag.launch(rows.cpu(), rows, vals, table, 2)
    with pytest.raises(TypeError, match="int32"):
        embed_bag.launch(rows.long(), rows, vals, table, 2)
    with pytest.raises(TypeError, match="f32 or bf16"):
        embed_bag.launch(rows, rows, vals, table.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        embed_bag.launch(rows, rows, vals, table.T, 2)
    with pytest.raises(ValueError, match="one length"):
        embed_bag.launch(rows, rows[:3], vals, table, 2)
    with pytest.raises(ValueError, match="one length"):
        embed_bag.launch(rows, rows, torch.ones(8, device=cuda)[::2], table,
                         2)


def test_wide_deep_training_on_card_matches_cpu(cuda):
    """A small Wide&Deep trained for a K=4 block on batch-COO input, on the
    card (B3, two launches a step) and on the CPU from the same weights:
    losses ``rtol=1e-4``, parameters within ``1e-4`` of each array's
    largest value (Adam over 4 steps)."""
    rng = np.random.default_rng(0)
    samples = [SparseSample(rng.choice(300, 3, replace=False), np.ones(3),
                            300, dense=[rng.integers(0, 20, 2).astype(
                                np.int32), rng.normal(0, 1, 5).astype(
                                np.float32)], label=np.float32(i % 2))
               for i in range(64)]

    class ToCOO(Transformer):
        def __call__(self, it):
            buf = []
            for s in it:
                buf.append(s)
                if len(buf) == 16:
                    yield batch_sparse_samples(buf, [64])
                    buf = []

    class Squeezed(nn.BCECriterion):
        def apply(self, out, y):
            return super().apply(out[:, 0], y)

    def run(dev):
        model = WideAndDeep(300, [20, 20], 5, 8, (16, 8)).initialize(0)
        opt = (optim.LocalOptimizer(model, DataSet.array(samples) >> ToCOO(),
                                    Squeezed(), device=dev)
               .set_optim_method(optim.Adam(learning_rate=0.01))
               .set_steps_per_dispatch(4)
               .set_end_when(optim.max_iteration(4)))
        losses = []
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        embed_bag.launches = 0
        opt.optimize()
        return losses, model, embed_bag.launches

    lc, mc, nc = run("cpu")
    lg, mg, ng = run(cuda)
    assert (nc, ng) == (0, 8)
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for (k, a), (_, b) in zip(mg.state_dict().items(),
                              mc.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item(),
                                   err_msg=k)


# LeNet-5's two pools (2x2/2, NCHW f32, tanh outputs) at batch 128
LENET_POOLS = [((128, 6, 24, 24), 2, 2, 0, False, "NCHW", torch.float32),
               ((128, 12, 8, 8), 2, 2, 0, False, "NCHW", torch.float32)]


@pytest.mark.parametrize("relu", [False, True], ids=["ints", "relu"])
@pytest.mark.parametrize("case", LENET_POOLS, ids=_pool_id)
def test_maxpool_bwd_lenet_geometries_take_two_pass(cuda, case, relu):
    x, y, g, k, s, pads = _pool_operands(case, relu, cuda)
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.last_variant[0] == "two_pass"
    assert torch.equal(got, want)


def test_lenet_block_on_card_matches_cpu(cuda, tmp_path):
    """LeNet-5 trained for a K=4 block on synthetic MNIST, on the card (B1,
    two launches a step) and on the CPU from the same weights, with
    validation and a snapshot at the block's end: losses ``rtol=1e-4``,
    parameters within ``1e-4`` of each array's largest value, the same
    Top-1 count, and the card's snapshot resumes on the CPU."""
    from bigdl_tpu_torch.dataset import image, mnist
    from bigdl_tpu_torch.models import lenet5

    imgs, labels = mnist.synthetic_mnist(256, seed=0)
    vimgs, vlabels = mnist.synthetic_mnist(72, seed=99)

    def grey(i, l):
        return (DataSet.array(mnist.to_samples(i, l)) >> image.BytesToGreyImg()
                >> image.GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD))

    def run(dev, ckpt):
        model = lenet5(10).initialize(0)
        scores = []
        opt = (optim.LocalOptimizer(model, grey(imgs, labels)
                                    >> SampleToMiniBatch(64),
                                    nn.ClassNLLCriterion(), device=dev)
               .set_optim_method(optim.SGD(0.05, momentum=0.9))
               .set_steps_per_dispatch(4)
               .set_end_when(optim.max_iteration(4))
               .set_validation(optim.every_epoch(), grey(vimgs, vlabels),
                               [optim.Top1Accuracy()], batch_size=32)
               .set_checkpoint(str(ckpt), optim.every_epoch()))
        losses = []
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        maxpool.reset_counts()
        opt.optimize()
        scores.append(opt.state["score"])
        return losses, model, maxpool.launches, scores

    lc, mc, nc, sc = run("cpu", tmp_path / "cpu")
    lg, mg, ng, sg = run(cuda, tmp_path / "card")
    assert (nc, ng) == (0, 8)
    assert maxpool.variant_launches["two_pass"] == 8
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for (k, a), (_, b) in zip(mg.state_dict().items(),
                              mc.state_dict().items()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item(),
                                   err_msg=k)
    assert sg == sc
    resumed = (optim.LocalOptimizer(lenet5(10), grey(imgs, labels)
                                    >> SampleToMiniBatch(64),
                                    nn.ClassNLLCriterion(), device="cpu")
               .set_optim_method(optim.SGD(0.05, momentum=0.9))
               .set_checkpoint(str(tmp_path / "card"), optim.every_epoch()))
    assert resumed.resume() and resumed.state["neval"] == 4
    for (k, a), (_, b) in zip(resumed.model.state_dict().items(),
                              mg.state_dict().items()):
        assert torch.equal(a, b), k


def test_stochastic_round_on_card_matches_cpu(cuda):
    """The unbiased bf16 round is bitwise the same on the card and on the
    CPU, given the same noise words."""
    from bigdl_tpu_torch.utils.precision import stochastic_round_bits
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1 << 16, generator=gen) * 10.0 ** torch.randint(
        -20, 20, (1 << 16,), generator=gen)
    noise = torch.randint(-2 ** 31, 2 ** 31 - 1, x.shape, dtype=torch.int32,
                          generator=gen)
    want = stochastic_round_bits(x, torch.bfloat16, noise)
    got = stochastic_round_bits(x.to(cuda), torch.bfloat16, noise.to(cuda))
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


# the bf16 wire's f32 masters against the f32 weights, the worst leaf's
# ||w_bf16 - w_f32|| / ||w_f32 - w_0|| (tests/test_torch_distri.py)
WIRE_DRIFT_LIMIT = 0.1


def test_distri_world1_on_card_equals_local_optimizer(cuda):
    """LeNet-5 through DistriOptimizer at world 1 over NCCL (the f32 and
    bf16 wires) against LocalOptimizer on the card, under the deterministic
    algorithms: the f32 wire gives the same losses and weights bit for
    bit; the bf16 wire's losses stay within ``rtol=0.05, atol=0.02`` of
    them (the reference's limit for its wire) and its f32 masters within
    ``WIRE_DRIFT_LIMIT`` of its weights, which a planted wire that never
    updates the weights exceeds."""
    import torch.distributed as dist
    from bigdl_tpu_torch.dataset import image, mnist
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models import lenet5
    from bigdl_tpu_torch.parallel import grad_sync
    from torch_distri_worker import planted_fault, wire_drift

    imgs, labels = mnist.synthetic_mnist(256, seed=0)

    def run(cls, **kw):
        model = lenet5(10).initialize(0)
        opt = (cls(model, DataSet.array(mnist.to_samples(imgs, labels))
                   >> image.BytesToGreyImg()
                   >> image.GreyImgNormalizer(mnist.TRAIN_MEAN,
                                              mnist.TRAIN_STD)
                   >> SampleToMiniBatch(64), nn.ClassNLLCriterion(),
                   device=cuda, **kw)
               .set_optim_method(optim.SGD(0.05, momentum=0.9))
               .set_steps_per_dispatch(4)
               .set_end_when(optim.max_iteration(8)))
        losses = []
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        opt.optimize()
        return losses, model, opt

    def masters(opt):
        return {n: v.cpu().numpy() for n, v in zip(
            opt._gs_names, grad_sync.unflatten_from_buckets(
                opt._gs_plan, opt._final_opt_state["master"]))}

    init = {n: v.detach().numpy().copy()
            for n, v in lenet5(10).initialize(0).named_parameters()}
    torch.use_deterministic_algorithms(True)
    try:
        ll, ml, _ = run(optim.LocalOptimizer)
        ld, md, od = run(optim.DistriOptimizer, grad_bucket_bytes=1 << 14)
        lb, _, ob = run(optim.DistriOptimizer, grad_wire_dtype="bf16")
        with planted_fault("no_update"):
            _, _, of = run(optim.DistriOptimizer, grad_wire_dtype="bf16")
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
        Engine.set_mesh(None)
    assert od.mesh.backend == "nccl" and od._world == 1
    assert od._gs_plan.num_buckets > 1
    assert ld == ll
    for a, b in zip(md.parameters(), ml.parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(lb, ll, rtol=0.05, atol=0.02)
    assert ob._final_opt_state["master"][0].dtype == torch.float32
    want = {n: v.detach().cpu().numpy() for n, v in ml.named_parameters()}
    assert wire_drift(masters(ob), want, init) <= WIRE_DRIFT_LIMIT
    assert wire_drift(masters(of), want, init) > WIRE_DRIFT_LIMIT


# B1 at the CIFAR and Inception paths' geometries, small batches: VGG's
# 2x2/2 (NCHW f32), Inception's 3x3/2 ceil-mode stem pool and a 3x3/1 pad 1
# tower pool (NHWC bf16 with g channels-last, as the training path hands
# them over: tiled_nhwc), and the tower pool in the check's NCHW f32
NEW_PATH_POOLS = [
    (((8, 64, 32, 32), 2, 2, 0, False, "NCHW", torch.float32), "two_pass"),
    (((4, 64, 112, 112), 3, 2, 0, True, "NHWC", torch.bfloat16),
     "tiled_nhwc"),
    (((4, 480, 14, 14), 3, 1, 1, False, "NHWC", torch.bfloat16),
     "tiled_nhwc"),
    (((2, 192, 28, 28), 3, 1, 1, False, "NCHW", torch.float32), "two_pass")]


@pytest.mark.parametrize("relu", [False, True], ids=["ints", "relu"])
@pytest.mark.parametrize("case,variant", NEW_PATH_POOLS,
                         ids=lambda c: _pool_id(c) if isinstance(c, tuple)
                         else c)
def test_maxpool_bwd_vgg_inception_geometries(cuda, case, variant, relu):
    x, y, g, k, s, pads = _pool_operands(case, relu, cuda,
                                         g_channels_last=case[5] == "NHWC")
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.last_variant[0] == variant
    assert torch.equal(got, want)


def _one_step(model, samples, batch, dev, sgd, compute=None):
    """One LocalOptimizer step of ``model`` (in place): (loss, B1 variant
    launches)."""
    opt = (optim.LocalOptimizer(model, DataSet.array(samples)
                                >> SampleToMiniBatch(batch),
                                nn.ClassNLLCriterion(), device=dev)
           .set_optim_method(sgd).set_compute_dtype(compute)
           .set_steps_per_dispatch(1).set_end_when(optim.max_iteration(1)))
    losses = []
    opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
    maxpool.reset_counts()
    opt.optimize()
    return losses[0], dict(maxpool.variant_launches)


def _update_share(card, cpu, init):
    """||w_card - w_cpu|| / ||w_cpu - w_0|| over all parameters: the share
    of the step's change the two devices disagree on."""
    d = c = 0.0
    for (k, a), (_, b) in zip(card.named_parameters(),
                              cpu.named_parameters()):
        a, b = a.detach().double(), b.detach().double()
        d += float(((a - b) ** 2).sum())
        c += float(((b - init[k]) ** 2).sum())
    return (d / c) ** 0.5


def _no_dropout(model):
    # its mask comes from the device's generator: the CPU cannot redraw it
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def test_vgg_step_on_card_matches_cpu(cuda):
    """One step of VGG for CIFAR-10 (the recipe's SGD, batch 8, dropout
    off) on the card, B1 five launches two_pass, against the CPU: the loss
    within ``rtol=1e-4``, the weights' step within 0.15 of its change (its
    training-mode gradients differ by percents between two sound devices:
    tests/test_torch_cifar.py)."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models import vgg_for_cifar10
    imgs, labels = cifar.synthetic_cifar(8)
    samples = [Sample(((i.astype(np.float32) - np.float32(cifar.TRAIN_MEAN))
                       / np.float32(cifar.TRAIN_STD)).transpose(2, 0, 1)
                      .copy(), l) for i, l in zip(imgs, labels)]
    init = _no_dropout(vgg_for_cifar10(10).initialize(0))
    w0 = {k: v.detach().double() for k, v in init.named_parameters()}

    def sgd():
        return optim.SGD(0.01, momentum=0.9, dampening=0.0,
                         weight_decay=5e-4,
                         learning_rate_schedule=optim.EpochStep(25, 0.5))

    import copy
    cpu, card = copy.deepcopy(init), copy.deepcopy(init)
    lc, _ = _one_step(cpu, samples, 8, "cpu", sgd())
    lg, variants = _one_step(card, samples, 8, cuda, sgd())
    assert variants == {"two_pass": 5, "tiled_nhwc": 0}
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert _update_share(card, cpu, w0) < 0.15


def test_inception_step_on_card_matches_cpu(cuda):
    """Inception v1 in NCHW f32 at batch 2, one step of the recipe's SGD
    (dropout off) on the card (B1 13 launches, two_pass) against the CPU:
    the loss within ``rtol=1e-4``, the weights' step within 0.05 of its
    change; then one NHWC bf16 step: 13 tiled_nhwc launches, a finite
    loss."""
    import copy
    from bigdl_tpu_torch.models import inception_v1
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 224, 224, 3)).astype(np.float32)

    def sgd():
        return optim.SGD(0.0898, momentum=0.9, dampening=0.0,
                         weight_decay=1e-4,
                         learning_rate_schedule=optim.Poly(0.5, 62000))

    chw = [Sample(x[i].transpose(2, 0, 1).copy(), np.int32(7 * i))
           for i in range(2)]
    init = _no_dropout(inception_v1(1000).initialize(0))
    w0 = {k: v.detach().double() for k, v in init.named_parameters()}
    cpu, card = copy.deepcopy(init), copy.deepcopy(init)
    lc, _ = _one_step(cpu, chw, 2, "cpu", sgd())
    lg, variants = _one_step(card, chw, 2, cuda, sgd())
    assert variants == {"two_pass": 13, "tiled_nhwc": 0}
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    assert _update_share(card, cpu, w0) < 0.05
    hwc = [Sample(x[i], np.int32(7 * i)) for i in range(2)]
    lb, variants = _one_step(inception_v1(1000, format="NHWC").initialize(0),
                             hwc, 2, cuda, sgd(), torch.bfloat16)
    assert variants == {"two_pass": 0, "tiled_nhwc": 13}
    assert np.isfinite(lb)

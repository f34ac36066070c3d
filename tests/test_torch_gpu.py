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
gradients differ between two sound devices by up to percents); a small
NHWC net under ``nn.Remat`` at each policy, B1 in front, bitwise equal to
no remat on the card; LBFGS's update with host syncs made errors; SGD's
bf16 velocity storing the CPU's bits; one step of PTB-small through the
text pipeline and of the text CNN against the CPU (the loss within
``rtol=1e-5``, each gradient within 1e-4 of its array's largest); the
memory watermark against the allocator's counters, a poisoned staged
block written on the card with no copy to the host, a profiler
window holding another thread's kernels; a quantized LeNet served from a
``.bigdl`` file bitwise to the in-memory quantized deploy, and a
hand-built TF while loop on the card bitwise to the CPU; a
``ReplicaSet`` of two quantized replicas on ``cuda:0`` through a replica
death, a small ``DecodeService`` against its CPU run (tokens equal, the
incremental decode within 1e-4 of the full-context forward) and the wire
front end's predict over both connection cores; a small
``transformer_lm(shard=True)`` placed on the model group ``[cuda:0,
cuda:0]`` against the unsharded forward on the card (1e-5 of max|logp|,
the swapped-halves fault above 1e-2), one sharded ``DecodeService`` with
its KV cache split on the heads against the unsharded service (tokens
equal), and a quantized NHWC ResNet-8 on B4 bitwise the NCHW twin's
output, transposed, in both modes; the quantized recurrent cells on B4
(one launch a step and direction, two for the GRU; no fused LSTM cell)
against the CPU, ring attention on ``[cuda:0] * 4`` against full
attention (forward and gradients within 1e-5 of the largest value) and
GPipe of four transformer blocks on ``[cuda:0] * 4`` against its
sequential oracle; B1 in f16 (the tiled cases above, LeNet's pools and
the generic cases, bitwise), the f16 forms of B2f, B2b, B3 and B4 (f16
among the dtypes of their kernel tests above) and an f16 run through each
of them from its public entry point against the CPU, the detection heads (each decode within
1e-5 of its largest coordinate, each selection on the card's decoded
boxes bitwise the CPU's, RoI pooling bitwise), ``BinaryTreeLSTM`` forward
and gradients within 1e-5 of the largest value, and a ``While`` trained
through a body that diverges after its exit with finite gradients.  Every
test
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
ulp (``rtol=atol=8e-3``), f16 within one f16 ulp (``1e-3``).  Training on the card against the CPU: losses
``rtol=1e-4``, parameters ``1e-4`` of each array's largest value.  The
max-pool backward is BITWISE against its plain version (the same terms
added in the same order and dtype), and so is the embedding bag, forward
and swapped-role weight gradient (the same FMAs in the same order); its
hand-written grouping passes give ``row_index``'s offsets and its ``perm``
over every bound exactly (entries outside every bound: on their side, in
nnz order).
"""

import copy

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

# (M, K, O): the stem's ragged K=147/O=64 at 1, 3 and 37 rows (the mma
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
          (12544, 256, 64),
          # the quantized Keras text classifiers' at batch 128: the LSTM's
          # and the GRU's gates and candidate over [x_t, h] (K = 100 + 128,
          # mma: not a multiple of 16), the Dense head
          (128, 228, 512), (128, 228, 256), (128, 228, 128), (128, 256, 20),
          # ragged K for the mma variants' zero fill (K of 1, 3, 17, 33 and
          # 229: to the next k16 / k32, 1-byte and 4-byte int8 rows) and M
          # across the edge of each of their tiles: 16x32 (17, 33, 65 and
          # 2113 rows; 2113 x 64 fills 34 64x64 blocks, too few) and 64x64
          # (8449 rows: 133 blocks, the last one row)
          (1, 1, 8), (17, 3, 5), (33, 17, 40), (65, 33, 100), (37, 229, 130),
          (2113, 17, 64), (8449, 229, 64),
          # K in three chunks through shared memory (512, 512, 129)
          (37, 1153, 72)]


def _variant(K, xdtype):
    """The variant the C entry point takes for contiguous operands."""
    mode = "dynamic" if xdtype == "int8" else "weight_only"
    return ("wgmma_" if K % 16 == 0 else "mma_") + mode


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


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "float16",
                                    "int8"])
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
    to the mma variant (its rows copied as one span and read in place at
    any alignment), bitwise all the same."""
    xin, wq, scale, b = _operands(37, 256, 128, "int8", True, cuda)
    buf = torch.empty(xin.numel() + 1, dtype=torch.int8, device=cuda)
    shifted = buf[1:].view(xin.shape)
    shifted.copy_(xin)
    got = int8_gemm.launch(shifted, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.last_variant[0] == "mma_dynamic"
    assert torch.equal(got, int8_matmul_reference(xin, wq, scale, b))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16", "float16"])
def test_unaligned_weight_only_base_takes_simt(cuda, xdtype):
    """weight_only activations off a 16-byte boundary go to the mma
    variant (4- or 2-byte aligned rows read in place), within the same
    tolerance."""
    xin, wq, scale, b = _operands(37, 256, 128, xdtype, True, cuda)
    buf = torch.empty(xin.numel() + 1, dtype=xin.dtype, device=cuda)
    shifted = buf[1:].view(xin.shape)
    shifted.copy_(xin)
    got = int8_gemm.launch(shifted, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.last_variant[0] == "mma_weight_only"
    want = int8_matmul_reference(xin, wq, scale, b)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


def test_kernel_refuses_what_it_does_not_take(cuda):
    xin, wq, scale, b = _operands(4, 16, 8, "float32", True, cuda)
    with pytest.raises(TypeError, match="f32, bf16, f16 or int8"):
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
# rows take the plain-load copies); (20, 200) is PTB-small's, the text path's
CELL_SHAPES = [(20, 650), (20, 200), (1, 64), (5, 130), (37, 650), (64, 650),
               (20, 333)]


@pytest.mark.parametrize("fb", [0.0, 1.0], ids=["fb0", "fb1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
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
    # JAX cell test's forward tolerance at that shape); bf16 within 8e-3,
    # f16 within 1e-3 (one ulp of each where an f32 result near a rounding
    # boundary of the type rounds the other way)
    for i, (g, w) in enumerate(zip(got + got_b, want + want_b)):
        assert g.dtype == w.dtype
        fwd = i < len(got)
        t = 8e-3 if g.dtype == torch.bfloat16 else \
            1e-3 if g.dtype == torch.float16 else \
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
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
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


def _step_grads(model, x, y, criterion, device):
    """The loss and the gradients of one step of ``model`` on ``device``."""
    net = model.to(device)
    for p in net.parameters():
        p.requires_grad_(True)
    loss = criterion.apply(net(torch.from_numpy(x).to(device)),
                           torch.from_numpy(y).to(device))
    loss.backward()
    return loss.item(), {k: p.grad.double().cpu()
                         for k, p in net.named_parameters()}


def _assert_step_close(model, x, y, criterion, cuda):
    import copy
    want_loss, want = _step_grads(copy.deepcopy(model), x, y, criterion,
                                  "cpu")
    got_loss, got = _step_grads(model, x, y, criterion, cuda)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, w in want.items():
        share = ((got[k] - w).abs().max() / w.abs().max()).item()
        assert share <= 1e-4, (k, share)


def test_ptb_small_step_on_card_matches_cpu(cuda, tmp_path):
    """One step of PTB-small (vocab 10000, 2x200 LSTM, T=20, batch 20)
    fed by the text pipeline on a written PTB-format file: the loss within
    ``rtol=1e-5`` and each gradient within 1e-4 of its array's largest on
    the CPU; layer 0 through B2f/B2b 20 times each."""
    import chip_smoke
    from bigdl_tpu_torch.dataset import text
    path = tmp_path / "ptb.txt"
    chip_smoke.write_ptb_file(path, 0)
    words = text.read_ptb_words(path)
    d = text.Dictionary([words], vocab_size=10000)
    x, y = text.ptb_batches(d.encode(words), 20)
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    _assert_step_close(ptb_model(10000, 200, 200).initialize(0), x[:20],
                       y[:20], nn.TimeDistributedCriterion(
                           nn.ClassNLLCriterion(), size_average=True), cuda)
    assert lstm_cell.fwd_launches == lstm_cell.bwd_launches == 20


def test_text_cnn_step_on_card_matches_cpu(cuda):
    """One step of examples/textclassification/train.py's text CNN at its
    defaults (sequence 12, embedding 32, batch 32), card against CPU."""
    import chip_smoke
    samples, V = chip_smoke.text_cnn_samples(*chip_smoke.text_cnn_corpus(),
                                             seq_len=12)
    x = np.stack([s.feature for s in samples[:32]])
    y = np.stack([s.label for s in samples[:32]])
    _assert_step_close(chip_smoke.text_cnn(V, 32).initialize(0), x, y,
                       nn.ClassNLLCriterion(), cuda)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
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
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
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
# (8 ids a sample), D 16, 128 and a ragged 129, bf16 and f16 tables with
# values of their type and f32 values, a single row
BAGS = [("census", 8192, 100_000, 1, 65_536, "float32", "float32"),
        ("d16", 512, 1000, 16, 4096, "float32", "float32"),
        ("d128", 256, 500, 128, 2048, "float32", "float32"),
        ("d129", 100, 300, 129, 800, "float32", "float32"),
        ("bf16", 300, 2000, 16, 2400, "bfloat16", "bfloat16"),
        ("bf16_table", 300, 2000, 16, 2400, "bfloat16", "float32"),
        ("f16", 300, 2000, 16, 2400, "float16", "float16"),
        ("f16_table", 300, 2000, 16, 2400, "float16", "float32"),
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
    with pytest.raises(TypeError, match="f32, bf16 or f16"):
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


# ------------------------------------------------ remat, optim methods
def _remat_net(remat, fmt="NHWC"):
    """A conv, B1's stem-like pool and two bottlenecks, each with a
    dropout, in ``nn.Remat(policy=remat)`` unless ``remat == "off"``."""
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1, format=fmt))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt))
    for _ in range(2):
        b = tresnet.bottleneck(16, 4, 1, fmt).add(nn.Dropout(0.5))
        m.add(b if remat == "off" else nn.Remat(b, policy=remat))
    return m


@pytest.mark.parametrize("policy", [None, "tails", "dots"])
def test_remat_on_card_is_bitwise_no_remat(cuda, policy):
    """Recomputed on the card, B1 in front: outputs, gradients and BN
    statistics bitwise, the dropout mask drawn once."""
    start = _remat_net("off").initialize(0).state_dict()
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    got = []
    torch.use_deterministic_algorithms(True)
    try:
        for mode in ("off", policy):
            m = _remat_net(mode)
            m.load_state_dict(start)
            m = m.cuda().train()
            for d in (d for d in nn.module.walk(m)
                      if isinstance(d, nn.Dropout)):
                d.generator = torch.Generator(device="cuda").manual_seed(3)
            for p in m.parameters():
                p.requires_grad_(True)
            maxpool.reset_counts()
            y = m(x.cuda())
            y.square().sum().backward()
            assert maxpool.launches == 1
            got.append((y.detach(), [p.grad for p in m.parameters()],
                        [b.clone() for b in m.buffers()]))
    finally:
        torch.use_deterministic_algorithms(False)
    (ya, ga, sa), (yb, gb, sb) = got
    assert torch.equal(ya, yb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))


def test_lbfgs_update_on_card_syncs_nothing(cuda):
    m = optim.LBFGS(0.1, history=3)
    p = {"w": torch.ones(64, device="cuda"), "b": torch.zeros(8,
                                                            device="cuda")}
    st = m.init_state(p)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for step in range(5):
            m.update({k: (v - 0.5) * 0.1 for k, v in p.items()}, p, st, 0.1,
                     step)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(st["count"]) == 5 and int(st["pairs"]) > 0


def test_bf16_velocity_on_card_matches_cpu(cuda):
    """The velocity's rounding noise is a hash of each value: the card
    stores the CPU's bits."""
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(4096, generator=g)
    grads = [torch.randn(4096, generator=g) for _ in range(5)]
    out = []
    for dev in ("cpu", "cuda"):
        m = optim.SGD(0.1, momentum=0.9, state_dtype=torch.bfloat16)
        p = {"w": p0.clone().to(dev)}
        st = m.init_state(p)
        for step, gr in enumerate(grads):
            m.update({"w": gr.to(dev)}, p, st, 0.1, step)
        out.append((p["w"].cpu(), st["velocity"]["w"].cpu()))
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0], out[1][0])


# ------------------------------------------------- the telemetry plane
def test_memory_watermark_gauges_are_the_allocators(cuda):
    from bigdl_tpu_torch.telemetry import MemoryWatermark, MetricRegistry
    keep = torch.empty(1 << 20, device=cuda)  # noqa: F841 - allocated
    reg = MetricRegistry()
    got = MemoryWatermark(reg, cuda).observe()
    raw = torch.cuda.memory_stats(cuda)
    assert got == {"bytes_in_use": raw["allocated_bytes.all.current"],
                   "peak_bytes_in_use": raw["allocated_bytes.all.peak"],
                   "bytes_limit": torch.cuda.mem_get_info(cuda)[1]}
    assert reg.gauges()["device/bytes_in_use"] == got["bytes_in_use"]


def test_corrupt_staged_on_the_card_copies_nothing_to_the_host(cuda):
    from bigdl_tpu_torch.dataset.prefetch import DeviceBlockStager
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    from bigdl_tpu_torch.resilience import FaultInjector
    batches = iter([MiniBatch(np.ones((4, 8), np.float32),
                              np.zeros(4, np.int64)) for _ in range(3)])
    staged = DeviceBlockStager(batches, cuda).take(3, 100)
    staged.wait()
    inj = FaultInjector("corrupt_batch@at=1;nonfinite_grads@at=2")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        inj.corrupt_staged(staged.xs, 0, 3)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not any("DtoH" in n or "Memcpy" in n for n in names), names
    x = staged.xs.cpu()
    assert torch.isfinite(x[0]).all() and torch.isnan(x[1]).all()
    assert torch.isinf(x[2]).all()


def test_profile_window_holds_a_kernel(cuda, tmp_path):
    """As the admin plane takes it: the window on another thread, the
    kernels launched by the training thread."""
    import json
    import threading

    from bigdl_tpu_torch.utils.profiling import (TRACE_FILE, WINDOW_RETAKES,
                                                 profile_window)
    a = torch.randn(1024, 1024, device=cuda)
    a @ a
    torch.cuda.synchronize()
    out, stats = [], {}
    t = threading.Thread(target=lambda: out.append(
        profile_window(0.5, log_dir=str(tmp_path), stats=stats)))
    t.start()
    while t.is_alive():
        a @ a
        torch.cuda.synchronize()
    t.join()
    trace = json.load(open(tmp_path / TRACE_FILE))
    cats = {e.get("cat") for e in trace["traceEvents"]}
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    assert out == [str(tmp_path)] and kernels, cats
    assert stats["device_events"] >= len(kernels) and stats["launches"] \
        and stats["retakes"] <= WINDOW_RETAKES, stats


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantized_bigdl_file_served_on_card(cuda, mode, tmp_path):
    """A quantized LeNet read from a ``.bigdl`` file and served on the card
    is bitwise the in-memory quantized deploy of the same weights, its
    four int8 layers on B4 once a dispatch each."""
    from bigdl_tpu_torch import interop
    from bigdl_tpu_torch.models import lenet5
    model = lenet5(10).initialize(0)
    path = str(tmp_path / "q.bigdl")
    interop.save_bigdl_module(nn.quantize(model, mode=mode), path)
    x = np.random.default_rng(4).normal(0, 1, (6, 784)).astype(np.float32)
    kw = {"input_spec": ((784,), np.float32), "max_batch_size": 8}
    with ModelRegistry(device=cuda) as reg:
        svc = reg.deploy("file", path=path, format="bigdl", **kw)
        reg.deploy("mem", model, quantize=mode, **kw)
        int8_gemm.launches = 0
        got = reg.predict("file", x, timeout=120)
        assert int8_gemm.launches == 4 * svc.stats()["dispatch_count"] > 0
        want = reg.predict("mem", x, timeout=120)
    np.testing.assert_array_equal(got, want)


def test_tf_while_loop_on_card_matches_cpu(cuda, tmp_path):
    """A hand-built GraphDef with two loop variables and a nested frame
    runs on the card bitwise as on the CPU; the TensorArray RNN loop
    within 1e-5 (its products are cuBLAS's)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_tfgraph_util as tg
    from bigdl_tpu_torch.interop import load_tf_graph
    path = tmp_path / "nested.pb"
    path.write_bytes(tg.nested_loop_graph())
    m = load_tf_graph(str(path), ["acc0", "w"], ["out", "i_exit"])
    rng = np.random.default_rng(5)
    feed = {"acc0": rng.normal(size=(4, 3)).astype(np.float32),
            "w": rng.normal(size=3).astype(np.float32)}
    cpu = m({k: torch.from_numpy(v) for k, v in feed.items()})
    card = m.to(cuda)({k: torch.from_numpy(v).to(cuda)
                       for k, v in feed.items()})
    assert all(c.device.type == "cuda" for c in card)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    g, _, _ = tg.dynrnn_graph(5, 3, 4, 6, rng)
    path = tmp_path / "rnn.pb"
    path.write_bytes(g)
    rnn = load_tf_graph(str(path), ["x"], ["out"])
    x = torch.from_numpy(rng.normal(size=(5, 3, 4)).astype(np.float32))
    torch.testing.assert_close(rnn.to(cuda)(x.to(cuda)).cpu(), rnn.cpu()(x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_predictor_over_int8_model_on_card(cuda, mode):
    """``Predictor`` over a quantized LeNet: a 3-row tail padded to the
    steady 8 rows (and the 2- and 3-row probe of its row tracking), B4 4
    launches a forward, every row within the served limit of the CPU's."""
    from bigdl_tpu_torch.models import lenet5
    from bigdl_tpu_torch.optim import Predictor
    q = nn.quantize(lenet5(10).initialize(3), mode=mode)
    cpu = Predictor(q, batch_size=8, device="cpu")
    x = np.random.default_rng(6).normal(0, 1, (19, 784)).astype(np.float32)
    want = cpu.predict(x)
    forwards = []
    card_model = nn.quantize(lenet5(10).initialize(3), mode=mode)
    card_model.register_forward_pre_hook(lambda m, i: forwards.append(1))
    int8_gemm.launches = 0
    got = Predictor(card_model, batch_size=8, device=cuda).predict(x)
    assert len(forwards) == 5  # 2 full batches, the 2- and 3-row probe, tail
    assert int8_gemm.launches == 4 * len(forwards)
    tol = 1e-4 if mode == "weight_only" else 1e-3
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_keras_bidirectional_lstm_step_on_card(cuda):
    """One step of a Keras ``Bidirectional(LSTM)`` text model on the card:
    B2f and B2b 2 x T launches each (both directions), the loss within
    ``rtol=1e-5`` and each gradient within 1e-4 of its array's largest of
    the same step on the CPU."""
    from bigdl_tpu_torch import keras as K
    T, B = 12, 16
    model = K.Sequential([K.Embedding(50, 8, input_length=T),
                          K.Bidirectional(K.LSTM(32)),
                          K.Dense(5, activation="softmax")])
    init = model.core_module()
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(0, 50, (B, T)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, B))
    crit = nn.CategoricalCrossEntropy()

    def step(device):
        m = copy.deepcopy(init).to(device)
        for p in m.parameters():
            p.requires_grad_(True)
        loss = crit.apply(m(x.to(device)), y.to(device))
        loss.backward()
        return loss.item(), {k: p.grad.cpu() for k, p in
                             m.named_parameters()}

    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    loss, grads = step(cuda)
    assert lstm_cell.fwd_launches == lstm_cell.bwd_launches == 2 * T
    want_loss, want = step("cpu")
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for k, g in want.items():
        torch.testing.assert_close(grads[k], g, rtol=1e-4,
                                   atol=1e-4 * g.abs().max().item())


# --- the rest of serving: replica sets, decode, the wire front end -------
def _served_model(quantize="weight_only"):
    model = resnet_cifar(8).initialize(0)
    return model, nn.quantize(copy.deepcopy(model), mode=quantize)


def test_replica_set_of_two_on_one_card_survives_a_death(cuda):
    """Two replicas share ``cuda:0``, each with its own batcher thread;
    replica 0 dies mid-load.  Every accepted request settles with the
    CPU's rows (weight_only: 1e-4 of max|y|), the counters tell death,
    failover and revival, and every dispatch launched B4 10 times."""
    import threading
    from bigdl_tpu_torch.resilience import FaultInjector, ReplicaSet
    model, qmodel = _served_model()
    x = np.random.default_rng(3).normal(0, 1, (3, 3, 32, 32)).astype(
        np.float32)
    with torch.inference_mode():
        want = qmodel(torch.from_numpy(x)).numpy()
    rs = ReplicaSet(qmodel, n_replicas=2, devices=[torch.device("cuda", 0)],
                    input_spec=((3, 32, 32), np.float32), max_batch_size=8,
                    fault_injector=FaultInjector(
                        "replica_death@target=0,after=3,count=1"))
    outs, errs = [], []

    def client():
        for _ in range(5):
            try:
                outs.append(rs.predict(x, timeout=60))
            except Exception as e:  # noqa: BLE001 - collected and failed
                errs.append(e)

    int8_gemm.launches = 0
    threads = [threading.Thread(target=client) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        stats = rs.stats()
    finally:
        rs.stop()
    assert errs == [] and len(outs) == 20
    for got in outs:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    res = stats["resilience"]
    assert res["resilience/replica_deaths"] == 1
    assert res["resilience/revivals"] == 1
    assert res["resilience/failovers"] >= 1
    assert [r.device for r in rs._replicas] == [torch.device("cuda", 0)] * 2
    # the death strikes before the forward: a dispatch that launched
    # ran all ten GEMMs
    assert int8_gemm.launches % 10 == 0 and int8_gemm.launches >= 10


def test_decode_service_on_card_matches_cpu(cuda):
    """A small ``transformer_lm`` decoding on the card against the same
    service on the CPU: greedy tokens equal, and the card's incremental
    decode within 1e-4 of its own full-context forward at every step."""
    from bigdl_tpu_torch.models.transformer import (
        init_kv_cache, transformer_lm, transformer_lm_decode_step,
        transformer_lm_prefill)
    from bigdl_tpu_torch.serving import DecodeService
    lm = transformer_lm(128, 64, 4, 2, max_len=128).initialize(0).eval()
    prompts = [list(range(1, n + 1)) for n in (3, 9, 17, 30)]
    results = {}
    for device in ("cpu", cuda):
        with DecodeService(copy.deepcopy(lm), slots=3, max_seq_len=64,
                           max_prompt_len=32, device=device) as dec:
            futs = [dec.submit(p, max_new_tokens=12) for p in prompts]
            results[str(device)] = [list(f.result(timeout=120).tokens)
                                    for f in futs]
    assert results["cuda"] == results["cpu"]
    m = copy.deepcopy(lm).to(cuda)
    seq = torch.tensor(prompts[2] + results["cuda"][2], device=cuda)
    with torch.inference_mode():
        k, v = init_kv_cache(m, 1, 64)
        _, kp, vp = transformer_lm_prefill(m, seq[None, :17])
        k[:, :, :, :17], v[:, :, :, :17] = kp, vp
        for t in range(17, len(seq)):
            lp, k, v = transformer_lm_decode_step(
                m, seq[t:t + 1], torch.tensor([t], device=cuda), k, v)
            full = m(seq[None, :t + 1])[0, -1]
            torch.testing.assert_close(lp[0], full, rtol=0, atol=1e-4)


@pytest.mark.parametrize("core", ["eventloop", "threaded"])
def test_wire_predict_on_card(cuda, core):
    """The wire front end over a registry on the card: JSON rows within
    1e-4 of max|y| of the CPU, B4 at 10 launches a dispatch."""
    import http.client
    import json
    from bigdl_tpu_torch.frontend import FrontendServer
    model, qmodel = _served_model()
    x = np.random.default_rng(4).normal(0, 1, (2, 3, 32, 32)).astype(
        np.float32)
    with torch.inference_mode():
        want = qmodel(torch.from_numpy(x)).numpy()
    with ModelRegistry(device=cuda) as reg:
        svc = reg.deploy("r", model, input_spec=((3, 32, 32), np.float32),
                         quantize=True, max_batch_size=8)
        fe = FrontendServer(reg, port=0, core=core)
        port = fe.start()
        try:
            int8_gemm.launches = 0
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/v1/models/r/predict",
                         body=json.dumps({"inputs": x.tolist()}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            conn.close()
        finally:
            fe.stop()
        assert resp.status == 200, body
        assert int8_gemm.launches == 10 * (svc.stats()["dispatch_count"])
    got = np.asarray(body["outputs"], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_sharded_forward_on_card_matches_unsharded(cuda):
    """``transformer_lm(shard=True)`` on ``[cuda:0, cuda:0]``: the same
    log-probs as the unsharded model on the card within 1e-5 of
    max|logp|; two halves of one split weight swapped read above 1e-2."""
    from bigdl_tpu_torch.models.transformer import transformer_lm
    from bigdl_tpu_torch.parallel import create_mesh, shard_module
    lm = transformer_lm(256, 64, 4, 2, max_len=64, shard=True) \
        .initialize(0).eval()
    plain = copy.deepcopy(lm).to(cuda)
    placed = shard_module(copy.deepcopy(lm),
                          create_mesh(model=2, devices=[cuda, cuda]))
    tokens = torch.randint(0, 256, (4, 48),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = plain(tokens.to(cuda))
        got = placed(tokens.to(cuda))
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
        wq = placed[2][0][0][0][1].wq
        a = wq[0].clone()
        wq[0].copy_(wq[1])
        wq[1].copy_(a)
        assert float((placed(tokens.to(cuda)) - want).abs().max()) \
            > 1e-2 * scale


def test_sharded_decode_service_on_card(cuda):
    """``DecodeService(mesh=)`` over ``[cuda:0, cuda:0]``: the KV cache in
    two head halves on the card, the greedy tokens the unsharded
    service's on the card."""
    from bigdl_tpu_torch.models.transformer import ShardedKV, transformer_lm
    from bigdl_tpu_torch.parallel import create_mesh
    from bigdl_tpu_torch.serving import DecodeService
    lm = transformer_lm(128, 64, 4, 2, max_len=128, shard=True) \
        .initialize(0).eval()
    prompts = [list(range(1, n + 1)) for n in (3, 9, 17)]
    mesh = create_mesh(model=2, devices=[cuda, cuda])
    results = {}
    for name, kw in (("plain", {"device": cuda}), ("sharded", {"mesh": mesh})):
        with DecodeService(copy.deepcopy(lm), slots=3, max_seq_len=64,
                           max_prompt_len=32, **kw) as dec:
            futs = [dec.submit(p, max_new_tokens=10) for p in prompts]
            results[name] = [list(f.result(timeout=120).tokens)
                             for f in futs]
            if name == "sharded":
                assert isinstance(dec._k, ShardedKV)
                assert all(p.device.type == "cuda" for p in dec._k.parts)
                assert 2 * dec.kv_bytes_per_shard == dec.kv_bytes
    assert results["sharded"] == results["plain"]


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantized_nhwc_resnet_on_card_bitwise_nchw(cuda, mode):
    """A quantized NHWC ResNet-8 on the card: its convolutions run B4 on
    the same rows the NCHW twin's give it, so the outputs agree bit for
    bit, transposed; 10 GEMM launches a forward in each."""
    from bigdl_tpu_torch.interop import load_jax_params
    nhwc = resnet_cifar(8, format="NHWC").initialize(2)
    twin = load_jax_params(resnet_cifar(8), *to_jax_params(nhwc))
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    outs = {}
    for name, model, inp in (("nhwc", nhwc, x),
                             ("nchw", twin, x.permute(0, 3, 1, 2))):
        q = nn.quantize(model, mode=mode).to(cuda)
        int8_gemm.launches = 0
        with torch.inference_mode():
            outs[name] = q(inp.contiguous().to(cuda)).cpu()
        assert int8_gemm.launches == 10
    assert torch.equal(outs["nhwc"], outs["nchw"])


def _rnn_classifier():
    """A bidirectional LSTM, a GRU and an Elman layer over per-step
    inputs, the last step through a Linear: every quantized cell."""
    return (nn.Sequential().add(nn.TimeDistributed(nn.Linear(12, 20)))
            .add(nn.BiRecurrent(nn.LSTM(20, 24, forget_bias=1.0),
                                nn.LSTM(20, 24)))
            .add(nn.Recurrent(nn.GRU(48, 16)))
            .add(nn.Recurrent(nn.RnnCell(16, 16)))
            .add(nn.Select(1, -1)).add(nn.Linear(16, 5)))


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_quantized_cells_on_card_match_cpu(cuda, mode):
    """Every projection of the quantized cells is one B4 launch (T steps:
    2 T for the LSTM's two directions, 2 T for the GRU, T for the Elman
    cell, 1 for the head), the fused LSTM cell never runs; the rows
    within 1e-5 (weight_only) / 1e-3 (dynamic: a step's scale over a
    hidden state that differs by ulps can move one rounding) of max|y|
    of the CPU's."""
    T = 9
    q = nn.quantize(_rnn_classifier().initialize(1), mode=mode)
    x = torch.randn(6, T, 12, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        want = q(x)
        qc = copy.deepcopy(q).to(cuda)
        int8_gemm.launches = lstm_cell.fwd_launches = 0
        got = qc(x.to(cuda)).cpu()
    assert int8_gemm.launches == 5 * T + 1 and lstm_cell.fwd_launches == 0
    tol = 1e-5 if mode == "weight_only" else 1e-3
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_ring_attention_on_card_matches_full_attention(cuda):
    from bigdl_tpu_torch.parallel import create_mesh, ring_attention
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 4, 256, 32, generator=gen).to(cuda)
               .requires_grad_(True) for _ in range(3))
    mesh = create_mesh(seq=4, devices=[cuda] * 4)
    for causal in (False, True):
        out = ring_attention(q, k, v, mesh, causal=causal)
        g = torch.autograd.grad((out ** 2).sum(), (q, k, v))
        ref = nn.dot_product_attention(q, k, v, causal=causal)
        g_ref = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
        for a, b in [(out, ref)] + list(zip(g, g_ref)):
            assert a.device == q.device
            assert float((a - b).detach().abs().max()) \
                <= 1e-5 * float(b.detach().abs().max())


def test_gpipe_on_card_matches_apply_reference(cuda):
    from bigdl_tpu_torch.models import transformer_block
    from bigdl_tpu_torch.parallel import GPipe, create_mesh
    gp = GPipe(transformer_block(64, 4, 128), 4,
               mesh=create_mesh(pipe=4, devices=[cuda] * 4)).initialize(0)
    for p in gp.parameters():  # the port's layers start frozen
        p.requires_grad_(True)
    x = torch.randn(8, 2, 16, 64, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda)
    out = gp(x)
    grads = torch.autograd.grad(out.square().mean(), list(gp.parameters()))
    ref = gp.apply_reference(x)
    g_ref = torch.autograd.grad(ref.square().mean(), list(gp.parameters()))
    assert float((out - ref).detach().abs().max()) \
        <= 1e-5 * float(ref.detach().abs().max())
    # against the model's largest gradient: a key bias's is zero but for
    # rounding
    largest = max(float(b.abs().max()) for b in g_ref)
    for a, b in zip(grads, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * largest


@pytest.mark.parametrize("case", [
    ((128, 6, 24, 24), 2, 2, 0, False, "NCHW", torch.float16),
    ((128, 12, 8, 8), 2, 2, 0, False, "NCHW", torch.float16),
    ((2, 3, 33, 33), 3, 2, 1, False, "NHWC", torch.float16),
    ((2, 8, 64, 64), 16, 8, 0, False, "NHWC", torch.float16)],
    ids=_pool_id)
def test_maxpool_bwd_f16_two_pass_matches_plain(cuda, case):
    """f16 through two_pass: LeNet-5's two pools at batch 128, a ragged
    channel row, a 256-position window; bitwise."""
    x, y, g, k, s, pads = _pool_operands(case, False, cuda)
    got = maxpool.launch(x, y, g, k, s, pads)
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    assert maxpool.last_variant[0] == "two_pass"
    assert got.dtype == torch.float16 and torch.equal(got, want)


@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_int8_matmul_f16_rows_on_card_match_cpu(cuda, mode):
    """f16 rows through ``int8_matmul`` at the stem's K=147 (mma) and an
    aligned K (``wgmma``), and all-zero rows (an f16 scale of 0): the CPU's
    result, dynamic bitwise, weight_only within ``rtol=1e-5, atol=1e-5 *
    max|y|``."""
    for M, K, O, zero in ((37, 147, 64, False), (37, 256, 128, False),
                          (8, 256, 128, True)):
        xin, wq, scale, b = _operands(M, K, O, "float16", True, "cpu")
        if zero:
            xin.zero_()
        want = int8_gemm.int8_matmul(xin, wq, scale, b, mode=mode)
        got = int8_gemm.int8_matmul(xin.to(cuda), wq.to(cuda),
                                    scale.to(cuda), b.to(cuda), mode=mode)
        torch.cuda.synchronize()
        variant = ("wgmma_" if K % 16 == 0 else "mma_") + mode
        assert int8_gemm.last_variant[0] == variant
        if mode == "dynamic":
            assert torch.equal(got.cpu(), want)
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item())


def test_f16_ptb_step_on_card_matches_cpu(cuda):
    """One f16 step of a small PTB model through ``LocalOptimizer`` on the
    card (B2f and B2b in f16, 5 launches each) against the same step on
    the CPU: the loss within ``rtol=1e-3`` and each array's change within
    5e-2 of the CPU's change (L2; f16 results that round the other way on
    the card move the gradients by about an f16 ulp of their terms)."""
    rng = np.random.default_rng(0)
    samples = [Sample(rng.integers(0, 50, 5), rng.integers(0, 50, 5))
               for _ in range(4)]
    out = {}
    start = ptb_model(50, 8, 8, 1).initialize(0).state_dict()
    for dev in ("cpu", cuda):
        model = ptb_model(50, 8, 8, 1).initialize(0)
        losses, dtypes = [], []
        sound = lstm_cell.launch_fwd

        def launch(zx, *a):
            dtypes.append(zx.dtype)
            return sound(zx, *a)
        opt = (optim.LocalOptimizer(
            model, DataSet.array(samples) >> SampleToMiniBatch(4),
            nn.TimeDistributedCriterion(nn.ClassNLLCriterion()), device=dev)
            .set_compute_dtype(torch.float16)
            .set_end_when(optim.max_iteration(1)))
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        before = (lstm_cell.fwd_launches, lstm_cell.bwd_launches)
        lstm_cell.launch_fwd = launch
        try:
            opt.optimize()
        finally:
            lstm_cell.launch_fwd = sound
        out[str(dev)] = (losses, model.state_dict(), dtypes,
                         (lstm_cell.fwd_launches - before[0],
                          lstm_cell.bwd_launches - before[1]))
    lc, sc, dc, nc = out["cpu"]
    lg, sg, dg, ng = out[str(cuda)]
    assert nc == (0, 0) and ng == (5, 5) and set(dg) == {torch.float16}
    np.testing.assert_allclose(lg, lc, rtol=1e-3)
    for k, w0 in start.items():
        step_cpu, step_card = sc[k] - w0, sg[k].cpu() - w0
        assert float((step_card - step_cpu).norm()) <= \
            5e-2 * float(step_cpu.norm()), k


def test_embed_bag_f16_autograd_on_card_matches_cpu(cuda):
    """``embedding_bag_coo`` with an f16 table and f16 values on the card:
    the forward (f16 out) and the table's gradient (f32 cotangent, f16
    values) on B3, bitwise the CPU's."""
    rows, cols, vals, table, g, N = _bag_operands(BAGS[0], "cpu")
    vals, table = vals.half(), table.half()
    out = {}
    for dev in ("cpu", cuda):
        t = table.to(dev, copy=True).requires_grad_(True)
        before = embed_bag.launches
        y = embed_bag.embedding_bag_coo(rows.to(dev), cols.to(dev),
                                        vals.to(dev), t, N)
        y.backward(g.to(dev).half())
        out[str(dev)] = (y.cpu(), t.grad.cpu(), embed_bag.launches - before)
    (y0, dt0, n0), (y1, dt1, n1) = out["cpu"], out[str(cuda)]
    assert (n0, n1) == (0, 2) and y1.dtype == torch.float16
    assert torch.equal(y0, y1) and torch.equal(dt0, dt1)


def _share(a, b):
    return float((a.cpu() - b).abs().max() / b.abs().max())


def test_detection_heads_on_card_match_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    # SSD: a decode within rounding, the selection bitwise on its boxes
    P, C = 600, 5
    c = torch.rand(P, 2, generator=gen) * 0.8 + 0.1
    wh = torch.rand(P, 2, generator=gen) * 0.25 + 0.05
    priors = torch.stack([torch.cat([c - wh / 2, c + wh / 2], 1).reshape(-1),
                          torch.tensor([0.1, 0.1, 0.2, 0.2]).repeat(P)])[None]
    loc = torch.randn(2, P * 4, generator=gen) * 0.5
    conf = torch.softmax(torch.randn(2, P, C, generator=gen) * 2, -1)
    conf = conf.reshape(2, -1)
    det = nn.DetectionOutputSSD(C, nms_topk=40, keep_topk=30)
    boxes = det.decode(loc.to(cuda), priors.to(cuda))
    assert _share(boxes, det.decode(loc, priors)) <= 1e-5
    got = det.select(boxes, conf.to(cuda))
    want = det.select(boxes.cpu(), conf)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    # Faster R-CNN: proposals, RoI pooling, the output head
    A, H, W = 9, 12, 16
    x = (torch.rand(1, 2 * A, H, W, generator=gen),
         torch.randn(1, 4 * A, H, W, generator=gen) * 0.1,
         torch.tensor([[192.0, 256.0, 1.0, 1.0]]))
    prop = nn.Proposal(600, 50, (0.5, 1, 2), (8, 16, 32))
    xd = tuple(t.to(cuda) for t in x)
    proposals, fg = prop.decode(xd)
    assert _share(proposals, prop.decode(x)[0]) <= 1e-5
    got = prop.select(proposals, fg)
    want = prop.select(proposals.cpu(), fg.cpu())
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    rois = got[0]
    feat = torch.randn(1, 8, H, W, generator=gen)
    pool = nn.RoiPooling(7, 7, 1.0 / 16)
    assert torch.equal(pool((feat.to(cuda), rois)).cpu(),
                       pool((feat, rois.cpu())))
    head = nn.DetectionOutputFrcnn(n_classes=C, max_per_image=20)
    deltas = torch.randn(50, 4 * C, generator=gen) * 0.1
    scores = torch.softmax(torch.randn(50, C, generator=gen), -1)
    dec = head.decode(xd[2], rois, deltas.to(cuda))
    assert _share(dec, head.decode(x[2], rois.cpu(), deltas)) <= 1e-5
    got = head.select(dec, scores.to(cuda))
    want = head.select(dec.cpu(), scores)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))


def test_binary_tree_lstm_on_card_matches_cpu(cuda):
    trees = torch.tensor([[[0, 0, 1], [0, 0, 2], [0, 0, 3], [2, 3, 0],
                           [1, 4, 0], [0, 0, 0]],
                          [[0, 0, 1], [0, 0, 2], [1, 2, 0], [0, 0, 3],
                           [3, 4, 0], [0, 0, 0]]], dtype=torch.float32)
    emb = torch.randn(2, 3, 12, generator=torch.Generator().manual_seed(1))
    cot = torch.randn(2, 6, 10, generator=torch.Generator().manual_seed(2))
    base = nn.BinaryTreeLSTM(12, 10).initialize(0)
    outs = []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(base).to(dev)
        for p in m.parameters():
            p.requires_grad_(True)
        e = emb.to(dev).requires_grad_(True)
        y = m((e, trees.to(dev)))
        gs = torch.autograd.grad((y * cot.to(dev)).sum(),
                                 [e, *m.parameters()])
        outs.append([y.detach().cpu()] + [g.cpu() for g in gs])
    assert (outs[0][0][:, -1] == 0).all()  # the padding row
    for a, b in zip(outs[1], outs[0]):
        assert _share(a, b) <= 1e-5


def test_while_trains_on_card_through_a_diverging_dead_body(cuda):
    class Step(nn.Module):
        def __init__(self):
            super().__init__("Step")
            self.lin = nn.Linear(6, 6)

        def forward(self, c):
            i, h = c
            grow = torch.exp(1000.0 * torch.relu(i.float() - 3.5))
            return i + 1, torch.tanh(self.lin(h)) * grow

    w = nn.While(lambda c: c[0] < 4, Step(), max_trip_count=8)
    w = w.initialize(0).to(cuda)
    for p in w.parameters():
        p.requires_grad_(True)
    x = torch.randn(16, 6, device=cuda)
    i, h = w((torch.zeros((), dtype=torch.long, device=cuda), x))
    grads = torch.autograd.grad(h.square().sum(), list(w.parameters()))
    assert int(i) == 4 and w.trips == 4
    assert all(bool(torch.isfinite(g).all()) for g in grads)

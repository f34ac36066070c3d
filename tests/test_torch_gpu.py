"""The port on the card: the hand-written int8 GEMM and LSTM cell kernels
against their plain versions, the quantized serving slice and one PTB
training block against the same model on the CPU.  Every test here needs a CUDA card and skips without one; on the card
run ``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
no JAX, so it runs where the reference package is not installed.

Tolerances: dynamic mode is BITWISE (exact integer sums, one-rounding FMA
epilogue on both sides); weight_only ``rtol=1e-5, atol=1e-5*max|y|``
(f32 sums on the card, float64 in the plain version).  Served models:
weight_only ``1e-4`` and dynamic ``1e-3`` of ``max|y|`` — see
``test_torch_serving.py`` for why dynamic mode needs more.  LSTM cell, f32:
``rtol=atol=1e-5`` (the recurrent product summed in another order; the
gates' expf/tanhf within ulps of PyTorch's); bf16 outputs within one bf16
ulp (``rtol=atol=8e-3``).  Training on the card against the CPU: losses
``rtol=1e-4``, parameters ``1e-4`` of each array's largest value.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.interop import to_jax_params
from bigdl_tpu_torch.models import ptb_model, resnet_cifar
from bigdl_tpu_torch.ops import _build, int8_gemm, lstm_cell
from bigdl_tpu_torch.ops.int8_gemm import dyn_quantize, int8_matmul_reference
from bigdl_tpu_torch.serving import ModelRegistry

pytestmark = pytest.mark.gpu

# (M, K, O): the stem's ragged K=147/O=64 at 1, 3 and 37 rows, the FC's
# O=1000, aligned shapes, and a stage-1 3x3 conv with several row blocks
SHAPES = [(1, 147, 64), (3, 147, 64), (37, 147, 64), (5, 64, 1000),
          (8, 256, 128), (37, 128, 128), (300, 576, 64)]


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
    got = int8_gemm.launch(xin, wq, scale, b)
    torch.cuda.synchronize()
    assert int8_gemm.launches == before + 1
    want = int8_matmul_reference(xin, wq, scale, b)
    if xdtype == "int8":
        assert torch.equal(got, want)
    else:
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


CELL_SHAPES = [(20, 650), (1, 64), (5, 130), (37, 650)]


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
    # f32 results within 1e-5, the forward's at H=650 within 1e-4 (its
    # recurrent product sums 650 terms in another order than cuBLAS; the
    # JAX cell test's forward tolerance at that shape); bf16 within 8e-3
    for i, (g, w) in enumerate(zip(got + got_b, want + want_b)):
        assert g.dtype == w.dtype
        fwd = i < len(got)
        t = 8e-3 if g.dtype == torch.bfloat16 else \
            1e-4 if fwd and H > 130 else 1e-5
        torch.testing.assert_close(g.float(), w.float(), rtol=t, atol=t)


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

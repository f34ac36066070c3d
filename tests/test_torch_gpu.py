"""The port on the card: the hand-written int8 GEMM against its plain
version, and the quantized serving slice against the same model on the
CPU.  Every test here needs a CUDA card and skips without one; on the card
run ``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
no JAX, so it runs where the reference package is not installed.

Tolerances: dynamic mode is BITWISE (exact integer sums, one-rounding FMA
epilogue on both sides); weight_only ``rtol=1e-5, atol=1e-5*max|y|``
(f32 sums on the card, float64 in the plain version).  Served models:
weight_only ``1e-4`` and dynamic ``1e-3`` of ``max|y|`` — see
``test_torch_serving.py`` for why dynamic mode needs more.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.ops import _build, int8_gemm
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

"""f16 compute in the port on the CPU, against the reference:
``set_compute_dtype(torch.float16)`` keeps f32 master weights, the update
in f32 and the forward and backward in f16 (``utils/precision.py``), as the
reference's ``set_compute_dtype(jnp.float16)`` does, with no loss scaling
in either.

- Mixed-precision loss and gradients of a small NHWC conv/BN/ReLU/max
  pool/Linear model: the loss within ``rtol=2e-3`` of the reference's f16
  loss and every gradient within 1e-2 of its array's largest value
  (readings 1.3e-4 and up to 2.2e-3: the packages round to f16 at
  different places, PyTorch after each operator, XLA once a fused chain).
- One SGD step (lr 0.01) of LeNet-5 (NCHW, its pools on B1's plain version
  in f16) and of a tiny NHWC ResNet (the stem pool's too) through
  ``LocalOptimizer`` at K=1 from the same weights and batch: the loss
  within ``rtol=5e-3`` and each array's change within ``STEP_LIMIT`` of
  the reference's change, as a share of it (L2): 5e-2 for LeNet (readings
  up to 3.8e-3), 0.5 for the ResNet, whose BatchNorms amplify rounding
  (readings up to 0.17; each package's own f16 step stands 0.02-0.19 off
  its f32 one); a planted fault, f16 master weights (the update rounded to
  f16), exceeds both (0.28 and 4.8).
- f16 reaches B1 only where it has an f16 form: the plain version on the
  CPU computes in f16 (each window's gradient added in f16).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JBatch  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models import lenet as jlenet  # noqa: E402
from bigdl_tpu.models import resnet as jresnet  # noqa: E402
from bigdl_tpu.utils import precision as jprecision  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet as tlenet  # noqa: E402
from bigdl_tpu_torch.models import resnet as tresnet  # noqa: E402
from bigdl_tpu_torch.ops import maxpool  # noqa: E402
from bigdl_tpu_torch.utils import precision  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_precision import _small_model  # noqa: E402
from test_torch_resnet_training import _tiny_resnet  # noqa: E402

STEP_LIMIT = {"lenet": 5e-2, "resnet": 0.5}


def test_mixed_precision_f16_loss_and_grads_match_reference():
    rng = np.random.default_rng(5)
    tm = _small_model(nn).initialize(3).train()
    params, state = to_jax_params(tm)
    x = rng.normal(0, 1, (6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    jloss_fn = jprecision.mixed_precision_loss_fn(
        _small_model(jnn), jnn.ClassNLLCriterion(), jnp.float16)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, state, jnp.asarray(x), jnp.asarray(y), None),
        has_aux=True)(params)
    tparams = dict(tm.named_parameters())
    for p in tparams.values():
        p.requires_grad_(True)
    seen = []
    sound = maxpool.maxpool_bwd_reference

    def spy(x, *a):
        seen.append(x.dtype)
        return sound(x, *a)
    maxpool.maxpool_bwd_reference = spy
    try:
        loss = precision.mixed_precision_loss_fn(
            tm, nn.ClassNLLCriterion(), torch.float16)(
            tparams, torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
    finally:
        maxpool.maxpool_bwd_reference = sound
    assert seen == [torch.float16]  # the pool's backward ran in f16
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
    jflat = {".".join(str(q.key) for q in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(tparams)
    for k, want in jflat.items():
        got = tparams[k].grad
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max(), err_msg=k)


def _lenet_samples(S, n=8):
    rng = np.random.default_rng(0)
    return [S(rng.normal(0, 1, (28, 28)).astype(np.float32),
              np.int32(i % 10)) for i in range(n)]


def _resnet_samples(S, n=8):
    rng = np.random.default_rng(1)
    return [S(rng.normal(0, 1, (32, 32, 3)).astype(np.float32),
              np.int32(i % 10)) for i in range(n)]


MODELS = {
    "lenet": (lambda: tlenet.lenet5(10), lambda: jlenet.lenet5(10),
              _lenet_samples),
    "resnet": (lambda: _tiny_resnet(tresnet, nn),
               lambda: _tiny_resnet(jresnet, jnn), _resnet_samples),
}


class F16Masters(optim.SGD):
    """The planted fault: master weights kept in f16 (each update rounded
    to f16)."""

    def update(self, grads, params, state, lr, step):
        super().update(grads, params, state, lr, step)
        with torch.no_grad():
            for p in params.values():
                p.copy_(p.half().float())


def _step(name, method=optim.SGD):
    make, jmake, samples = MODELS[name]
    model = make().initialize(0)
    start = copy.deepcopy(to_jax_params(model))
    losses = []

    class Recording(optim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    (Recording(model, DataSet.array(samples(Sample)) >> SampleToMiniBatch(8),
               nn.ClassNLLCriterion(), device="cpu")
     .set_optim_method(method(learning_rate=0.01))
     .set_compute_dtype(torch.float16)
     .set_end_when(optim.max_iteration(1)).optimize())
    return start, losses, to_jax_params(model)


def _ref_step(name, start):
    jm = MODELS[name][1]()
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = jax.tree_util.tree_map(jnp.asarray, start[1])
    losses = []

    class Recording(joptim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    (Recording(jm, JDataSet.array(MODELS[name][2](JSample)) >> JBatch(8),
               jnn.ClassNLLCriterion())
     .set_optim_method(joptim.SGD(learning_rate=0.01))
     .set_compute_dtype(jnp.float16)
     .set_end_when(joptim.max_iteration(1)).optimize())
    return losses, (jm._params, jm._state)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _worst_change_share(start, got, want):
    init, got, want = (_flat(t[0]) for t in (start, got, want))
    assert sorted(got) == sorted(want)
    return max(np.linalg.norm(got[k] - want[k])
               / np.linalg.norm(want[k] - init[k]) for k in want)


@pytest.fixture(scope="module")
def reference_steps():
    out = {}
    for name in MODELS:
        start, losses, trained = _step(name)
        out[name] = (start, losses, trained, *_ref_step(name, start))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f16_step_matches_reference(reference_steps, name):
    start, losses, trained, jlosses, jtrained = reference_steps[name]
    assert len(losses) == len(jlosses) == 1
    np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
    assert all(v.dtype == np.float32 for v in _flat(trained[0]).values())
    assert _worst_change_share(start, trained, jtrained) < STEP_LIMIT[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f16_master_weights_fault_exceeds_the_limit(reference_steps, name):
    start, _, _, _, jtrained = reference_steps[name]
    _, _, faulty = _step(name, F16Masters)
    assert _worst_change_share(start, faulty, jtrained) > STEP_LIMIT[name]


def test_plain_max_pool_backward_adds_in_f16():
    """Overlapping windows add their gradients in f16, one (dh, dw) offset
    after another, as the kernel does: 1 then three 2^-11 stays 1 in f16
    (each add a tie, rounded to even), where the f32 sum rounded once
    would give 1 + 2^-9."""
    x = torch.full((1, 1, 3, 3), -1.0, dtype=torch.float16)
    x[0, 0, 1, 1] = 0.0  # the max of all four 2x2 windows
    y = torch.zeros(1, 1, 2, 2, dtype=torch.float16)
    # window (1, 1) holds the centre at offset (0, 0): its gradient first
    g = torch.tensor([[[[2.0 ** -11, 2.0 ** -11], [2.0 ** -11, 1.0]]]],
                     dtype=torch.float16)
    gi = maxpool.maxpool_bwd_reference(x, y, g, (2, 2), (1, 1),
                                       ((0, 0), (0, 0)))
    assert gi.dtype == torch.float16
    assert float(gi[0, 0, 1, 1]) == 1.0
    assert float(g.float().sum().half()) == 1.0 + 2.0 ** -9
    assert float(gi.float().sum()) == 1.0

"""The port's learning-rate schedules and mixed precision on the CPU against
the reference package.

Schedules are host-side float arithmetic on both sides, written the same
way: every step's lr is compared exactly.  Mixed precision: a small NHWC
conv/BN/ReLU/max-pool/Linear model's loss and f32 gradients with bf16
compute, against the reference's ``mixed_precision_loss_fn`` from the same
weights and batch.  Tolerance: the loss within ``rtol=1e-2`` and every
gradient within 5e-2 of its array's largest value — bf16 forward and
backward on both sides, rounded at different places (PyTorch rounds each
operator's output to bf16; XLA fuses chains of them and rounds once).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.optim import schedules as jsched  # noqa: E402
from bigdl_tpu.utils import precision as jprecision  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.optim import schedules as tsched  # noqa: E402
from bigdl_tpu_torch.utils import precision  # noqa: E402


def _decay(epoch):
    return sum(1 for e in (3, 6, 8) if epoch >= e)


SCHEDULES = {
    "Default": lambda m: m.Default(0.05),
    "Step": lambda m: m.Step(7, 0.5),
    "MultiStep": lambda m: m.MultiStep([5, 12, 30], 0.3),
    "MultiStep_epochs": lambda m: m.MultiStep([2, 4], 0.1, epoch_based=True),
    "EpochStep": lambda m: m.EpochStep(3, 0.5),
    "EpochDecay": lambda m: m.EpochDecay(_decay),
    "Poly": lambda m: m.Poly(0.5, 40),
    "Exponential": lambda m: m.Exponential(10, 0.9),
    "Exponential_stair": lambda m: m.Exponential(10, 0.9, stair_case=True),
    "NaturalExp": lambda m: m.NaturalExp(6, 0.2),
    "Warmup": lambda m: m.Warmup(0.01, 15),
    "Sequential": lambda m: m.SequentialSchedule(
        m.Warmup(0.02, 10)).add(m.Poly(2.0, 20)).add(m.Step(4, 0.5)),
    "Sequential_max_iteration": lambda m: m.SequentialSchedule().add(
        m.Step(3, 0.5), max_iteration=9).add(m.Exponential(5, 0.8)),
    "EpochSchedule": lambda m: m.EpochSchedule([(0, 1, 0.3), (2, 4, 0.03),
                                                (6, 9, 0.001)]),
    "EpochDecayWithWarmUp": lambda m: m.EpochDecayWithWarmUp(12, 0.025,
                                                             _decay),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_step_for_step(name):
    mine, ref = SCHEDULES[name](tsched), SCHEDULES[name](jsched)
    for it in range(60):
        epoch = it // 6
        assert mine(0.1, it, epoch) == ref(0.1, it, epoch), (name, it)
    assert len(mine) == len(ref)


def test_plateau_is_not_ported():
    """Plateau came with validation (the LeNet slice): fed a score through
    ``__call__``'s metric, it gives the reference's lr sequence."""
    mine, ref = tsched.Plateau(patience=2), jsched.Plateau(patience=2)
    for it, score in enumerate([1.0, 0.9, 0.95, 0.97, 0.99, 0.5, 0.6]):
        assert mine(0.1, it, 0, score) == ref(0.1, it, 0, score), it
    assert mine(0.1, 7, 0) == ref(0.1, 7, 0) < 0.1


def test_cast_floating():
    tree = {"w": torch.ones(2), "i": torch.arange(3),
            "t": (torch.zeros(1, dtype=torch.float64), 7)}
    out = precision.cast_floating(tree, torch.bfloat16)
    assert out["w"].dtype == out["t"][0].dtype == torch.bfloat16
    assert out["i"].dtype == torch.int64 and out["t"][1] == 7
    jout = jprecision.cast_floating(
        {k: np.asarray(v) for k, v in tree.items() if k != "t"},
        jnp.bfloat16)
    assert jout["w"].dtype == jnp.bfloat16 and jout["i"].dtype != jnp.bfloat16


def test_cast_floating_coo_batch_matches_reference():
    """A COOBatch is cast as the reference's pytree cast casts it: the
    floating ``values`` to the compute dtype, bit for bit the same bf16,
    and ``row``, ``col`` and ``dense_shape`` untouched."""
    from bigdl_tpu.nn.sparse import COOBatch as JCOOBatch
    rng = np.random.default_rng(11)
    row = rng.integers(0, 6, 40).astype(np.int32)
    col = rng.integers(0, 50, 40).astype(np.int32)
    values = rng.normal(0, 3, 40).astype(np.float32)
    coo = nn.COOBatch(torch.from_numpy(row), torch.from_numpy(col),
                      torch.from_numpy(values), (6, 50))
    out, x = precision.cast_floating((coo, torch.ones(2)), torch.bfloat16)
    jout = jprecision.cast_floating(
        JCOOBatch(jnp.asarray(row), jnp.asarray(col), jnp.asarray(values),
                  (6, 50)), jnp.bfloat16)
    assert isinstance(out, nn.COOBatch) and x.dtype == torch.bfloat16
    assert out.values.dtype == torch.bfloat16
    assert jout.values.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        out.values.view(torch.int16).numpy(),
        np.asarray(jout.values).view(np.int16))
    assert out.row is coo.row and out.col is coo.col
    assert out.dense_shape == jout.dense_shape == (6, 50)
    np.testing.assert_array_equal(np.asarray(jout.row), row)
    np.testing.assert_array_equal(np.asarray(jout.col), col)


def _small_model(m):
    # no conv bias: BN cancels it, so its gradient is rounding noise
    return (m.Sequential()
            .add(m.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1,
                                      with_bias=False, format="NHWC"))
            .add(m.SpatialBatchNormalization(8, format="NHWC"))
            .add(m.ReLU())
            .add(m.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC"))
            .add(m.Reshape((8 * 4 * 4,)))
            .add(m.Linear(8 * 4 * 4, 5))
            .add(m.LogSoftMax()))


def test_mixed_precision_loss_and_grads_match_reference():
    rng = np.random.default_rng(5)
    tm = _small_model(nn).initialize(3).train()
    params, state = to_jax_params(tm)
    x = rng.normal(0, 1, (6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)

    jloss_fn = jprecision.mixed_precision_loss_fn(
        _small_model(jnn), jnn.ClassNLLCriterion(), jnp.bfloat16)
    (jloss, jstate), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, state, jnp.asarray(x), jnp.asarray(y), None),
        has_aux=True)(params)

    tparams = dict(tm.named_parameters())
    for p in tparams.values():
        p.requires_grad_(True)
    loss_fn = precision.mixed_precision_loss_fn(tm, nn.ClassNLLCriterion(),
                                                torch.bfloat16)
    loss = loss_fn(tparams, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    flat = {}
    for k, p in tparams.items():
        assert p.dtype == p.grad.dtype == torch.float32, k
        flat[k] = p.grad.numpy()
    jflat = {".".join(str(q.key) for q in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert flat.keys() == jflat.keys()
    for k, want in jflat.items():
        np.testing.assert_allclose(flat[k], want, rtol=0,
                                   atol=5e-2 * np.abs(want).max(), err_msg=k)
    # BN's running statistics stay f32 buffers, updated from bf16 input
    bn = tm[1]
    assert bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(jstate["1"]["running_mean"]),
                               rtol=1e-2, atol=1e-3)

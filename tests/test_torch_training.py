"""Training through the port's ``LocalOptimizer`` on the CPU against the
reference's ``LocalOptimizer``: a tiny PTB model (vocab 50, embed 16,
hidden 32, 2 LSTM layers, T 6, batch 4) on a seeded synthetic corpus,
with the PTB-medium recipe (``TimeDistributedCriterion(ClassNLLCriterion())``,
SGD at lr 1.0, global-norm clipping at 5.0), from the same weights.

The reference runs with ``kernel_impl="pallas"`` (its Pallas LSTM cell in
interpret mode).  Tolerance: every step's loss within ``rtol=1e-5`` and the
final parameters within ``1e-4`` of each array's largest value — f32 on
both sides, summed in another order, over 10 SGD steps.  Within the port,
K=1 and K=4 are bitwise-equal: the same eager steps in the same order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models.rnn import ptb_model as jax_ptb_model  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import ptb_model  # noqa: E402
from bigdl_tpu_torch.ops import lstm_cell  # noqa: E402

VOCAB, HIDDEN, T, BATCH, STEPS = 50, 32, 6, 4, 10


def _windows(S):
    """(x, next-word) windows of a seeded Zipf corpus: 20 samples, so an
    epoch is 5 batches of 4 and the 10 steps cross two epoch rollovers."""
    ids = np.minimum(np.random.default_rng(0).zipf(1.4, 20 * T + 1),
                     VOCAB - 1).astype(np.int32)
    xs = ids[:-1].reshape(-1, T)
    ys = ids[1:].reshape(-1, T)
    return [S(x, y) for x, y in zip(xs, ys)]


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _port_run(k):
    model = ptb_model(VOCAB, 16, HIDDEN, 2).initialize(0)
    start = to_jax_params(model)
    opt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(_windows(Sample), seed=3)
        >> SampleToMiniBatch(BATCH),
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion()), device="cpu")
        .set_optim_method(optim.SGD(learning_rate=1.0))
        .set_gradient_clipping_by_l2_norm(5.0)
        .set_steps_per_dispatch(k)
        .set_end_when(optim.max_iteration(STEPS)))
    assert opt.optimize() is model
    return start, opt, to_jax_params(model)[0]


def _jax_run(start, k):
    model = jax_ptb_model(VOCAB, 16, HIDDEN, 2, kernel_impl="pallas")
    model._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    model._state = start[1]
    opt = (_recording(joptim.LocalOptimizer)(
        model, JDataSet.array(_windows(JSample), seed=3)
        >> JSampleToMiniBatch(BATCH),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))
        .set_optim_method(joptim.SGD(learning_rate=1.0))
        .set_gradient_clipping_by_l2_norm(5.0)
        .set_steps_per_dispatch(k)
        .set_end_when(joptim.max_iteration(STEPS)))
    opt.optimize()
    return opt, jax.tree_util.tree_map(np.asarray, model._params)


@pytest.fixture(scope="module")
def port_runs():
    return {k: _port_run(k) for k in (1, 4)}


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("k", [1, 4])
def test_local_optimizer_matches_reference(port_runs, k):
    start, topt, tparams = port_runs[k]
    jopt, jparams = _jax_run(start, k)
    assert len(topt.losses) == len(jopt.losses) == STEPS
    np.testing.assert_allclose(topt.losses, jopt.losses, rtol=1e-5)
    for key in ("neval", "epoch", "records_processed_this_epoch"):
        assert topt.state[key] == jopt.state[key], key
    assert topt.state["epoch"] == 2
    tflat, jflat = _flat(tparams), _flat(jparams)
    assert tflat.keys() == jflat.keys()
    for key in jflat:
        np.testing.assert_allclose(tflat[key], jflat[key], rtol=1e-4,
                                   atol=1e-4 * np.abs(jflat[key]).max(),
                                   err_msg=key)
    # loss fell over the run
    assert np.mean(topt.losses[-3:]) < np.mean(topt.losses[:3])


def test_k1_and_k4_bitwise(port_runs):
    (_, o1, p1), (_, o4, p4) = port_runs[1], port_runs[4]
    assert o1.losses == o4.losses
    f1, f4 = _flat(p1), _flat(p4)
    for key in f1:
        np.testing.assert_array_equal(f1[key], f4[key])
    # blocks: K=1 one step each; K=4 capped at the epoch ends (steps 5, 10)
    assert o1._dispatch_count == STEPS
    assert o4._dispatch_count == 4  # 4+1, 4+1


def test_cpu_training_launches_no_kernel(port_runs):
    assert lstm_cell.fwd_launches == lstm_cell.bwd_launches == 0


def test_cuda_device_required_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = DataSet.array(_windows(Sample)) >> SampleToMiniBatch(BATCH)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optim.LocalOptimizer(ptb_model(VOCAB, 16, HIDDEN, 2), ds, crit)


# the LeNet slice ported validation, checkpoints, summaries and the numeric
# guard: those setters are builder calls now, with the reference's
# arguments (resume without a checkpoint directory raises the reference's
# ValueError); the rest still raise NotImplementedError
PORTED_SETTERS = {
    "set_validation": lambda o, ds: o.set_validation(
        optim.every_epoch(), ds, [optim.Top1Accuracy()]),
    "set_checkpoint": lambda o, ds: o.set_checkpoint(
        "unused-dir", optim.every_epoch()),
    "over_write_checkpoint": lambda o, ds: o.over_write_checkpoint(False),
    "set_preemption_handling": lambda o, ds: o.set_preemption_handling(),
    "set_train_summary": lambda o, ds: o.set_train_summary(None),
    "set_val_summary": lambda o, ds: o.set_val_summary(None),
    "set_numeric_guard": lambda o, ds: o.set_numeric_guard("skip"),
}


@pytest.mark.parametrize("setter", [
    "set_validation", "set_checkpoint", "over_write_checkpoint",
    "set_preemption_handling", "resume", "set_train_summary",
    "set_val_summary", "set_telemetry", "set_numeric_guard",
    "set_activation_memory", "set_compute_dtype"])
def test_unported_driver_features_raise(setter):
    ds = DataSet.array(_windows(Sample)) >> SampleToMiniBatch(BATCH)
    opt = optim.LocalOptimizer(ptb_model(VOCAB, 16, HIDDEN, 2), ds,
                               nn.TimeDistributedCriterion(
                                   nn.ClassNLLCriterion()), device="cpu")
    if setter in PORTED_SETTERS:
        assert PORTED_SETTERS[setter](opt, ds) is opt
    elif setter == "resume":
        with pytest.raises(ValueError, match="set_checkpoint"):
            opt.resume()
    else:
        # set_compute_dtype is ported for None, f32 and bf16; f16 is not
        arg = torch.float16 if setter == "set_compute_dtype" else None
        with pytest.raises(NotImplementedError, match="not ported"):
            getattr(opt, setter)(arg)


def test_create_distributed_returns_distri_optimizer():
    ds = DataSet.array(_windows(Sample)) >> SampleToMiniBatch(BATCH)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    opt = optim.Optimizer.create(ptb_model(VOCAB, 16, HIDDEN, 2), ds, crit,
                                 distributed=True, device="cpu",
                                 grad_wire_dtype="bf16")
    assert isinstance(opt, optim.DistriOptimizer)
    assert opt.grad_wire_dtype == "bf16" and opt.device.type == "cpu"
    local = optim.Optimizer.create(ptb_model(VOCAB, 16, HIDDEN, 2), ds, crit,
                                   device="cpu")
    assert type(local) is optim.LocalOptimizer


def test_distributed_array_returns_distributed_dataset():
    from bigdl_tpu_torch.dataset import DistributedDataSet
    ds = DataSet.array(_windows(Sample), distributed=True, seed=3)
    assert isinstance(ds, DistributedDataSet)
    assert ds.size() == ds.local_size() == 20  # no group: process 0 of 1

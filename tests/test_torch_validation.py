"""Validation in the port on the CPU against the reference: every
``ValidationMethod`` on the same outputs, ``Plateau``'s lr sequence, and
``set_validation`` inside ``LocalOptimizer`` (a ragged last batch, the
trigger's blocks cut where it fires).

Tolerances: counts (Top1, Top5, HitRatio, TreeNNAccuracy) exactly; Loss,
MAE and NDCG within ``rtol=1e-6`` (f32 math, then f64 sums in both); a
trained LeNet's validation after one epoch, from the same weights and data
order, to the same Top-1/Top-5 counts.
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
from bigdl_tpu.dataset import image as jimage  # noqa: E402
from bigdl_tpu.dataset import mnist as jmnist  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu.optim import validation as jval  # noqa: E402
from bigdl_tpu.optim.schedules import Plateau as JPlateau  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import image, mnist  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.optim import validation as tval  # noqa: E402
from bigdl_tpu_torch.optim.schedules import Plateau  # noqa: E402

rng = np.random.default_rng(11)
LOGITS = rng.normal(size=(13, 10)).astype(np.float32)
LABELS = rng.integers(0, 10, 13).astype(np.int32)
CASES = {
    "Top1Accuracy/indices": ((), LOGITS, LABELS),
    "Top1Accuracy/column": ((), LOGITS, LABELS[:, None]),
    "Top1Accuracy/one_hot": ((), LOGITS,
                             np.eye(10, dtype=np.float32)[LABELS]),
    "Top5Accuracy/indices": ((), LOGITS, LABELS),
    "Top5Accuracy/one_hot": ((), LOGITS,
                             np.eye(10, dtype=np.float32)[LABELS]),
    # outputs from {0, 1, 2}: most rows tie across the fifth place, where
    # lax.top_k keeps the lower index
    "Top5Accuracy/ties": ((), np.random.default_rng(0).integers(
        0, 3, (13, 10)).astype(np.float32), LABELS),
    "Loss/indices": ((), LOGITS, LABELS),
    "MAE/dense": ((), LOGITS, rng.normal(size=(13, 10)).astype(np.float32)),
    "HitRatio/k3": ((3,), LOGITS, None),
    "NDCG/k4": ((4,), LOGITS, None),
    "TreeNNAccuracy/root": ((), rng.normal(size=(13, 5, 10)).astype(
        np.float32), LABELS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validation_method_matches_reference(case):
    name = case.split("/")[0]
    args, out, tgt = CASES[case]
    t_out = torch.from_numpy(out)
    t_tgt = None if tgt is None else torch.from_numpy(tgt)
    got = getattr(tval, name)(*args)(t_out, t_tgt)
    want = getattr(jval, name)(*args)(jnp.asarray(out),
                                      None if tgt is None
                                      else jnp.asarray(tgt))
    assert got.count == want.count == 13
    if name in ("Loss", "MAE", "NDCG"):
        np.testing.assert_allclose(got.value, want.value, rtol=1e-6)
    else:
        assert got.value == want.value
    assert getattr(tval, name).name == getattr(jval, name).name
    summed = got + got
    assert summed.count == 26 and summed.result == got.result
    assert repr(got) == repr(tval.ValidationResult(got.value, got.count))


def test_plateau_lr_sequence_matches_reference():
    scores = [0.5, 0.4, 0.41, 0.42, 0.43, 0.39, 0.40, 0.40, 0.41, 0.38,
              0.45, 0.46, 0.47, 0.48]
    for mode, kw in (("min", dict(patience=2, cooldown=1, factor=0.5)),
                     ("max", dict(patience=1, factor=0.1, min_lr=1e-4))):
        p, j = Plateau(mode=mode, **kw), JPlateau(mode=mode, **kw)
        got, want = [], []
        for i, s in enumerate(scores):
            p.record(s)
            j.record(s)
            got.append(p(0.1, i, 0))
            want.append(j(0.1, i, 0))
        assert got == want
        assert len(set(got)) > 1  # it did drop


def _pipeline(pkg, n, seed, batch, train):
    img, mn, D, S2B = pkg
    imgs, labels = mn.synthetic_mnist(n, seed=seed)
    ds = (D.array(mn.to_samples(imgs, labels))
          >> img.BytesToGreyImg()
          >> img.GreyImgNormalizer(mn.TEST_MEAN, mn.TEST_STD))
    return ds >> S2B(batch) if train else ds


PORT = (image, mnist, DataSet, SampleToMiniBatch)
REF = (jimage, jmnist, JDataSet, JSampleToMiniBatch)


def _recorded(cls):
    class Recorded(cls):
        def _run_validation(self, *a):
            res = super()._run_validation(*a)
            if res is not None:
                self.validations = getattr(self, "validations", []) + [
                    (self.state["neval"],
                     {k: (v.value, v.count) for k, v in res.items()})]
            return res
    return Recorded


def test_set_validation_ragged_batch_matches_reference():
    """One epoch (96 samples, batches of 16) of LeNet from the same
    weights, then validation over 37 samples in batches of 16 (a ragged
    last batch of 5), re-batched by ``set_validation(batch_size=)``."""
    model = lenet5(10).initialize(6)
    start = to_jax_params(model)
    topt = (_recorded(optim.LocalOptimizer)(
        model, _pipeline(PORT, 96, 0, 16, True), nn.ClassNLLCriterion(),
        device="cpu")
        .set_optim_method(optim.SGD(0.05, momentum=0.9))
        .set_steps_per_dispatch(4).set_end_when(optim.max_epoch(1))
        .set_validation(optim.every_epoch(),
                        _pipeline(PORT, 37, 99, 16, False),
                        [tval.Top1Accuracy(), tval.Top5Accuracy(),
                         tval.Loss(nn.ClassNLLCriterion())], batch_size=16))
    topt.optimize()
    jm = jax_lenet5(10)
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    jopt = (_recorded(joptim.LocalOptimizer)(
        jm, _pipeline(REF, 96, 0, 16, True), jnn.ClassNLLCriterion())
        .set_optim_method(joptim.SGD(0.05, momentum=0.9))
        .set_steps_per_dispatch(4).set_end_when(joptim.max_epoch(1))
        .set_validation(joptim.every_epoch(),
                        _pipeline(REF, 37, 99, 16, False),
                        [jval.Top1Accuracy(), jval.Top5Accuracy(),
                         jval.Loss(jnn.ClassNLLCriterion())], batch_size=16))
    jopt.optimize()
    (tstep, tres), = topt.validations
    (jstep, jres), = jopt.validations
    assert tstep == jstep == 6
    assert tres.keys() == jres.keys()
    for name in ("Top1Accuracy", "Top5Accuracy"):
        assert tres[name] == jres[name], name
    assert tres["Top1Accuracy"][1] == 37
    np.testing.assert_allclose(tres["Loss"][0], jres["Loss"][0], rtol=1e-5)
    assert topt.state["score"] == jopt.state["score"]


def test_validation_blocks_cut_at_the_trigger():
    """Validation every 3 iterations at K=4 scores the parameters of
    exactly iterations 3, 6, 9 (the same scores as K=1), and feeds a
    Plateau schedule once per validation; eval mode and no autograd
    graph during the pass."""
    seen = []

    class Spy(nn.Module):
        def forward(self, x):
            seen.append((self.training, torch.is_grad_enabled()))
            return x

    scores = {}
    for k in (1, 4):
        model = lenet5(10).initialize(8)
        model.add(Spy())
        sched = Plateau(mode="max", patience=1, factor=0.5)
        opt = (_recorded(optim.LocalOptimizer)(
            model, _pipeline(PORT, 96, 0, 16, True), nn.ClassNLLCriterion(),
            device="cpu")
            .set_optim_method(optim.SGD(0.05, momentum=0.9,
                                        learning_rate_schedule=sched))
            .set_steps_per_dispatch(k).set_end_when(optim.max_iteration(9))
            .set_validation(optim.several_iteration(3),
                            _pipeline(PORT, 37, 99, 16, True),
                            [tval.Top1Accuracy(), tval.Loss(
                                nn.ClassNLLCriterion())]))
        opt.optimize()
        scores[k] = (opt.validations, sched._best, sched._wait,
                     sched._scale)
        assert [s for s, _ in opt.validations] == [3, 6, 9]
        best = max(v / n for v, n in
                   (r["Top1Accuracy"] for _, r in opt.validations))
        assert sched._best == best  # fed once per validation
    assert scores[1] == scores[4]
    assert (False, False) in seen and (True, True) in seen
    assert set(seen) == {(False, False), (True, True)}

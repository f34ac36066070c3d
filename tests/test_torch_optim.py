"""The port's optim methods, gradient clipping, triggers and data order on
the CPU against the reference package.

Optim methods run five steps on the same parameters and gradient sequence
(numpy, seeded) on both sides; tolerance ``rtol=1e-6, atol=1e-7``: the same
f32 update rule, with the reference's f32 ``lr`` and bias corrections
against the port's float scalars.  Clipping ``rtol=1e-6``.  Triggers, the
block probe, the data order and the stager's block plan are compared
exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset.prefetch import DeviceBlockStager as JStager  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.dataset.text import Dictionary as JDictionary  # noqa: E402
from bigdl_tpu.optim import optimizer as joptimizer  # noqa: E402
from bigdl_tpu.optim import trigger as jtrig  # noqa: E402
from bigdl_tpu_torch import optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset.prefetch import DeviceBlockStager  # noqa: E402
from bigdl_tpu_torch.dataset.text import Dictionary  # noqa: E402
from bigdl_tpu_torch.optim import trigger as ttrig  # noqa: E402

SHAPES = {"w": (4, 3), "b": (3,)}

METHODS = {
    "sgd": dict(learning_rate=0.1),
    "sgd_decay_wd": dict(learning_rate=0.1, learning_rate_decay=0.5,
                         weight_decay=0.01),
    "momentum": dict(learning_rate=0.1, momentum=0.9),
    "dampening": dict(learning_rate=0.1, momentum=0.9, dampening=0.3),
    "nesterov": dict(learning_rate=0.1, momentum=0.9, dampening=0.0,
                     nesterov=True),
    "adam": dict(learning_rate=0.01),
    "adam_wd_decay": dict(learning_rate=0.01, weight_decay=0.1,
                          learning_rate_decay=0.2, beta1=0.8, beta2=0.99),
}


@pytest.mark.parametrize("name", sorted(METHODS))
def test_optim_method_step_for_step(name):
    cls = "Adam" if name.startswith("adam") else "SGD"
    jm = getattr(joptim, cls)(**METHODS[name])
    tm = getattr(optim, cls)(**METHODS[name])
    rng = np.random.default_rng(len(name))
    p0 = {k: rng.normal(0, 1, s).astype(np.float32)
          for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for step in range(5):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in SHAPES.items()}
        lr = jm.current_lr(step, 0)
        assert lr == tm.current_lr(step, 0)
        jp, js = jax.jit(jm.update)({k: jnp.asarray(v) for k, v in g.items()},
                                    jp, js, jnp.float32(lr), jnp.int32(step))
        tm.update({k: torch.from_numpy(v) for k, v in g.items()}, tp, ts,
                  lr, step)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {step}")


def test_nesterov_needs_momentum_without_dampening():
    with pytest.raises(ValueError, match="nesterov"):
        optim.SGD(momentum=0.9, nesterov=True)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping(max_norm):
    rng = np.random.default_rng(3)
    g = {k: rng.normal(0, 1, s).astype(np.float32)
         for k, s in SHAPES.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    np.testing.assert_allclose(optim.global_norm(tg).item(),
                               float(joptimizer.global_norm(jg)), rtol=1e-6)
    for got, want in ((optim.clip_by_global_norm(tg, max_norm),
                       joptimizer.clip_by_global_norm(jg, max_norm)),
                      (optim.clip_by_value(tg, -0.3, 0.2),
                       joptimizer.clip_by_value(jg, -0.3, 0.2))):
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- triggers
TRIGGERS = {
    "every_epoch": lambda T: T.every_epoch(),
    "several_iteration": lambda T: T.several_iteration(3),
    "max_epoch": lambda T: T.max_epoch(2),
    "max_iteration": lambda T: T.max_iteration(7),
    "max_score": lambda T: T.max_score(0.9),
    "min_loss": lambda T: T.min_loss(0.1),
    "and": lambda T: T.several_iteration(2).and_(T.max_iteration(6)),
    "or": lambda T: T.every_epoch().or_(T.min_loss(0.5)),
}

STATES = [{}, {"neval": 3}, {"neval": 6, "epoch": 1, "loss": 0.4},
          {"neval": 7, "epoch": 2, "epoch_finished": True, "loss": 0.05,
           "score": 0.95}, {"neval": 8, "score": 0.5, "loss": 1.0}]


@pytest.mark.parametrize("name", sorted(TRIGGERS))
def test_trigger(name):
    jt, tt = TRIGGERS[name](jtrig), TRIGGERS[name](ttrig)
    assert [tt(s) for s in STATES] == [jt(s) for s in STATES]


@pytest.mark.parametrize("k_max", [1, 4, 8])
def test_probe_fire_step(k_max):
    for name in ("max_iteration", "several_iteration", "max_epoch",
                 "min_loss"):
        for neval in range(0, 10):
            for records in (0, 20, 80):
                state = {"neval": neval, "epoch": 0, "loss": 1.0,
                         "records_processed_this_epoch": records}
                args = (state, k_max, 20, 100)
                assert ttrig.probe_fire_step(
                    *args, [TRIGGERS[name](ttrig)]) == jtrig.probe_fire_step(
                    *args, [TRIGGERS[name](jtrig)]), (name, neval, records)
    assert ttrig.probe_fire_step({}, k_max, 0, 100, [None]) is None


# -------------------------------------------------------------- data order
def _samples(S, n=23):
    rng = np.random.default_rng(4)
    return [S(rng.integers(0, 50, (5,)).astype(np.int32),
              np.int32(i)) for i in range(n)]


def test_data_order_epochs_0_to_2():
    jds = JDataSet.array(_samples(JSample), seed=7) >> JSampleToMiniBatch(4)
    tds = DataSet.array(_samples(Sample), seed=7) >> SampleToMiniBatch(4)
    assert tds.size() == jds.size() == 23
    for epoch in range(3):
        jit, tit = jds.data(train=True), tds.data(train=True)
        for _ in range(8):  # past one epoch: the stream wraps around
            jb, tb = next(jit), next(tit)
            np.testing.assert_array_equal(tb.input, jb.input)
            np.testing.assert_array_equal(tb.target, jb.target)
        jds.shuffle()
        tds.shuffle()
    one_pass = SampleToMiniBatch(4, drop_remainder=False)(
        DataSet.array(_samples(Sample)).data(train=False))
    assert [b.size() for b in one_pass] == [4] * 5 + [3]


def test_stager_block_plan():
    """Blocks of up to k batches within the records budget, as the
    reference stages them."""
    jds = JDataSet.array(_samples(JSample), seed=7) >> JSampleToMiniBatch(4)
    tds = DataSet.array(_samples(Sample), seed=7) >> SampleToMiniBatch(4)
    js = JStager(jds.data(train=True), lambda xs, ys: (xs, ys))
    ts = DeviceBlockStager(tds.data(train=True), "cpu")
    for k, budget in ((3, 23), (3, 11), (8, 9), (1, 100), (4, 4)):
        jxs, jys, jsizes = js.take(k, budget)
        block = ts.take(k, budget)
        assert block.sizes == jsizes
        assert block.event is None
        np.testing.assert_array_equal(block.xs.numpy(), jxs)
        np.testing.assert_array_equal(block.ys.numpy(), jys)


def test_dictionary():
    words = [f"w{min(int(z), 40)}" for z in
             np.random.default_rng(0).zipf(1.4, size=3000)]
    jd, td = JDictionary([words], vocab_size=30), \
        Dictionary([words], vocab_size=30)
    assert td.index2word == jd.index2word
    assert td.vocab_size() == jd.vocab_size() == 31
    np.testing.assert_array_equal(td.encode(words[:200]),
                                  jd.encode(words[:200]))
    assert td.index("never-seen") == td.vocab_size() - 1

"""Every criterion of the port on the CPU against the reference.

- The golden torch-float64 fixtures ``crit_*`` and ``crit2_*`` that
  ``tests/test_torch_lenet.py`` does not replay (26 and 5), loss and input
  gradients, at the reference replay's tolerance (loss ``rtol=2e-4,
  atol=1e-6``; gradients ``rtol=2e-4, atol=2e-5``).
- Each of the 38 criteria (the base class aside) against its ``bigdl_tpu`` twin on seeded numpy
  inputs: the loss within ``rtol=1e-5, atol=1e-6`` and the gradient with
  respect to every float input within ``rtol=1e-5, atol=1e-6``
  (``TransformerCriterion``'s modules carried across by
  ``load_jax_params``).
- ``TimeDistributedMaskCriterion`` over a weighted ``ClassNLLCriterion``:
  each step a batch of one, so its weight cancels; a vectorised form that
  weighs the whole batch at once gives another loss, which the test
  shows.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
TOL = dict(rtol=2e-4, atol=2e-5)
CLOSE = dict(rtol=1e-5, atol=1e-6)

# the crit_* fixtures tests/test_torch_lenet.py does not replay
FIXTURES = {
    "abs": lambda: nn.AbsCriterion(),
    "smooth_l1": lambda: nn.SmoothL1Criterion(),
    "class_nll_weighted": lambda: nn.ClassNLLCriterion(
        weights=[0.5, 1.0, 2.0, 1.5]),
    "dist_kl": lambda: nn.DistKLDivCriterion(),
    "soft_margin": lambda: nn.SoftMarginCriterion(),
    "hinge_embedding": lambda: nn.HingeEmbeddingCriterion(margin=1.0),
    "multilabel_soft_margin": lambda: nn.MultiLabelSoftMarginCriterion(),
    "class_nll_ignore": lambda: nn.ClassNLLCriterion(ignore_index=-100),
    "multilabel_margin": lambda: nn.MultiLabelMarginCriterion(),
    "multi_margin_p1": lambda: nn.MultiMarginCriterion(p=1),
    "multi_margin_p2": lambda: nn.MultiMarginCriterion(p=2),
    "margin": lambda: nn.MarginCriterion(),
    "poisson": lambda: nn.PoissonCriterion(),
    "mape": lambda: nn.MeanAbsolutePercentageCriterion(),
    "msle": lambda: nn.MeanSquaredLogarithmicCriterion(),
    "kl_probs": lambda: nn.KullbackLeiblerDivergenceCriterion(),
    "cosine_distance": lambda: nn.CosineDistanceCriterion(),
    "cosine_proximity": lambda: nn.CosineProximityCriterion(),
    "dot_product": lambda: nn.DotProductCriterion(),
    "l1_cost": lambda: nn.L1Cost(),
    "dice": lambda: nn.DiceCoefficientCriterion(epsilon=1.0),
    "pg": lambda: nn.PGCriterion(),
    "categorical_ce": lambda: nn.CategoricalCrossEntropy(),
    "softmax_with": lambda: nn.SoftmaxWithCriterion(),
    "time_distributed_mse": lambda: nn.TimeDistributedCriterion(
        nn.MSECriterion()),
    "class_simplex": lambda: nn.ClassSimplexCriterion(4),
}
PAIR_FIXTURES = {
    "margin_ranking": lambda: nn.MarginRankingCriterion(margin=1.0),
    "cosine_embedding": lambda: nn.CosineEmbeddingCriterion(margin=0.2),
    "l1_hinge_embedding": lambda: nn.L1HingeEmbeddingCriterion(margin=1.0),
    "kld_vae": lambda: nn.KLDCriterion(),
    "gaussian": lambda: nn.GaussianCriterion(),
}


def _tensor(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f"
                            else a)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_criterion_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"crit_{name}.npz"))
    crit = FIXTURES[name]()
    x = _tensor(z["x"]).requires_grad_(True)
    loss = crit.apply(x, _tensor(z["target"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(z["loss"]), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], **TOL)


@pytest.mark.parametrize("name", sorted(PAIR_FIXTURES))
def test_pair_criterion_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"crit2_{name}.npz"))
    crit = PAIR_FIXTURES[name]()
    x1 = _tensor(z["x1"]).requires_grad_(True)
    x2 = _tensor(z["x2"]).requires_grad_(True)
    loss = crit.apply((x1, x2), _tensor(z["target"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(z["loss"]), rtol=2e-4)
    np.testing.assert_allclose(x1.grad.numpy(), z["dx1"], **TOL)
    np.testing.assert_allclose(x2.grad.numpy(), z["dx2"], **TOL)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(*shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _probs(*shape, seed=0):
    e = np.exp(_normal(*shape, seed=seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _logprobs(*shape, seed=0):
    return np.log(_probs(*shape, seed=seed)).astype(np.float32)


def _classes(n, k, seed=1):
    return _rng(seed).integers(0, k, n).astype(np.int32)


def _signs(*shape, seed=1):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


def _multilabel():
    t = np.full((4, 5), -1, np.int32)
    t[0, :2] = (0, 3)
    t[1, :1] = (4,)
    t[2, :3] = (1, 0, 2)
    t[3, :2] = (0, 0)  # a repeated target
    return _normal(4, 5), t


def _masked_steps():
    t = _rng(2).integers(1, 5, (3, 4)).astype(np.int32)
    t[0, 2:] = 0  # padding steps
    t[2, 3] = 0
    return _logprobs(3, 4, 5), t


def _softmax_with_ignore():
    t = _rng(3).integers(0, 4, (2, 3, 3)).astype(np.int32)
    t[0, 0, :2] = 255
    return _normal(2, 4, 3, 3), t


def _multi(m):
    return (m.MultiCriterion().add(m.MSECriterion(), 0.5)
            .add(m.AbsCriterion(), 2.0))


def _parallel(m):
    return (m.ParallelCriterion().add(m.ClassNLLCriterion(), 1.0)
            .add(m.MSECriterion(), 0.25))


def _parallel_repeat(m):
    return (m.ParallelCriterion(repeat_target=True)
            .add(m.MSECriterion(), 1.0).add(m.SmoothL1Criterion(), 3.0))


# name: (criterion of module ``m``, (input, target) maker); the port takes
# the reference's constructor arguments
CASES = {
    "ClassNLL": (lambda m: m.ClassNLLCriterion(),
                 lambda: (_logprobs(6, 4), _classes(6, 4))),
    "ClassNLL_weighted_sum": (
        lambda m: m.ClassNLLCriterion(weights=np.float32([.5, 1, 2, 1.5]),
                                      size_average=False),
        lambda: (_logprobs(6, 4), _classes(6, 4))),
    "CrossEntropy": (lambda m: m.CrossEntropyCriterion(),
                     lambda: (_normal(6, 4), _classes(6, 4))),
    "MSE": (lambda m: m.MSECriterion(), lambda: (_normal(3, 4),
                                                 _normal(3, 4, seed=1))),
    "Abs": (lambda m: m.AbsCriterion(size_average=False),
            lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    # input equal to target at some elements: the reference's gradient of
    # |d| at 0 is 1 (torch.abs gives 0)
    "Abs_ties": (lambda m: m.AbsCriterion(),
                 lambda: (_normal(3, 4), np.where(
                     np.arange(12).reshape(3, 4) % 3 == 0, _normal(3, 4),
                     _normal(3, 4, seed=1)).astype(np.float32))),
    "BCE": (lambda m: m.BCECriterion(weights=np.float32([1, 2, .5])),
            lambda: (_probs(4, 3), (_rng(1).random((4, 3)) < .5).astype(
                np.float32))),
    "BCEWithLogits": (lambda m: m.BCEWithLogitsCriterion(),
                      lambda: (_normal(4, 3), (_rng(1).random((4, 3)) < .5)
                               .astype(np.float32))),
    "SmoothL1": (lambda m: m.SmoothL1Criterion(),
                 lambda: (2 * _normal(3, 4), _normal(3, 4, seed=1))),
    "DistKLDiv": (lambda m: m.DistKLDivCriterion(),
                  lambda: (_logprobs(3, 5), _probs(3, 5, seed=1))),
    "KLD": (lambda m: m.KLDCriterion(),
            lambda: ((_normal(4, 3), 0.5 * _normal(4, 3, seed=1)),
                     np.zeros(4, np.float32))),
    "Gaussian": (lambda m: m.GaussianCriterion(),
                 lambda: ((_normal(4, 3), 0.5 * _normal(4, 3, seed=1)),
                          _normal(4, 3, seed=2))),
    "Margin": (lambda m: m.MarginCriterion(margin=0.5, squared=True),
               lambda: (_normal(5, 3), _signs(5, 3))),
    "MarginRanking": (lambda m: m.MarginRankingCriterion(0.3),
                      lambda: ((_normal(6), _normal(6, seed=1)),
                               _signs(6))),
    "CosineEmbedding": (lambda m: m.CosineEmbeddingCriterion(0.1),
                        lambda: ((_normal(5, 4), _normal(5, 4, seed=1)),
                                 _signs(5))),
    "HingeEmbedding": (lambda m: m.HingeEmbeddingCriterion(0.7),
                       lambda: (_normal(5, 3), _signs(5, 3))),
    "SoftMargin": (lambda m: m.SoftMarginCriterion(size_average=False),
                   lambda: (_normal(5, 3), _signs(5, 3))),
    "L1Cost": (lambda m: m.L1Cost(),
               lambda: (_normal(3, 4), np.zeros(1, np.float32))),
    "DiceCoefficient": (lambda m: m.DiceCoefficientCriterion(0.5),
                        lambda: (_probs(3, 2, 4), (_rng(1).random((3, 2, 4))
                                                   < .5).astype(np.float32))),
    "MultiLabelSoftMargin": (lambda m: m.MultiLabelSoftMarginCriterion(),
                             lambda: (_normal(4, 5), (_rng(1).random((4, 5))
                                                      < .5).astype(
                                 np.float32))),
    "Multi": (_multi, lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    "Parallel": (_parallel, lambda: ((_logprobs(4, 3), _normal(4, 2)),
                                     (_classes(4, 3),
                                      _normal(4, 2, seed=2)))),
    "Parallel_repeat": (_parallel_repeat,
                        lambda: ((_normal(4, 2), _normal(4, 2, seed=1)),
                                 _normal(4, 2, seed=2))),
    "TimeDistributed": (lambda m: m.TimeDistributedCriterion(
        m.ClassNLLCriterion(), size_average=True),
        lambda: (_logprobs(3, 4, 5), _rng(2).integers(0, 5, (3, 4)).astype(
            np.int32))),
    "PG": (lambda m: m.PGCriterion(size_average=True),
           lambda: (_probs(4, 3), _normal(4, 3, seed=1))),
    "MultiLabelMargin": (lambda m: m.MultiLabelMarginCriterion(),
                         _multilabel),
    "SoftmaxWith": (lambda m: m.SoftmaxWithCriterion(),
                    lambda: (_normal(2, 4, 3, 3),
                             _rng(3).integers(0, 4, (2, 3, 3)).astype(
                                 np.int32))),
    "SoftmaxWith_ignore_batch": (lambda m: m.SoftmaxWithCriterion(
        ignore_label=255, normalize_mode="BATCH_SIZE"), _softmax_with_ignore),
    "CosineDistance": (lambda m: m.CosineDistanceCriterion(),
                       lambda: (_normal(3, 2, 3), _normal(3, 2, 3, seed=1))),
    "CosineProximity": (lambda m: m.CosineProximityCriterion(),
                        lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    "DotProduct": (lambda m: m.DotProductCriterion(size_average=True),
                   lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    "KullbackLeiblerDivergence": (
        lambda m: m.KullbackLeiblerDivergenceCriterion(),
        lambda: (_probs(3, 4), _probs(3, 4, seed=1))),
    "L1HingeEmbedding": (lambda m: m.L1HingeEmbeddingCriterion(2.0),
                         lambda: ((_normal(5, 3), _normal(5, 3, seed=1)),
                                  _signs(5))),
    "MeanAbsolutePercentage": (
        lambda m: m.MeanAbsolutePercentageCriterion(),
        lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    "MeanSquaredLogarithmic": (
        lambda m: m.MeanSquaredLogarithmicCriterion(),
        lambda: (np.abs(_normal(3, 4)), np.abs(_normal(3, 4, seed=1)))),
    "MultiMargin_weighted": (
        lambda m: m.MultiMarginCriterion(p=2, weights=np.float32(
            [1, .5, 2, 1]), margin=0.8),
        lambda: (_normal(5, 4), _classes(5, 4))),
    "Poisson": (lambda m: m.PoissonCriterion(),
                lambda: (np.abs(_normal(3, 4)) + .1,
                         np.abs(_normal(3, 4, seed=1)))),
    "ClassSimplex": (lambda m: m.ClassSimplexCriterion(5),
                     lambda: (_normal(6, 5), _classes(6, 5))),
    "SmoothL1WithWeights": (
        lambda m: m.SmoothL1CriterionWithWeights(sigma=2.0, num=3),
        lambda: (_normal(3, 4), (_normal(3, 4, seed=1),
                                 np.abs(_normal(3, 4, seed=2)),
                                 np.abs(_normal(3, 4, seed=3))))),
    "SmoothL1WithWeights_plain": (
        lambda m: m.SmoothL1CriterionWithWeights(),
        lambda: (_normal(3, 4), _normal(3, 4, seed=1))),
    "TimeDistributedMask": (lambda m: m.TimeDistributedMaskCriterion(
        m.ClassNLLCriterion(weights=np.float32([1, .5, 2, 1, 3]))),
        _masked_steps),
    "TimeDistributedMask_mse": (lambda m: m.TimeDistributedMaskCriterion(
        m.MSECriterion(), padding_value=0.0),
        lambda: (_normal(2, 3, 4), np.where(_rng(4).random((2, 3, 4)) < .2,
                                            0.0, _normal(2, 3, 4, seed=5))
                 .astype(np.float32))),
    "CategoricalCrossEntropy": (lambda m: m.CategoricalCrossEntropy(),
                                lambda: (_probs(4, 3), _classes(4, 3))),
    "CategoricalCrossEntropy_soft": (
        lambda m: m.CategoricalCrossEntropy(log_prob_input=True),
        lambda: (_logprobs(4, 3), _probs(4, 3, seed=1))),
}


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def reference_loss_and_grads(crit, x, t):
    """The reference's loss and its gradients with respect to the input's
    leaves."""
    jx, jt = _map(jnp.asarray, x), _map(jnp.asarray, t)
    leaves = _leaves(jx)

    def loss(*ls):
        it = iter(ls)
        return crit.apply(_map(lambda _: next(it), jx), jt)

    value, grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(leaves))))(*leaves)
    return float(value), [np.asarray(g) for g in grads]


def port_loss_and_grads(crit, x, t):
    tx = _map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
              x)
    loss = crit.apply(tx, _map(lambda a: torch.from_numpy(np.array(a)), t))
    loss.backward()
    return loss.item(), [a.grad.numpy() for a in _leaves(tx)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    make_crit, make_data = CASES[name]
    x, t = make_data()
    want, want_g = reference_loss_and_grads(make_crit(jnn), x, t)
    got, got_g = port_loss_and_grads(make_crit(nn), x, t)
    np.testing.assert_allclose(got, want, **CLOSE)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **CLOSE)


def test_transformer_criterion_runs_modules_in_eval_mode():
    """Input and target each through a module (a Linear; a Dropout that
    eval mode turns off), on the module's current weights, then MSE."""
    jlin = jnn.Linear(4, 3)
    params, _ = jlin.init(jax.random.PRNGKey(1))
    jlin._params, jlin._state = params, {}
    jdrop = jnn.Dropout(0.5)
    jdrop._params, jdrop._state = {}, {}
    lin = load_jax_params(nn.Linear(4, 3),
                          jax.tree_util.tree_map(np.asarray, params))
    drop = nn.Dropout(0.5).train()
    x, t = _normal(5, 4), _normal(5, 3, seed=1)
    want, (want_g,) = reference_loss_and_grads(
        jnn.TransformerCriterion(jnn.MSECriterion(), jlin, jdrop), x, t)
    got, (got_g,) = port_loss_and_grads(
        nn.TransformerCriterion(nn.MSECriterion(), lin, drop), x, t)
    np.testing.assert_allclose(got, want, **CLOSE)
    np.testing.assert_allclose(got_g, want_g, **CLOSE)
    assert drop.training and lin.training  # modes restored
    assert all(not p.requires_grad for p in lin.parameters())
    # weights changed after construction take effect at the next call
    with torch.no_grad():
        lin.weight.mul_(2.0)
    again, _ = port_loss_and_grads(
        nn.TransformerCriterion(nn.MSECriterion(), lin), x, t)
    assert abs(again - got) > 1e-3


def test_time_distributed_mask_weights_each_step_alone():
    """Each step is a batch of one, so a weighted, averaging inner
    criterion divides by that step's own weight and the weight cancels:
    the loss is the plain masked mean of -log p over the counted steps.
    Weighing all steps at once (one ClassNLL over the flattened batch)
    gives another number."""
    x, t = _masked_steps()
    weights = np.float32([1, .5, 2, 1, 3])
    crit = nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion(
        weights=weights))
    got = float(crit.apply(torch.from_numpy(x), torch.from_numpy(t)))
    picked = np.take_along_axis(x, t[..., None], -1)[..., 0]
    valid = t != 0
    np.testing.assert_allclose(got, -picked[valid].mean(), rtol=1e-6)
    flat = nn.ClassNLLCriterion(weights=weights, ignore_index=0).apply(
        torch.from_numpy(x.reshape(-1, 5)), torch.from_numpy(t.reshape(-1)))
    assert abs(float(flat) - got) > 1e-2
    want = jnn.TimeDistributedMaskCriterion(jnn.ClassNLLCriterion(
        weights=jnp.asarray(weights))).apply(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got, float(want), rtol=1e-6)

"""The port's recurrent stack, embedding, dropout and criteria on the CPU
against the reference package, weights carried across with
``to_jax_params``/``load_jax_params``, and against the torch-float64 golden
fixtures of ``tests/fixtures/data``.

The reference's LSTM runs with ``impl="pallas"``: its Pallas cell in
interpret mode, as the port's layer 0 runs its fused cell.  Tolerance
``rtol=1e-5, atol=1e-5*max|y|`` for forwards and losses and ``1e-4`` of the
largest gradient for gradients: both sides compute in f32, with the
hoisted projection, the recurrent product and autograd's sums over T in
another order than XLA's.  The fixtures keep the reference replay's own
tolerance ``rtol=2e-4, atol=2e-5`` (f32 against a float64 oracle).
"""

import copy
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.models.rnn import ptb_model as jax_ptb_model  # noqa: E402
from bigdl_tpu.models.rnn import simple_rnn as jax_simple_rnn  # noqa: E402
from bigdl_tpu.nn import recurrent as jrec  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import ptb_model, simple_rnn  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
FIXTURE_TOL = dict(rtol=2e-4, atol=2e-5)


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _pair(jmod, tmod, x, loss=None, seed=0):
    """Forward and parameter gradients of ``sum(out)`` (or ``loss(out)``)
    on both sides, from the port's seeded weights: ``(jax out, port out,
    jax grads, port grads)``, grads as flat {reference path: array}."""
    params, state = to_jax_params(copy.deepcopy(tmod).initialize(seed))
    load_jax_params(tmod, params, state)
    jloss = loss[0] if loss else jnp.sum
    tloss = loss[1] if loss else torch.sum
    jx = jnp.asarray(x)

    def f(p):
        y, _ = jmod.apply(p, state, jx, training=True)
        return jloss(y), y

    (_, yj), gj = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    for p in tmod.parameters():
        p.requires_grad_(True)
    yt = tmod(torch.from_numpy(x))
    tloss(yt).backward()
    return np.asarray(yj), yt.detach().numpy(), _flat(gj), _port_grads(tmod)


def _port_grads(module):
    """``module``'s gradients as flat {reference path: array}."""
    view = copy.deepcopy(module)
    with torch.no_grad():
        for p, q in zip(module.parameters(), view.parameters()):
            q.copy_(p.grad)
    return _flat(to_jax_params(view)[0])


def _check_grads(gj, gt):
    assert gj.keys() == gt.keys()
    for k in gj:
        _close(gt[k], gj[k], rel=1e-4)


def _seq(N, T, D, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (N, T, D)).astype(
        np.float32)


@pytest.mark.parametrize("fb", [0.0, 1.0], ids=["fb0", "fb1"])
def test_recurrent_lstm(fb):
    yj, yt, gj, gt = _pair(
        jrec.Recurrent(jrec.LSTM(10, 32, forget_bias=fb, impl="pallas")),
        nn.Recurrent(nn.LSTM(10, 32, forget_bias=fb)), _seq(4, 6, 10))
    assert yt.shape == (4, 6, 32)
    _close(yt, yj)
    _check_grads(gj, gt)


def test_recurrent_lstm_reverse():
    yj, yt, gj, gt = _pair(
        jrec.Recurrent(jrec.LSTM(5, 8, impl="pallas"), reverse=True),
        nn.Recurrent(nn.LSTM(5, 8), reverse=True), _seq(3, 4, 5, seed=1))
    _close(yt, yj)
    _check_grads(gj, gt)


def test_multi_rnn_cell_layer0_hoisted():
    cells = lambda R, **kw: [R.LSTM(7, 16, **kw), R.LSTM(16, 16, **kw)]  # noqa: E731
    yj, yt, gj, gt = _pair(
        jrec.Recurrent(jrec.MultiRNNCell(cells(jrec, impl="pallas"))),
        nn.Recurrent(nn.MultiRNNCell(cells(nn))), _seq(4, 5, 7, seed=2))
    _close(yt, yj)
    _check_grads(gj, gt)


def test_rnn_cell_and_time_distributed():
    yj, yt, gj, gt = _pair(jax_simple_rnn(12, 9, 11), simple_rnn(12, 9, 11),
                           _seq(3, 5, 12, seed=3))
    _close(yt, yj)
    _check_grads(gj, gt)


def test_time_distributed_linear():
    yj, yt, gj, gt = _pair(jrec.TimeDistributed(jnn.Linear(6, 4)),
                           nn.TimeDistributed(nn.Linear(6, 4)),
                           _seq(2, 3, 6, seed=4))
    _close(yt, yj)
    _check_grads(gj, gt)


def test_lookup_table_padding_and_max_norm():
    x = np.random.default_rng(5).integers(0, 9, (3, 4)).astype(np.int32)
    yj, yt, gj, gt = _pair(jnn.LookupTable(9, 5, max_norm=1.0),
                           nn.LookupTable(9, 5, max_norm=1.0), x)
    _close(yt, yj)
    _check_grads(gj, gt)
    m = nn.LookupTable(9, 5, padding_value=2).initialize(0)
    assert torch.count_nonzero(m.weight[2]) == 0
    assert torch.count_nonzero(m.weight) == 8 * 5


def test_tiny_ptb_model_loss_and_grads():
    """vocab 50, embed 16, hidden 32, 2 layers, T 6, N 4: forward, the
    PTB loss (TimeDistributedCriterion(ClassNLLCriterion())) and every
    parameter gradient."""
    rng = np.random.default_rng(6)
    x = rng.integers(0, 50, (4, 6)).astype(np.int32)
    y = rng.integers(0, 50, (4, 6)).astype(np.int32)
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    tc = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    losses = {}
    loss = (lambda out: losses.setdefault("j", jc.apply(out, jnp.asarray(y))),
            lambda out: losses.setdefault("t", tc.apply(
                out, torch.from_numpy(y))))
    yj, yt, gj, gt = _pair(jax_ptb_model(50, 16, 32, 2, kernel_impl="pallas"),
                           ptb_model(50, 16, 32, 2), x, loss=loss)
    assert yt.shape == (4, 6, 50)
    _close(yt, yj)
    _close(losses["t"].item(), float(jc.apply(jnp.asarray(yj),
                                              jnp.asarray(y))))
    _check_grads(gj, gt)
    assert set(gt) == {"0.weight", "1.0.weight", "1.0.bias", "1.1.weight",
                       "1.1.bias", "2.weight", "2.bias"}


def test_ptb_model_with_dropout_matches_reference_layout():
    jp, js = jax_ptb_model(20, 4, 6, 2, dropout=0.5).init(
        jax.random.PRNGKey(0))
    tp, ts = to_jax_params(ptb_model(20, 4, 6, 2, dropout=0.5))
    shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}  # noqa: E731
    assert shapes(tp) == shapes(jp)
    assert ts == jax.tree_util.tree_map(np.asarray, js)


# ----------------------------------------------------------------- dropout
def test_dropout():
    x = torch.ones(400, 50)
    d = nn.Dropout(0.25)
    assert d.eval()(x) is x
    assert nn.Dropout(0.0).train()(x) is x
    d.train()
    with pytest.raises(ValueError, match="needs a generator"):
        d(x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    assert torch.all(y[kept] == 1 / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02


# ---------------------------------------------------------------- criteria
@pytest.mark.parametrize("kind", ["plain", "weights", "ignore", "logits",
                                  "sum", "cross_entropy"])
def test_class_nll_criterion(kind):
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (9, 5)).astype(np.float32)
    t = rng.integers(0, 5, (9,)).astype(np.int32)
    t[[2, 6]] = -100
    w = np.array([0.5, 1.0, 2.0, 1.5, 0.7], np.float32)
    kw = {"plain": {}, "weights": {"weights": w}, "ignore": {},
          "logits": {"logits": True}, "sum": {"size_average": False},
          "cross_entropy": {"weights": w}}[kind]
    if kind != "ignore":
        t[[2, 6]] = 1
    if kind == "cross_entropy":
        jc = jnn.CrossEntropyCriterion(jnp.asarray(w))
        tc = nn.CrossEntropyCriterion(torch.from_numpy(w))
    else:
        jkw = dict(kw, **({"weights": jnp.asarray(w)} if "weights" in kw
                          else {}))
        jc, tc = jnn.ClassNLLCriterion(**jkw), nn.ClassNLLCriterion(**kw)
    lj, gj = jax.value_and_grad(jc.apply)(jnp.asarray(x), jnp.asarray(t))
    tx = torch.from_numpy(x)
    lt = tc(tx, torch.from_numpy(t))
    _close(lt.item(), float(lj))
    _close(tc.backward(tx, torch.from_numpy(t)).numpy(), gj)


@pytest.mark.parametrize("inner_mean", [True, False])
@pytest.mark.parametrize("size_average", [False, True])
def test_time_distributed_criterion(inner_mean, size_average):
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (3, 4, 6)).astype(np.float32)
    t = rng.integers(0, 6, (3, 4)).astype(np.int32)
    jc = jnn.TimeDistributedCriterion(
        jnn.ClassNLLCriterion(size_average=inner_mean, logits=True),
        size_average=size_average)
    tc = nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion(size_average=inner_mean, logits=True),
        size_average=size_average)
    _close(tc(torch.from_numpy(x), torch.from_numpy(t)).item(),
           float(jc.apply(jnp.asarray(x), jnp.asarray(t))))


# --------------------------------------------------------- golden fixtures
def _fixture(name):
    return np.load(os.path.join(DATA_DIR, f"{name}.npz"))


def _replay_module(z, mod, names):
    """Forward (and, where recorded, input and parameter gradients of
    sum(out)) of ``mod`` against fixture ``z``; ``names`` maps fixture
    parameter names to the module's."""
    with torch.no_grad():
        for k, attr in names.items():
            attr.copy_(torch.from_numpy(z[f"p_{k}"].astype(np.float32)))
            attr.requires_grad_(True)
    int_input = np.issubdtype(z["x"].dtype, np.integer)
    x = torch.from_numpy(z["x"] if int_input
                         else z["x"].astype(np.float32))
    if not int_input:
        x.requires_grad_(True)
    out = mod(x)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **FIXTURE_TOL)
    if "dx" not in z.files and not any(k.startswith("dp_") for k in z.files):
        return
    out.sum().backward()
    if "dx" in z.files:
        np.testing.assert_allclose(x.grad.numpy(), z["dx"], **FIXTURE_TOL)
    for k, attr in names.items():
        np.testing.assert_allclose(attr.grad.numpy(), z[f"dp_{k}"],
                                   **FIXTURE_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["recurrent_lstm",
                                  "recurrent_lstm_native_oracle"])
def test_fixture_recurrent_lstm(name):
    z = _fixture(name)
    D, H = z["x"].shape[2], z["out"].shape[2]
    cell = nn.LSTM(D, H)
    _replay_module(z, nn.Recurrent(cell),
                   {"weight": cell.weight, "bias": cell.bias})


def test_fixture_recurrent_rnn_tanh():
    z = _fixture("recurrent_rnn_tanh")
    cell = nn.RnnCell(4, 5)
    _replay_module(z, nn.Recurrent(cell), {"w_ih": cell.w_ih,
                                           "w_hh": cell.w_hh,
                                           "bias": cell.bias})


def test_fixture_lookup_table():
    m = nn.LookupTable(10, 6)
    _replay_module(_fixture("lookup_table"), m, {"weight": m.weight})


@pytest.mark.parametrize("name,crit", [
    ("crit_class_nll_ignore", lambda: nn.ClassNLLCriterion(ignore_index=-100)),
    ("crit_class_nll_weighted", lambda: nn.ClassNLLCriterion(
        weights=torch.tensor([0.5, 1.0, 2.0, 1.5]))),
])
def test_fixture_class_nll(name, crit):
    z = _fixture(name)
    c = crit()
    x = torch.from_numpy(z["x"].astype(np.float32))
    t = torch.from_numpy(z["target"])
    np.testing.assert_allclose(c(x, t).item(), z["loss"], **FIXTURE_TOL)
    np.testing.assert_allclose(c.backward(x, t).numpy(), z["dx"],
                               **FIXTURE_TOL)

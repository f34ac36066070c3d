"""The MNIST autoencoder, the regularizers and the new optim methods through
both optimizers, in the port on the CPU against the reference.

- ``autoencoder(8)``: its tree and forward against the reference's.
- Training through ``LocalOptimizer``, 8 iterations over 64 synthetic
  MNIST images in batches of 16 (an epoch rollover and its shuffle
  included), the recipe's Adagrad and MSE, at K=1 and K=4, and with an
  ``L1L2Regularizer(1e-3, 1e-3)`` on both ``Linear`` s: each step's loss
  within ``tests/test_torch_lenet.py``'s ``TOL`` (``rtol=2e-4``) and each
  final weight array within that ``rtol`` as a share of its change
  (:func:`_assert_weights` says why not elementwise).
- ``regularization_loss`` and its gradient at a ``Linear`` and a conv:
  ``rtol=1e-6``.
- Snapshots of each new method's state written by one package and resumed
  by the other: the resumed run's next 4 iterations within ``TOL`` of the
  writer's uninterrupted run, the weights as above.
- A spawned world-2 gloo ``DistriOptimizer`` (``tests/torch_distri_worker.py``,
  its small MLP) with Adagrad and with Ftrl against the reference's
  ``DistriOptimizer`` on a 2-device mesh (``tests/test_torch_distri.py``'s
  limits), LBFGS refused by the ZeRO-1 path with the reference's message
  and run on ``parameter_sharding=False`` against the reference's
  ``grad_sync=False``.
"""

import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models.autoencoder import autoencoder as jax_autoencoder  # noqa: E402
from bigdl_tpu.nn import regularizers as jreg  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import load_snapshot  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import mnist  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import autoencoder  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distri_worker as W  # noqa: E402
from test_torch_distri import (LOSS_RTOL, Recording,  # noqa: E402
                               assert_weights_close, flat_tree, jax_mlp,
                               jax_pipeline)

TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_lenet.py's
LBFGS_SHARE = 1e-3
N, BATCH, BOTTLENECK = 64, 16, 8


def _images():
    imgs, _ = mnist.synthetic_mnist(N, seed=3)
    return imgs.astype(np.float32) / 255.0


def _dataset(pkg):
    D, S, S2B = pkg
    x = _images()
    return D.array([S(x[i], x[i].reshape(-1)) for i in range(N)],
                   seed=5) >> S2B(BATCH)


PORT = (DataSet, Sample, SampleToMiniBatch)
REF = (JDataSet, JSample, JSampleToMiniBatch)


def _recording(cls):
    class Rec(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Rec


def _models(regularized=False):
    """The port's autoencoder (weights from seed 0) and the reference's
    with the same weights; optionally both ``Linear`` s regularized.  The
    start weights are at ``tm.start``."""
    tm = autoencoder(BOTTLENECK).initialize(0)
    jm = jax_autoencoder(BOTTLENECK)
    if regularized:
        for i in (1, 3):
            tm[i].w_regularizer = nn.L1L2Regularizer(1e-3, 1e-3)
            tm[i].b_regularizer = nn.L2Regularizer(1e-3)
            jm.modules[i].w_regularizer = jreg.L1L2Regularizer(1e-3, 1e-3)
            jm.modules[i].b_regularizer = jreg.L2Regularizer(1e-3)
    params, state = to_jax_params(tm)
    jm._params = jax.tree_util.tree_map(jnp.asarray, params)
    jm._state = state
    tm.start = _flat(params)
    return tm, jm


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_weights(tm, jm, start, limit=TOL["rtol"]):
    """Per array, ``||w_port - w_ref|| / ||w_ref - w_0||`` within TOL's
    ``rtol``: Adagrad divides each gradient by the root of its own sum of
    squares, so a weight whose gradients stay within rounding of 0 moves by
    a share of ``lr`` that rounding decides (one weight of 6272 in
    ``3.weight`` differs by 2.4e-5 at K=1), while the change of the array
    as a whole agrees to ~1e-5.  LBFGS takes ``LBFGS_SHARE``: its two-loop
    recursion multiplies each step's rounding (dot products summed in
    another order) by the history's conditioning (readings 2.5e-4 and
    2.7e-4)."""
    tw = _flat(to_jax_params(tm)[0])
    jw = _flat(jax.tree_util.tree_map(np.asarray, jm._params))
    assert tw.keys() == jw.keys() == start.keys()
    for k, w in jw.items():
        share = np.linalg.norm(tw[k] - w) / np.linalg.norm(w - start[k])
        assert share < limit, (k, share)


def test_autoencoder_tree_and_forward_match_reference():
    tm, jm = _models()
    x = _images()[:5]
    want = jm.apply(jm._params, jm._state, jnp.asarray(x))[0]
    got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert set(_flat(to_jax_params(tm)[0])) == {
        "1.weight", "1.bias", "3.weight", "3.bias"}


@pytest.mark.parametrize("k,regularized", [(1, False), (4, False),
                                           (4, True)],
                         ids=["adagrad-k1", "adagrad-k4", "l1l2-k4"])
def test_local_optimizer_matches_reference(k, regularized):
    tm, jm = _models(regularized)
    topt = (_recording(optim.LocalOptimizer)(
        tm, _dataset(PORT), nn.MSECriterion(), device="cpu")
        .set_optim_method(optim.Adagrad(learning_rate=0.01))
        .set_steps_per_dispatch(k).set_end_when(optim.max_iteration(8)))
    topt.optimize()
    jopt = (_recording(joptim.LocalOptimizer)(
        jm, _dataset(REF), jnn.MSECriterion())
        .set_optim_method(joptim.Adagrad(learning_rate=0.01))
        .set_steps_per_dispatch(k).set_end_when(joptim.max_iteration(8)))
    jopt.optimize()
    assert len(topt.losses) == len(jopt.losses) == 8
    np.testing.assert_allclose(topt.losses, jopt.losses, **TOL)
    assert topt.state["epoch"] == jopt.state["epoch"] == 2
    _assert_weights(tm, jm, tm.start)


def test_regularizers_raise_the_loss():
    """The regularized run's losses carry the penalty (the criterion's
    alone would be the unregularized run's at step 0)."""
    losses = []
    for reg in (False, True):
        tm, _ = _models(reg)
        opt = (_recording(optim.LocalOptimizer)(
            tm, _dataset(PORT), nn.MSECriterion(), device="cpu")
            .set_optim_method(optim.Adagrad(learning_rate=0.01))
            .set_end_when(optim.max_iteration(1)))
        opt.optimize()
        losses.append(opt.losses[0])
    tm, _ = _models(True)
    assert losses[1] - losses[0] == pytest.approx(
        float(nn.regularization_loss(tm)), rel=1e-4)


@pytest.mark.parametrize("layer", ["linear", "conv"])
def test_regularization_loss_gradient_matches_reference(layer):
    rng = np.random.default_rng(4)
    if layer == "linear":
        t = nn.Linear(5, 3, w_regularizer=nn.L1L2Regularizer(0.1, 0.2),
                      b_regularizer=nn.L1Regularizer(0.3))
        j = jnn.Linear(5, 3, w_regularizer=jreg.L1L2Regularizer(0.1, 0.2),
                       b_regularizer=jreg.L1Regularizer(0.3))
    else:
        t = nn.SpatialConvolution(2, 3, 3, 3,
                                  w_regularizer=nn.L2Regularizer(0.05),
                                  b_regularizer=nn.L1L2Regularizer(0.1, 0.1))
        j = jnn.SpatialConvolution(2, 3, 3, 3,
                                   w_regularizer=jreg.L2Regularizer(0.05),
                                   b_regularizer=jreg.L1L2Regularizer(0.1,
                                                                      0.1))
    tnet, jnet = nn.Sequential().add(t), jnn.Sequential().add(j)
    params = {"0": {"weight": rng.normal(0, 1, t.weight.shape).astype(
        np.float32), "bias": rng.normal(0, 1, t.bias.shape).astype(
        np.float32)}}
    load_jax_params(tnet, params)
    assert nn.has_regularizers(tnet)
    for p in tnet.parameters():
        p.requires_grad_(True)
    loss = nn.regularization_loss(tnet)
    loss.backward()
    jl, jg = jax.value_and_grad(
        lambda p: jreg.regularization_loss(jnet, p))(
        jax.tree_util.tree_map(jnp.asarray, params))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    for name, g in (("weight", t.weight.grad), ("bias", t.bias.grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg["0"][name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert nn.regularization_loss(autoencoder(4)) == 0.0
    assert not nn.has_regularizers(autoencoder(4))


# --------------------------------------------------- snapshots, both ways
SNAP_METHODS = {
    "parallel_adam": ("ParallelAdam", dict(learning_rate=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.01)),
    "adadelta": ("Adadelta", dict()),
    # a normal epsilon: at the default 1e-38 the reference on the CPU
    # divides 0 by 0 at the autoencoder's exactly-zero gradients (ROADMAP
    # queue C, reference caveats)
    "adamax": ("Adamax", dict(learning_rate=0.01, epsilon=1e-7)),
    "rmsprop": ("RMSprop", dict(learning_rate=0.01)),
    "ftrl": ("Ftrl", dict(learning_rate=0.05)),
    "lbfgs": ("LBFGS", dict(learning_rate=0.5, history=3)),
}


def _run(pkg, model, method, ckpt, iters, resume=None):
    o, name_kw = (optim, PORT) if pkg == "port" else (joptim, REF)
    cls, kw = method
    make = _recording(o.LocalOptimizer)
    args = (model, _dataset(name_kw), (nn if pkg == "port" else jnn)
            .MSECriterion())
    opt = make(*args, device="cpu") if pkg == "port" else make(*args)
    opt = (opt.set_optim_method(getattr(o, cls)(**kw))
           .set_steps_per_dispatch(4).set_end_when(o.max_iteration(iters))
           .set_checkpoint(ckpt, o.several_iteration(4)))
    if resume is not None:
        assert opt.resume(resume)
    opt.optimize()
    return opt


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(SNAP_METHODS))
def test_snapshot_resumes_across_packages(tmp_path, name, writer):
    method = SNAP_METHODS[name]
    reader = "reference" if writer == "port" else "port"
    tm, jm = _models()
    first = _run(writer, tm if writer == "port" else jm, method,
                 str(tmp_path / "w"), 8)
    snap = str(tmp_path / "w" / "model.4")
    blob = load_snapshot(snap)
    assert blob["manifest"]["schema"]["optim_method"] == method[0]
    if name == "lbfgs" and writer == "port":
        # the reference's writer stores 0-d leaves as (1,); the port's
        # keeps them 0-d, which both packages resume
        assert blob["opt_state"]["count"].shape == ()
    if name == "lbfgs":
        assert blob["opt_state"]["count"].dtype == torch.int32
        assert tuple(blob["opt_state"]["s"].shape) == (3, 784 * 8 * 2
                                                       + 784 + 8)
    tm2, jm2 = _models()
    second = _run(reader, tm2 if reader == "port" else jm2, method,
                  str(tmp_path / "r"), 8, resume=snap)
    np.testing.assert_allclose(second.losses, first.losses[4:], **TOL)
    # the writer's weights against the reader's, after 8 iterations
    limit = LBFGS_SHARE if name == "lbfgs" else TOL["rtol"]
    if writer == "port":
        _assert_weights(tm, jm2, tm.start, limit)
    else:
        _assert_weights(tm2, jm, tm.start, limit)


# ------------------------------------------------------ world 2, gloo
def _jax_run(start, devices, method, grad_sync=True):
    jm = jax_mlp()
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    rec = Recording()
    cls, kw = method
    opt = (joptim.DistriOptimizer(
        jm, jax_pipeline(), jnn.ClassNLLCriterion(),
        mesh=JMesh(np.array(devices[:2]), ("data",)),
        grad_wire_dtype="f32", grad_bucket_bytes=W.BUCKET_BYTES,
        grad_sync=grad_sync)
        .set_optim_method(getattr(joptim, cls)(**kw))
        .set_seed(5).set_train_summary(rec)
        .set_end_when(joptim.max_iteration(W.ITERS)))
    opt.optimize()
    return rec.losses, flat_tree(jm._params)


WORLD2_METHODS = {"adagrad": ("Adagrad", dict(learning_rate=0.05)),
                  "ftrl": ("Ftrl", dict(learning_rate=0.05,
                                        l1_regularization_strength=1e-4)),
                  "lbfgs": ("LBFGS", dict(learning_rate=0.05, history=3))}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2_methods")
    start = to_jax_params(W.small_mlp().initialize(0))
    runs = {name: {"method": m} for name, m in WORLD2_METHODS.items()}
    runs["lbfgs_plain"] = {"method": WORLD2_METHODS["lbfgs"],
                           "parameter_sharding": False}
    return start, W.run_world(2, str(tmp), start[0], runs)


@pytest.mark.parametrize("name", ["adagrad", "ftrl", "lbfgs_plain"])
def test_world2_matches_reference(world2, devices, name):
    start, ranks = world2
    method = WORLD2_METHODS[name.split("_")[0]]
    jlosses, jparams = _jax_run(start, devices, method,
                                grad_sync=name != "lbfgs_plain")
    for rank in ranks:
        np.testing.assert_allclose(rank[name]["losses"], jlosses,
                                   rtol=LOSS_RTOL)
        assert_weights_close(rank[name]["params"], jparams)


def test_world2_zero1_refuses_lbfgs(world2):
    _, ranks = world2
    for rank in ranks:
        msg = rank["lbfgs"]["refused"]
        assert "grad_sync requires an elementwise optimizer" in msg
        assert "LBFGS" in msg and "parameter_sharding=False" in msg

"""LeNet-5, its MNIST data path and the activations and criteria it
brings, in the port on the CPU against the reference.

- LeNet forward and backward from the same weights (carried across with
  ``to_jax_params``) on the same batch: the log-probabilities within
  ``rtol=1e-5, atol=1e-5`` and every gradient of the NLL within
  ``rtol=1e-4, atol=1e-6`` (f32 convolutions summed in another order).
- Training through ``LocalOptimizer``: 8 iterations in K=4 blocks (an
  epoch rollover and its shuffle included) against the reference's
  ``LocalOptimizer`` on the same numpy data order: each step's loss within
  ``rtol=1e-5``, the final weights within ``1e-4`` of each array's largest
  value.
- ``synthetic_mnist``, the idx readers (on files the test writes) and the
  grey-image pipeline: bitwise.
- The golden torch-float64 fixtures of every ported activation and
  criterion, forward and backward, at the reference replay's tolerance
  (``rtol=2e-4, atol=2e-5``; a criterion's loss ``rtol=2e-4, atol=1e-6``).
"""

import gzip
import os
import struct

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
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import image, mnist  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
TOL = dict(rtol=2e-4, atol=2e-5)


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def _images(n=16, seed=0):
    imgs, labels = mnist.synthetic_mnist(n, seed=seed)
    x = ((imgs.astype(np.float32) - mnist.TRAIN_MEAN) / mnist.TRAIN_STD)
    return x.astype(np.float32), labels


# ------------------------------------------------------------------ model
def test_lenet_layout_matches_reference():
    model = lenet5(10).initialize(0)
    jp, js = jax_lenet5(10).init(jax.random.PRNGKey(0))
    tp, ts = to_jax_params(model)
    shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}  # noqa: E731
    assert shapes(tp) == shapes(jp)
    assert jax.tree_util.tree_structure(tp) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp))
    # the reference's layer names, child by child
    assert [m.name for m in model.children()] == \
        [m.name for m in jax_lenet5(10).modules]
    assert [model[i].name for i in (1, 4, 8, 10)] == \
        ["conv1_5x5", "conv2_5x5", "fc1", "fc2"]


def test_lenet_forward_backward_matches_reference():
    model = lenet5(10).initialize(3)
    params, state = to_jax_params(model)
    x, labels = _images()
    xt = torch.from_numpy(x).requires_grad_(True)
    for p in model.parameters():
        p.requires_grad_(True)
    out = model(xt)
    loss = nn.ClassNLLCriterion().apply(out, torch.from_numpy(labels))
    loss.backward()

    jm = jax_lenet5(10)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p, xx):
        o, _ = jm.apply(p, state, xx, training=True)
        return jnn.ClassNLLCriterion().apply(o, jnp.asarray(labels)), o

    (jl, jout), (jg, jdx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(jparams,
                                                             jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-6)
    grads = _flat(jax.tree_util.tree_map(np.asarray, jg))
    tgrads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert tgrads.keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(tgrads[k], g, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _pipeline(pkg, n, seed, batch, train=True):
    img, mn, D, S2B = pkg
    imgs, labels = mn.synthetic_mnist(n, seed=seed)
    return (D.array(mn.to_samples(imgs, labels), seed=5)
            >> img.BytesToGreyImg()
            >> img.GreyImgNormalizer(mn.TRAIN_MEAN, mn.TRAIN_STD)
            >> S2B(batch, drop_remainder=train))


PORT = (image, mnist, DataSet, SampleToMiniBatch)
REF = (jimage, jmnist, JDataSet, JSampleToMiniBatch)


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def test_local_optimizer_block_matches_reference():
    """8 iterations at K=4 over 96 samples in batches of 16 (6 a epoch:
    the second block runs across the rollover and its shuffle)."""
    model = lenet5(10).initialize(1)
    start = to_jax_params(model)
    topt = (_recording(optim.LocalOptimizer)(
        model, _pipeline(PORT, 96, 0, 16), nn.ClassNLLCriterion(),
        device="cpu")
        .set_optim_method(optim.SGD(0.05, momentum=0.9))
        .set_steps_per_dispatch(4).set_end_when(optim.max_iteration(8)))
    topt.optimize()
    jm = jax_lenet5(10)
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    jopt = (_recording(joptim.LocalOptimizer)(
        jm, _pipeline(REF, 96, 0, 16), jnn.ClassNLLCriterion())
        .set_optim_method(joptim.SGD(0.05, momentum=0.9))
        .set_steps_per_dispatch(4).set_end_when(joptim.max_iteration(8)))
    jopt.optimize()
    assert len(topt.losses) == len(jopt.losses) == 8
    np.testing.assert_allclose(topt.losses, jopt.losses, rtol=1e-5)
    for key in ("neval", "epoch", "records_processed_this_epoch"):
        assert topt.state[key] == jopt.state[key], key
    tflat = _flat(to_jax_params(model)[0])
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jm._params))
    assert tflat.keys() == jflat.keys()
    for k, v in jflat.items():
        np.testing.assert_allclose(tflat[k], v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n,seed", [(64, 0), (37, 99)])
def test_synthetic_mnist_bitwise(n, seed):
    a, la = mnist.synthetic_mnist(n, seed=seed)
    b, lb = jmnist.synthetic_mnist(n, seed=seed)
    assert a.dtype == b.dtype == np.uint8 and la.dtype == lb.dtype
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert mnist.TRAIN_MEAN == jmnist.TRAIN_MEAN
    assert (mnist.TRAIN_STD, mnist.TEST_MEAN, mnist.TEST_STD) == \
        (jmnist.TRAIN_STD, jmnist.TEST_MEAN, jmnist.TEST_STD)


def _write_idx(folder, prefix, imgs, labels, gz):
    ext = ".gz" if gz else ""
    op = gzip.open if gz else open
    with op(os.path.join(folder, f"{prefix}-images-idx3-ubyte{ext}"),
            "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    with op(os.path.join(folder, f"{prefix}-labels-idx1-ubyte{ext}"),
            "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels))
                + labels.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_readers_on_written_files(tmp_path, gz):
    imgs, labels = mnist.synthetic_mnist(12, seed=4)
    _write_idx(str(tmp_path), "train", imgs, labels, gz)
    _write_idx(str(tmp_path), "t10k", imgs[:5], labels[:5], gz)
    for train, n in ((True, 12), (False, 5)):
        got = mnist.load_mnist(str(tmp_path), train=train)
        want = jmnist.load_mnist(str(tmp_path), train=train)
        np.testing.assert_array_equal(got[0], imgs[:n])
        np.testing.assert_array_equal(got[1], labels[:n])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad"
    bad.write_bytes(struct.pack(">IIII", 7, 1, 1, 1) + b"\0")
    with pytest.raises(ValueError, match="magic"):
        mnist.read_idx_images(str(bad))
    with pytest.raises(FileNotFoundError):
        mnist.load_mnist(str(tmp_path / "none"))


def test_grey_image_pipeline_bitwise():
    imgs, labels = mnist.synthetic_mnist(20, seed=2)
    for with_channel in (False, True):
        batches = []
        for img, mn, D, S2B in (PORT, REF):
            ds = (D.array(mn.to_samples(imgs, labels))
                  >> img.BytesToGreyImg()
                  >> img.GreyImgNormalizer(mn.TEST_MEAN, mn.TEST_STD))
            if with_channel:
                ds = ds >> img.GreyImgToSample()
            batches.append(list((ds >> S2B(8, drop_remainder=False))
                                .data(train=False)))
        assert [b.size() for b in batches[0]] == [8, 8, 4]
        for p, r in zip(*batches):
            assert p.input.dtype == r.input.dtype == np.float32
            np.testing.assert_array_equal(p.input, r.input)
            np.testing.assert_array_equal(p.target, r.target)
        assert batches[0][0].input.shape[1:] == \
            ((1, 28, 28) if with_channel else (28, 28))


# ------------------------------------------------ golden fixture replays
ACTIVATIONS = {
    "act_softmax": lambda: nn.SoftMax(),
    "act_log_softmax": lambda: nn.LogSoftMax(),
    "act_sigmoid": lambda: nn.Sigmoid(),
    "act_tanh": lambda: nn.Tanh(),
    "act_relu6": lambda: nn.ReLU6(),
    "act_leaky_relu": lambda: nn.LeakyReLU(0.01),
    "act_softsign": lambda: nn.SoftSign(),
    "act_softshrink": lambda: nn.SoftShrink(0.5),
    "act_hardshrink": lambda: nn.HardShrink(0.5),
    "act_tanhshrink": lambda: nn.TanhShrink(),
    "act_log_sigmoid": lambda: nn.LogSigmoid(),
    "act_gelu": lambda: nn.GELU(),
    "act_softmin": lambda: nn.SoftMin(),
    "prelu": lambda: nn.PReLU(),
    "elu": lambda: nn.ELU(),
    "softplus": lambda: nn.SoftPlus(),
    "hard_tanh": lambda: nn.HardTanh(),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    model = load_jax_params(ACTIVATIONS[name](), params)
    for p in model.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(z["x"].astype(np.float32)).requires_grad_(True)
    out = model(x)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **TOL)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], **TOL)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), z[f"dp_{k}"], **TOL,
                                   err_msg=k)


# the activations without a fixture: the reference's function on the
# same input (RReLU in eval mode, its training slopes drawn per package)
NO_FIXTURE = {
    "ReLU": ((), {}), "HardSigmoid": ((), {}), "SiLU": ((), {}),
    "Threshold": ((0.3, -2.0), {}), "RReLU": ((), {}),
    "SReLU": (((7,),), {}), "SoftPlus": ((2.0,), {}),
    "PReLU": ((3,), {}),
}


@pytest.mark.parametrize("name", sorted(NO_FIXTURE))
def test_activation_matches_reference(name):
    args, kw = NO_FIXTURE[name]
    x = np.random.default_rng(7).normal(0, 2, (2, 3, 4, 7)).astype(
        np.float32)
    jm = getattr(jnn, name)(*args, **kw)
    jp, js = jm.init(jax.random.PRNGKey(0))
    want, _ = jm.apply(jp, js, jnp.asarray(x), training=False)
    model = load_jax_params(getattr(nn, name)(*args, **kw),
                            jax.tree_util.tree_map(np.asarray, jp)).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rrelu_training_slopes_in_range():
    m = nn.RReLU(0.1, 0.3).train()
    x = -torch.ones(1000)
    with pytest.raises(ValueError, match="generator"):
        m(x)
    m.generator = torch.Generator().manual_seed(0)
    slopes = -m(x)
    assert 0.1 <= float(slopes.min()) and float(slopes.max()) <= 0.3
    assert float(slopes.std()) > 0.03


CRITERIA = {
    "mse": lambda: nn.MSECriterion(),
    "bce": lambda: nn.BCECriterion(),
    "bce_logits": lambda: nn.BCEWithLogitsCriterion(),
    "cross_entropy": lambda: nn.CrossEntropyCriterion(),
}


@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"crit_{name}.npz"))
    crit = CRITERIA[name]()
    x = torch.from_numpy(z["x"].astype(np.float32))
    t = z["target"]
    t = torch.from_numpy(t.astype(np.float32) if t.dtype.kind == "f" else t)
    loss = crit.apply(x, t)
    np.testing.assert_allclose(float(loss), float(z["loss"]), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(crit.backward(x, t).numpy(), z["dx"], **TOL)


def test_mse_sum_matches_reference():
    rng = np.random.default_rng(1)
    x, t = rng.normal(size=(2, 3, 4)).astype(np.float32), \
        rng.normal(size=(2, 3, 4)).astype(np.float32)
    for avg in (True, False):
        got = nn.MSECriterion(size_average=avg).apply(torch.from_numpy(x),
                                                      torch.from_numpy(t))
        want = jnn.MSECriterion(size_average=avg).apply(jnp.asarray(x),
                                                        jnp.asarray(t))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

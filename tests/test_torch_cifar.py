"""The CIFAR-10 recipes' modules in the port on the CPU against the
reference: the data, the colour ops, VGG and ResNet-20, and training.

- ``synthetic_cifar`` and both readers of ``load_cifar10`` (on ``.bin``
  records and pickled batches that the test writes): bitwise.
- The seven colour ops of ``dataset/image.py``, single-threaded at two
  seeds: bitwise (the same ``ThreadRng`` seeds and salts).
- ``vgg_for_cifar10`` and ``resnet_cifar(20)`` in eval mode (where
  Dropout would differ; random running statistics) from the same weights
  on the same batch: the log-probabilities within ``rtol=1e-5,
  atol=1e-5`` and every gradient within ``rtol=1e-4, atol=1e-6``, as
  ``tests/test_torch_lenet.py`` holds LeNet; ResNet-20's training-mode
  forward and running statistics within ``1e-5``.
- VGG trained with the recipe's SGD, dropout off on both sides (its masks
  come from other generators): 8 iterations of a K=4 ``LocalOptimizer``
  across an epoch's shuffle, and 3 of a world-2 gloo ``DistriOptimizer``
  (each rank reading the rows the reference's 2-device mesh gives its
  device) against the reference's ``DistriOptimizer`` on 2 virtual CPU
  devices, held a step at a time (``STEP_LIMIT`` below says why): the
  reference redoes each step from the port's state; the losses within
  ``1e-4``, the updates within ``STEP_LIMIT`` of the step's change, which
  two planted faults exceed.
"""

import os
import pickle
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
from bigdl_tpu.dataset import cifar as jcifar  # noqa: E402
from bigdl_tpu.dataset import image as jimage  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models.resnet import resnet_cifar as jax_resnet_cifar  # noqa: E402
from bigdl_tpu.models.vgg import vgg_for_cifar10 as jax_vgg  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import cifar, image  # noqa: E402
from bigdl_tpu_torch.dataset.sample import Sample  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import resnet_cifar, vgg_for_cifar10  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distri_worker as W  # noqa: E402

PORT = (image, cifar, SampleToMiniBatch)
REF = (jimage, jcifar, JSampleToMiniBatch)


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("n,seed", [(64, 0), (37, 9)])
def test_synthetic_cifar_bitwise(n, seed):
    a, la = cifar.synthetic_cifar(n, seed=seed)
    b, lb = jcifar.synthetic_cifar(n, seed=seed)
    assert a.dtype == b.dtype == np.uint8 and a.shape == (n, 32, 32, 3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert (cifar.TRAIN_MEAN, cifar.TRAIN_STD) == \
        (jcifar.TRAIN_MEAN, jcifar.TRAIN_STD)
    for s, t in zip(cifar.to_samples(a[:3], la[:3]),
                    jcifar.to_samples(b[:3], lb[:3])):
        assert s.feature.dtype == t.feature.dtype == np.float32
        np.testing.assert_array_equal(s.feature, t.feature)
        assert s.label == t.label


def _write_batches(folder, fmt, parts):
    """CIFAR-10's five train batches and its test batch as ``.bin``
    records or pickled dicts."""
    os.makedirs(folder)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for name, (imgs, labels) in zip(names, parts):
        chw = imgs.transpose(0, 3, 1, 2).reshape(len(imgs), -1)
        if fmt == "bin":
            rec = np.concatenate([labels[:, None].astype(np.uint8), chw], 1)
            rec.tofile(os.path.join(folder, name + ".bin"))
        else:
            with open(os.path.join(folder, name), "wb") as f:
                pickle.dump({b"data": chw, b"labels": labels.tolist()}, f)


@pytest.mark.parametrize("fmt,sub", [("bin", "cifar-10-batches-bin"),
                                     ("py", "")])
def test_readers_on_written_batches(tmp_path, fmt, sub):
    imgs, labels = cifar.synthetic_cifar(18, seed=3)
    parts = [(imgs[3 * i:3 * i + 3], labels[3 * i:3 * i + 3])
             for i in range(6)]
    _write_batches(str(tmp_path / sub) if sub else str(tmp_path / "d"),
                   fmt, parts)
    root = str(tmp_path) if sub else str(tmp_path / "d")
    for train, want in ((True, slice(0, 15)), (False, slice(15, 18))):
        got = cifar.load_cifar10(root, train=train)
        ref = jcifar.load_cifar10(root, train=train)
        np.testing.assert_array_equal(got[0], imgs[want])
        np.testing.assert_array_equal(got[1], labels[want])
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
        assert got[1].dtype == ref[1].dtype == np.int32
    with pytest.raises(FileNotFoundError):
        cifar.load_cifar10(str(tmp_path / "nothing"))


COLOUR_OPS = {
    "BGRImgNormalizer": lambda I, seed: I.BGRImgNormalizer(
        (125.31, 122.95, 113.87), (62.99, 62.09, 66.70)),
    "HFlip": lambda I, seed: I.HFlip(seed=seed),
    "RandomCropper": lambda I, seed: I.RandomCropper(32, 32, pad=4,
                                                     seed=seed),
    "CenterCropper": lambda I, seed: I.CenterCropper(24, 20),
    "ColorJitter": lambda I, seed: I.ColorJitter(seed=seed),
    "Lighting": lambda I, seed: I.Lighting(0.1, seed=seed),
    "ChannelOrder": lambda I, seed: I.ChannelOrder("CHW"),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(COLOUR_OPS))
def test_colour_ops_bitwise(name, seed):
    """Twelve samples, HWC and (for the croppers) CHW, through one
    instance of each package's op in one thread."""
    imgs, labels = cifar.synthetic_cifar(12, seed=seed)
    feats = [imgs[i].astype(np.float32) for i in range(12)]
    if name in ("RandomCropper", "CenterCropper"):
        feats += [f.transpose(2, 0, 1).copy() for f in feats[:4]]
    mine = COLOUR_OPS[name](image, seed)
    ref = COLOUR_OPS[name](jimage, seed)
    got = list(mine(iter([Sample(f, np.int32(0)) for f in feats])))
    want = list(ref(iter([JSample(f, np.int32(0)) for f in feats])))
    assert len(got) == len(want) == len(feats)
    changed = 0
    for f, a, b in zip(feats, got, want):
        assert a.feature.dtype == b.feature.dtype
        np.testing.assert_array_equal(a.feature, b.feature)
        changed += a.feature.shape != f.shape or \
            not np.array_equal(a.feature, f)
    assert changed > 0  # each op did something to some sample


# ------------------------------------------------------------------ models
def _grads_match(model, params, state, jm, x, labels, training):
    xt = torch.from_numpy(x).requires_grad_(True)
    for p in model.parameters():
        p.requires_grad_(True)
    model.train(training)
    out = model(xt)
    loss = nn.ClassNLLCriterion().apply(out, torch.from_numpy(labels))
    loss.backward()
    loss = loss.detach()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p, xx):
        o, _ = jm.apply(p, state, xx, training=training)
        return jnn.ClassNLLCriterion().apply(o, jnp.asarray(labels)), o

    (jl, jout), (jg, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jparams, jnp.asarray(x))
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


def _batch(n, seed=0):
    imgs, labels = cifar.synthetic_cifar(n, seed=seed)
    x = (imgs.astype(np.float32) - np.float32(cifar.TRAIN_MEAN)) \
        / np.float32(cifar.TRAIN_STD)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)), labels


def _random_running_stats(state, rng):
    """BatchNorm running statistics away from their initial 0 and 1."""
    if "running_mean" in state:
        return {"running_mean": rng.normal(0, 0.2, state["running_mean"]
                                           .shape).astype(np.float32),
                "running_var": rng.uniform(0.5, 2.0, state["running_var"]
                                           .shape).astype(np.float32)}
    return {k: _random_running_stats(v, rng) for k, v in state.items()}


def test_vgg_layout_and_eval_grads_match_reference():
    model = vgg_for_cifar10(10).initialize(2)
    jm = jax_vgg(10)
    jp, js = jm.init(jax.random.PRNGKey(0))
    params, state = to_jax_params(model)
    shapes = lambda t: {k: v.shape for k, v in _flat(t).items()}  # noqa: E731
    assert shapes(params) == shapes(jp) and shapes(state) == shapes(js)
    assert [m.name for m in model.children()] == [m.name for m in jm.modules]
    assert sum(isinstance(m, nn.SpatialMaxPooling)
               for m in model.modules()) == 5
    state = _random_running_stats(state, np.random.default_rng(4))
    load_jax_params(model, params, state)
    x, labels = _batch(4)
    _grads_match(model, params, state, jm, x, labels, training=False)


def test_resnet20_matches_reference():
    """Eval mode (random running statistics): forward and every gradient.
    Training mode: the forward and the running statistics it updates.
    Training-mode gradients of the whole net are not held here: at batch
    4 they differ between the packages by 3-6% of a leaf's largest value
    on these images (1e-4 relative on some noise-added ones), as
    ResNet-50's do (ReLU inputs within rounding of 0, BatchNorm's backward
    cancelling over few rows); the K=4 VGG block below holds training-mode
    gradients through the updates."""
    model = resnet_cifar(20, class_num=10).initialize(5)
    jm = jax_resnet_cifar(20, class_num=10)
    params, state = to_jax_params(model)
    x, labels = _batch(4, seed=1)
    model.train()
    out = model(torch.from_numpy(x))
    jout, jstate = jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                            state, jnp.asarray(x), training=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    new_state = _flat(to_jax_params(model)[1])
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jstate)).items():
        np.testing.assert_allclose(new_state[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    state = _random_running_stats(state, np.random.default_rng(4))
    load_jax_params(model, params, state)
    _grads_match(model, params, state, jm, x, labels, training=False)


# ---------------------------------------------------------------- training
# VGG's training-mode gradients differ between the packages by 1-3% of a
# leaf's norm at these batches (features nearly constant across a few
# images reach BatchNorm1d and ReLU within rounding of 0), and SGD at the
# recipe's rate compounds that: after 8 steps two sound runs' losses
# differ by up to 20%.  So training is held a step at a time: the
# reference redoes each of the port's steps from the port's own
# parameters, BatchNorm statistics and velocity, and the reading is
# ||w_port - w_ref|| / ||w_port - w_before|| over all parameters (the
# share of the step's change the two disagree on).  Sound readings
# (tests/cifar_step_readings.py): up to 0.0204 for the K=4 block (six
# weight/data seeds at 1, 4 and 8 threads; the threads moved one reading,
# 0.0146 to 0.0127) and up to 0.0483 for the world-2 run (18 weight/data
# seeds; its workers run one thread); the planted faults read 0.474 and
# more.  The limit sits about 3x from both.
STEP_LIMIT = 0.15


def _no_dropout(model):
    mods = model.modules() if isinstance(model, torch.nn.Module) \
        else model.modules
    for m in mods:
        if type(m).__name__ == "Dropout":
            m.p = 0.0
    return model


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _jsgd():
    return joptim.SGD(0.01, momentum=0.9, dampening=0.0, weight_decay=5e-4,
                      learning_rate_schedule=joptim.EpochStep(25, 0.5))


def _norm(tree):
    return float(np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                             for v in tree.values())))


def _vgg_trace(sgd, start, samples):
    model = _no_dropout(vgg_for_cifar10(10))
    load_jax_params(model, *start)
    opt = type("TracingLocal", (W.Tracing, optim.LocalOptimizer), {})(
        model, W.cifar_pipeline(
            PORT, lambda s: DataSet.array(s, seed=5), samples, 8),
        nn.ClassNLLCriterion(), device="cpu")
    (opt.set_optim_method(sgd).set_steps_per_dispatch(4)
     .set_end_when(optim.max_iteration(8)).optimize())
    return opt, model


def test_vgg_local_optimizer_block_matches_reference():
    """8 iterations in K=4 blocks over 32 samples in batches of 8 (4 an
    epoch: the second block starts after the rollover and its shuffle),
    each step redone by the reference; two planted faults (the recipe's
    dampening=0 dropped, so the port damps by the momentum; ResNet's
    nesterov flag) must read over the limit."""
    from bigdl_tpu_torch.interop.jax_weights import jax_tree
    start = to_jax_params(vgg_for_cifar10(10).initialize(1))
    imgs, labels = cifar.synthetic_cifar(32)
    samples = cifar.to_samples(imgs, labels)
    jm = _no_dropout(jax_vgg(10))
    jsgd = _jsgd()

    @jax.jit
    def jstep(params, state, vel, x, y, lr, step):
        def loss_fn(p):
            o, _ = jm.apply(p, state, x, training=True,
                            rng=jax.random.PRNGKey(0))
            return jnn.ClassNLLCriterion().apply(o, y)
        loss, g = jax.value_and_grad(loss_fn)(params)
        new, _ = jsgd.update(g, params, {"velocity": vel}, lr, step)
        return loss, new

    def readings(sgd):
        opt, model = _vgg_trace(sgd, start, samples)
        assert len(opt.trace) == 8 and opt._dispatch_count == 2
        net = opt._run.net
        out = []
        for (p, b, v), x, y, lr, step, loss, after in opt.trace:
            def tree(d, kind="params"):
                return jax_tree(net, d, kind)
            jloss, new = jstep(tree(p), tree(b, "state"), tree(v), x, y,
                               lr, step)
            new = _flat(jax.tree_util.tree_map(np.asarray, new))
            diff = {k: after[k] - new[k] for k in after}
            change = {k: after[k] - p[k] for k in after}
            out.append((abs(loss - float(jloss)) / float(jloss),
                        _norm(diff) / _norm(change)))
        for k, w in model.named_parameters():
            np.testing.assert_array_equal(w.detach().numpy(),
                                          opt.trace[-1][-1][k])
        return out

    sound = readings(W.vgg_sgd())
    damped = readings(optim.SGD(0.01, momentum=0.9, weight_decay=5e-4,
                                learning_rate_schedule=optim.EpochStep(
                                    25, 0.5)))
    nesterov = readings(optim.SGD(0.01, momentum=0.9, dampening=0.0,
                                  nesterov=True, weight_decay=5e-4,
                                  learning_rate_schedule=optim.EpochStep(
                                      25, 0.5)))
    print("step readings (loss rel, update share): sound",
          [f"{a:.1e}/{b:.3f}" for a, b in sound],
          "damped", max(b for _, b in damped),
          "nesterov", max(b for _, b in nesterov))
    assert max(a for a, _ in sound) < 1e-4
    assert max(b for _, b in sound) < STEP_LIMIT
    assert max(b for _, b in damped) > STEP_LIMIT
    assert max(b for _, b in nesterov) > STEP_LIMIT


def _update_share(after, new, before):
    return _norm({k: after[k] - new[k] for k in after}) \
        / _norm({k: after[k] - before[k] for k in after})


def test_vgg_world2_distri_optimizer_matches_reference(devices):
    """A spawned world-2 gloo run of 3 iterations at global batch 8 (4 a
    rank).  The reference's DistriOptimizer on 2 virtual devices takes the
    first step from the same start; the reference's step as that
    optimizer arranges it (each device's gradient from its own rows, with
    its own BatchNorm statistics, averaged; one SGD update) redoes every
    one of the port's steps from the port's state.  Each within the step
    limit, each loss within 1e-4 (readings up to 1.5e-5: BatchNorm over 4
    rows of 1x1 features)."""
    import tempfile
    from bigdl_tpu_torch.interop.jax_weights import jax_tree
    start = to_jax_params(vgg_for_cifar10(10).initialize(6))
    with tempfile.TemporaryDirectory() as tmp:
        (rank0, rank1) = W.run_world(2, tmp, start[0], {"vgg": {}},
                                     fn=W.train_vgg)
    trace = rank0["vgg"]["trace"]
    assert len(trace) == 3
    for a, b in zip(trace, rank1["vgg"]["trace"]):
        assert a[5] == b[5]  # the averaged loss
        for k, v in a[-1].items():
            np.testing.assert_array_equal(b[-1][k], v)
    jm = _no_dropout(jax_vgg(10))
    jsgd = _jsgd()

    @jax.jit
    def jstep(params, state, vel, xs, ys, lr, step):
        def loss_fn(p, x, y):
            o, _ = jm.apply(p, state, x, training=True,
                            rng=jax.random.PRNGKey(0))
            return jnn.ClassNLLCriterion().apply(o, y)
        losses, gs = jax.vmap(jax.value_and_grad(loss_fn),
                              in_axes=(None, 0, 0))(params, xs, ys)
        g = jax.tree_util.tree_map(lambda a: a.mean(0), gs)
        new, _ = jsgd.update(g, params, {"velocity": vel}, lr, step)
        return losses.mean(), new

    # the reference's own DistriOptimizer, one step
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    imgs, labels = cifar.synthetic_cifar(32)
    jopt = (_recording(joptim.DistriOptimizer)(
        jm, W.cifar_pipeline(REF, JDataSet.array,
                             jcifar.to_samples(imgs, labels), 8),
        jnn.ClassNLLCriterion(),
        mesh=JMesh(np.array(devices[:2]), ("data",)), grad_wire_dtype="f32")
        .set_optim_method(_jsgd()).set_end_when(joptim.max_iteration(1)))
    jopt.optimize()
    ref1 = _flat(jax.tree_util.tree_map(np.asarray, jm._params))
    net = vgg_for_cifar10(10)
    readings, losses = [], []
    for j, (a, b) in enumerate(zip(trace, rank1["vgg"]["trace"])):
        (p, buf, v), x, y, lr, step, loss, after = a
        def tree(d, kind="params"):
            return jax_tree(net, d, kind)
        jloss, new = jstep(tree(p), tree(buf, "state"), tree(v),
                           np.stack([x, b[1]]), np.stack([y, b[2]]), lr,
                           step)
        new = _flat(jax.tree_util.tree_map(np.asarray, new))
        losses.append(abs(loss - float(jloss)) / float(jloss))
        readings.append(_update_share(after, new, p))
        if j == 0:
            losses.append(abs(loss - jopt.losses[0]) / jopt.losses[0])
            readings.append(_update_share(after, ref1, p))
            # the functional step is the reference optimizer's step
            assert _update_share(new, ref1, p) < 1e-3
    print("world-2 update shares", readings, "loss rel", losses)
    assert max(readings) < STEP_LIMIT
    assert max(losses) < 1e-4

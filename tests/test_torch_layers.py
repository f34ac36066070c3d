"""Port layers against their JAX twins, weights carried across by
``load_jax_params``, and against the torch-float64 golden fixtures.

Tolerance ``rtol=1e-5, atol=1e-5*max|y|``: both sides compute in f32, but
PyTorch's convolution, pooling and reductions sum in another order than
XLA's, and the two BatchNorm epilogues round differently (XLA contracts
``x*scale + shift`` into an FMA).  The fixtures keep the reference
replay's own tolerance (f32 against a float64 oracle).
"""

import copy
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.resnet import resnet50 as jax_resnet50
from bigdl_tpu.models.resnet import resnet_cifar as jax_resnet_cifar
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.models import resnet50, resnet_cifar

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")


def _random_bn_stats(model, rng):
    """Non-trivial running statistics and affine parameters for every
    BatchNorm in ``model``."""
    for m in model.modules():
        if isinstance(m, nn.SpatialBatchNormalization):
            for t, lo, hi in ((m.running_mean, -0.3, 0.3),
                              (m.running_var, 0.5, 2.0),
                              (m.weight, 0.5, 1.5), (m.bias, -0.3, 0.3)):
                t.data.copy_(torch.from_numpy(
                    rng.uniform(lo, hi, m.n_output).astype(np.float32)))
    return model


def _pair(jmod, tmod, x, seed=0):
    """(JAX output, port output) for the same weights and input: weights
    drawn in the port, carried to JAX as numpy and loaded back into a
    fresh port module with ``load_jax_params``."""
    src = _random_bn_stats(copy.deepcopy(tmod).initialize(seed),
                           np.random.default_rng(seed))
    params, state = to_jax_params(src)
    load_jax_params(tmod, params, state).eval()
    yj = jax.jit(lambda p, s, x: jmod.apply(p, s, x)[0])(params, state, x)
    with torch.no_grad():
        yt = tmod(torch.from_numpy(x))
    return (jax.tree_util.tree_map(np.asarray, yj),
            [t.numpy() for t in yt] if isinstance(yt, tuple) else yt.numpy())


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# (name, args of both SpatialConvolution constructors, input shape)
CONVS = [
    ("1x1_s1", (16, 8, 1, 1, 1, 1, 0, 0), (2, 16, 9, 9)),
    ("1x1_s2", (16, 8, 1, 1, 2, 2, 0, 0), (2, 16, 9, 9)),
    ("3x3_s2_p1", (6, 8, 3, 3, 2, 2, 1, 1), (2, 6, 10, 10)),
    ("7x7_s2_p3", (3, 8, 7, 7, 2, 2, 3, 3), (2, 3, 20, 20)),
    ("same_s2", (4, 6, 3, 3, 2, 2, -1, -1), (2, 4, 10, 11)),
    ("dilated", (4, 6, 3, 3, 1, 1, 2, 2), (2, 4, 9, 9)),
]


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("name,args,shape", CONVS,
                         ids=[c[0] for c in CONVS])
def test_spatial_convolution(name, args, shape, bias):
    kw = dict(with_bias=bias)
    if name == "dilated":
        kw.update(dilation_w=2, dilation_h=2)
    yj, yt = _pair(jnn.SpatialConvolution(*args, **kw),
                   nn.SpatialConvolution(*args, **kw), _x(shape))
    assert yt.shape == yj.shape
    _close(yt, yj)


def test_grouped_convolution():
    yj, yt = _pair(jnn.SpatialConvolution(4, 6, 3, 3, n_group=2),
                   nn.SpatialConvolution(4, 6, 3, 3, n_group=2),
                   _x((2, 4, 8, 8)))
    _close(yt, yj)


def test_batchnorm_eval_with_running_stats():
    yj, yt = _pair(jnn.SpatialBatchNormalization(5),
                   nn.SpatialBatchNormalization(5), _x((3, 5, 4, 4)), seed=2)
    _close(yt, yj)


def test_batchnorm_training_mode_not_ported():
    bn = nn.SpatialBatchNormalization(3)
    with pytest.raises(NotImplementedError, match="training"):
        bn(torch.zeros(2, 3, 4, 4))


POOLS = [
    ("max_3x3_s2_p1", lambda m: m.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
     (2, 3, 9, 9)),
    ("max_ceil", lambda m: m.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True),
     (2, 3, 8, 8)),
    ("avg_7x7", lambda m: m.SpatialAveragePooling(7, 7, 7, 7), (2, 4, 7, 7)),
    ("avg_8x8", lambda m: m.SpatialAveragePooling(8, 8, 8, 8), (2, 4, 8, 8)),
    ("avg_excl_pad_ceil", lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False),
     (2, 3, 8, 8)),
]


@pytest.mark.parametrize("name,make,shape", POOLS, ids=[p[0] for p in POOLS])
def test_pooling(name, make, shape):
    yj, yt = _pair(make(jnn), make(nn), _x(shape))
    assert yt.shape == yj.shape
    _close(yt, yj)


def test_linear_relu_logsoftmax_reshape():
    jm = (jnn.Sequential().add(jnn.Reshape((12,))).add(jnn.Linear(12, 7))
          .add(jnn.ReLU()).add(jnn.LogSoftMax()))
    tm = (nn.Sequential().add(nn.Reshape((12,))).add(nn.Linear(12, 7))
          .add(nn.ReLU()).add(nn.LogSoftMax()))
    yj, yt = _pair(jm, tm, _x((5, 3, 2, 2)))
    _close(yt, yj)


def test_concat_table_and_cadd():
    def make(m):
        conv = m.SpatialConvolution(3, 3, 3, 3, 1, 1, 1, 1)
        table = m.ConcatTable().add(conv).add(m.Identity())
        return table, m.Sequential().add(table).add(m.CAddTable())

    jt, jm = make(jnn)
    tt, tm = make(nn)
    x = _x((2, 3, 6, 6))
    yj, yt = _pair(jm, tm, x)
    _close(yt, yj)
    tj, tp = _pair(jt, tt, x)
    assert len(tp) == 2
    _close(tp[0], tj[0])
    np.testing.assert_array_equal(tp[1], x)


def test_resnet_cifar_float_forward():
    yj, yt = _pair(jax_resnet_cifar(8), resnet_cifar(8),
                   _x((3, 3, 32, 32)), seed=3)
    _close(yt, yj)


def test_resnet50_state_dict_matches_jax_pytree():
    """Every JAX params/state leaf of ResNet-50 has a same-shaped tensor
    at the same dotted path, and nothing else."""
    params, state = jax.eval_shape(jax_resnet50().init, jax.random.PRNGKey(0))
    want = {}
    for tree in (params, state):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want[".".join(p.key for p in path)] = tuple(leaf.shape)
    model = resnet50()
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    # the exported trees have the reference's structure, empty dicts too
    assert (jax.tree_util.tree_structure(to_jax_params(model))
            == jax.tree_util.tree_structure((params, state)))
    n_conv = sum(isinstance(m, nn.SpatialConvolution) for m in model.modules())
    n_fc = sum(isinstance(m, nn.Linear) for m in model.modules())
    assert (n_conv, n_fc) == (53, 1)


def test_initialize_is_seeded_and_msra_scaled():
    a = resnet_cifar(8).initialize(torch.Generator().manual_seed(7))
    b = resnet_cifar(8).initialize(7)
    c = resnet_cifar(8).initialize(8)
    for (ka, va), (_, vb), (_, vc) in zip(a.state_dict().items(),
                                          b.state_dict().items(),
                                          c.state_dict().items()):
        assert torch.equal(va, vb), ka
    w_a, w_c = a[0][0].weight, c[0][0].weight  # stem conv, fan_in 27
    assert not torch.equal(w_a, w_c)
    assert abs(w_a.std().item() - (2 / 27) ** 0.5) < 0.1


def test_load_jax_params_refuses_mismatches():
    model = nn.Linear(4, 3)
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, {"weight": np.zeros((3, 4), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, {"weight": np.zeros((4, 3), np.float32),
                                "bias": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="counterpart"):
        load_jax_params(model, {"weight": np.zeros((3, 4), np.float32),
                                "bias": np.zeros(3, np.float32),
                                "gain": np.zeros(3, np.float32)})


# golden torch-float64 fixtures (tests/fixtures/generate_fixtures.py) that
# cover a ported layer: forward replay at the reference replay's tolerance
FIXTURES = {
    "spatial_convolution_pad_stride":
        lambda: nn.SpatialConvolution(3, 5, 3, 3, 2, 2, 1, 1),
    "spatial_convolution_grouped":
        lambda: nn.SpatialConvolution(4, 6, 3, 3, n_group=2),
    "spatial_dilated_convolution":
        lambda: nn.SpatialConvolution(3, 5, 3, 3, 1, 1, 2, 2,
                                      dilation_w=2, dilation_h=2),
    "spatial_max_pooling_ceil":
        lambda: nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True),
    "spatial_avg_pooling_pad":
        lambda: nn.SpatialAveragePooling(3, 3, 2, 2, 1, 1,
                                         count_include_pad=True),
    "spatial_batch_norm_eval": lambda: nn.SpatialBatchNormalization(4),
    "linear": lambda: nn.Linear(7, 5),
    "act_log_softmax": lambda: nn.LogSoftMax(),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_golden_fixture_forward(name):
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    state = {k[2:]: z[k] for k in z.files if k.startswith("s_")}
    model = load_jax_params(FIXTURES[name](), params, state).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(z["x"].astype(np.float32)))
    np.testing.assert_allclose(out.numpy(), z["out"], rtol=2e-4, atol=2e-5)

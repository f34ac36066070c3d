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

import jax.numpy as jnp  # noqa: E402

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


# BatchNorm in training mode against the reference's apply(training=True):
# forward, the gradients of sum(y * w) and the new running statistics.
# f32: rtol=1e-5 (outputs, statistics; the sums over N*H*W in another
# order) and 1e-4 for the gradients (the backward through the statistics
# subtracts nearly equal sums).  bf16 input: the folded scale and shift are
# rounded to bf16 on both sides, but PyTorch rounds x*scale and then the
# add while XLA fuses them: y and dx within 2^-6 relative (two bf16 ulps);
# a parameter gradient is a sum of bf16 products that cancel, so it is held
# within 2^-6 of the sum of its terms' magnitudes, per channel; the
# statistics, taken in f32 from the same bf16 values, within 1e-5.
BN_CASES = {
    "spatial_nchw": (lambda m: m.SpatialBatchNormalization(5), (4, 5, 3, 3)),
    "spatial_nhwc": (lambda m: m.SpatialBatchNormalization(5, format="NHWC"),
                     (4, 3, 3, 5)),
    "1d": (lambda m: m.BatchNormalization(6), (8, 6)),
}


def _bn_reference(jmod, params, state, x, w):
    def f(p, xx):
        y, new_state = jmod.apply(p, state, xx, training=True)
        return jax.numpy.sum(y.astype(np.float32) * w), (y, new_state)
    (_, (y, ns)), (dp, dx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, x)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(y), f32(dx), {k: f32(v) for k, v in dp.items()},
            {k: f32(v) for k, v in ns.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_training_matches_jax(case, dtype):
    make, shape = BN_CASES[case]
    rng = np.random.default_rng(11)
    tm = _random_bn_stats(make(nn), rng).train()
    params, state = to_jax_params(tm)
    x = (rng.normal(0.5, 2.0, shape)).astype(np.float32)
    w = rng.normal(0, 1, shape).astype(np.float32)
    jx = jax.numpy.asarray(x, getattr(jax.numpy, dtype))
    y_j, dx_j, dp_j, ns_j = _bn_reference(make(jnn), params, state, jx, w)

    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = tm(xt)
    assert y.dtype == xt.dtype
    (y.float() * torch.from_numpy(w)).sum().backward()
    got = {"y": y.detach().float().numpy(), "dx": xt.grad.float().numpy(),
           "weight": tm.weight.grad.numpy(), "bias": tm.bias.grad.numpy(),
           "running_mean": tm.running_mean.numpy(),
           "running_var": tm.running_var.numpy()}
    assert tm.running_mean.dtype == tm.running_var.dtype == torch.float32
    want = {"y": y_j, "dx": dx_j, **dp_j, **ns_j}
    # per channel, the sum of |w * x_hat| and of |w|: the terms of the
    # weight and bias gradients
    axes = tuple(i for i in range(x.ndim) if i != tm._channel_axis(x.ndim))
    xf = np.asarray(jx, np.float32)
    xhat = (xf - xf.mean(axes, keepdims=True)) / xf.std(axes, keepdims=True)
    terms = {"weight": np.abs(w * xhat).sum(axes), "bias": np.abs(w).sum(axes)}
    for k, v in want.items():
        if k.startswith("running"):
            rtol, atol = 1e-5, 1e-6 * np.abs(v).max()
        elif dtype == "float32":
            rtol = 1e-5 if k == "y" else 1e-4
            atol = 1e-5 * np.abs(v).max()
        elif k in ("y", "dx"):
            rtol, atol = 2 ** -6, 2 ** -6 * np.abs(v).max()
        else:
            err = np.abs(got[k] - v)
            assert np.all(err <= 2 ** -6 * terms[k]), (k, err, terms[k])
            continue
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


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


NHWC_LAYERS = [
    ("conv_3x3_s2_p1", lambda m: m.SpatialConvolution(
        6, 8, 3, 3, 2, 2, 1, 1, format="NHWC"), (2, 10, 10, 6)),
    ("conv_same_s2", lambda m: m.SpatialConvolution(
        4, 6, 3, 3, 2, 2, -1, -1, with_bias=False, format="NHWC"),
     (2, 10, 11, 4)),
    ("max_ceil", lambda m: m.SpatialMaxPooling(
        3, 3, 2, 2, ceil_mode=True, format="NHWC"), (2, 8, 8, 3)),
    ("avg_excl_pad_ceil", lambda m: m.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False,
        format="NHWC"), (2, 8, 8, 3)),
    ("bn_eval", lambda m: m.SpatialBatchNormalization(5, format="NHWC"),
     (3, 4, 4, 5)),
]


@pytest.mark.parametrize("name,make,shape", NHWC_LAYERS,
                         ids=[c[0] for c in NHWC_LAYERS])
def test_nhwc_layers(name, make, shape):
    """NHWC layers take and return (N, H, W, C), as the reference's do;
    the conv weight stays OIHW (channels_last in memory)."""
    yj, yt = _pair(make(jnn), make(nn), _x(shape))
    assert yt.shape == yj.shape
    _close(yt, yj)
    layer = make(nn)
    if name.startswith("conv"):
        assert layer.weight.shape[1:] == (shape[3], 3, 3)
        assert layer.weight.is_contiguous(memory_format=torch.channels_last)


def test_resnet_cifar_nhwc_forward():
    yj, yt = _pair(jax_resnet_cifar(8, format="NHWC"),
                   resnet_cifar(8, format="NHWC"), _x((3, 32, 32, 3)), seed=3)
    _close(yt, yj)


def test_resnet50_nhwc_state_dict_and_remat():
    params, state = jax.eval_shape(jax_resnet50(format="NHWC").init,
                                   jax.random.PRNGKey(0))
    want = {}
    for tree in (params, state):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want[".".join(p.key for p in path)] = tuple(leaf.shape)
    got = {k: tuple(v.shape)
           for k, v in resnet50(format="NHWC").state_dict().items()}
    assert got == want
    # Remat shares its block's tensors: the keys stay the reference's
    for remat in (True, "tails"):
        assert {k: tuple(v.shape) for k, v in resnet50(
            format="NHWC", remat=remat).state_dict().items()} == want
    with pytest.raises(ValueError, match="remat"):
        resnet50(remat="dots")
    with pytest.raises(ValueError, match="format"):
        nn.SpatialConvolution(3, 4, 3, 3, format="HWCN")


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


# the reference replay's training-mode and max-pool fixtures, forward and
# backward (gradients of sum(out)), at its tolerance
TRAIN_FIXTURES = {
    "spatial_batch_norm_train": lambda: nn.SpatialBatchNormalization(3),
    "batch_norm_1d_train": lambda: nn.BatchNormalization(6),
    "spatial_max_pooling_ceil":
        lambda: nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True),
}


@pytest.mark.parametrize("name", sorted(TRAIN_FIXTURES))
def test_golden_fixture_train_forward_backward(name):
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    state = {k[2:]: z[k] for k in z.files if k.startswith("s_")}
    model = load_jax_params(TRAIN_FIXTURES[name](), params, state).train()
    x = torch.from_numpy(z["x"].astype(np.float32)).requires_grad_(True)
    out = model(x)
    out.sum().backward()
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **tol)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], **tol)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), z[f"dp_{k}"], **tol,
                                   err_msg=k)
    for k, b in model.named_buffers():
        np.testing.assert_allclose(b.numpy(), z[f"ns_{k}"], **tol,
                                   err_msg=k)


# the fixtures of the layers the Keras slice brought, forward and backward
# (gradients of sum(out)) at the reference replay's tolerance: (module,
# {fixture parameter: port parameter}, eval mode)
NEW_LAYER_FIXTURES = {
    "recurrent_gru": (
        lambda: nn.Recurrent(nn.GRU(4, 6)),
        {k: f"cell.{k}" for k in ("w_gates", "b_gates", "w_cand",
                                  "b_cand")}, False),
    "bi_recurrent_lstm": (
        lambda: nn.BiRecurrent(nn.LSTM(3, 5), nn.LSTM(3, 5)),
        {f"{d}_{k}": f"{d}.cell.{k}" for d in ("fwd", "bwd")
         for k in ("weight", "bias")}, False),
    "spatial_separable_convolution": (
        lambda: nn.SpatialSeparableConvolution(3, 4, 2, 3, 3, pw=1, ph=1),
        {k: k for k in ("depth_weight", "point_weight", "bias")}, False),
    "upsampling_2d": (lambda: nn.UpSampling2D((2, 3)), {}, False),
    "temporal_max_pooling": (lambda: nn.TemporalMaxPooling(2, 2), {},
                             False),
    "maxout": (lambda: nn.Maxout(4, 3, 2), {"weight": "weight",
                                            "bias": "bias"}, False),
    "highway": (lambda: nn.Highway(5),
                {k: k for k in ("weight", "bias", "gate_weight",
                                "gate_bias")}, False),
    "batch_norm_1d_eval": (lambda: nn.BatchNormalization(6),
                           {"weight": "weight", "bias": "bias"}, True),
    "recurrent_lstm_peephole": (
        lambda: nn.Recurrent(nn.LSTMPeephole(3, 5)),
        {k: f"cell.{k}" for k in ("weight", "bias", "peep")}, False),
    "conv_lstm_peephole": (
        lambda: nn.Recurrent(nn.ConvLSTMPeephole(2, 4, 3, spatial=(5, 5),
                                                 with_peephole=False)),
        {k: f"cell.{k}" for k in ("weight", "bias")}, False),
    "conv_lstm_with_peephole": (
        lambda: nn.Recurrent(nn.ConvLSTMPeephole(2, 4, 3, spatial=(5, 5))),
        {k: f"cell.{k}" for k in ("weight", "bias", "peep")}, False),
}


@pytest.mark.parametrize("name", sorted(NEW_LAYER_FIXTURES))
def test_golden_fixture_new_layers(name):
    make, names, eval_mode = NEW_LAYER_FIXTURES[name]
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    model = make()
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    with torch.no_grad():
        for k, port_name in names.items():
            params[port_name].copy_(torch.from_numpy(
                z[f"p_{k}"].astype(np.float32)))
            params[port_name].requires_grad_(True)
        for k in z.files:
            if k.startswith("s_"):
                buffers[k[2:]].copy_(torch.from_numpy(
                    z[k].astype(np.float32)))
    model.train(not eval_mode)
    x = torch.from_numpy(z["x"].astype(np.float32)).requires_grad_(True)
    out = model(x)
    out.sum().backward()
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **tol)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], **tol)
    for k, port_name in names.items():
        np.testing.assert_allclose(params[port_name].grad.numpy(),
                                   z[f"dp_{k}"], **tol, err_msg=k)


# the nine layers the Keras wrappers build and the rest of the recurrent
# cells and wrappers (peepholes, ConvLSTM in 2-D and 3-D, RecurrentDecoder),
# against the reference's modules: forward and the gradients of sum(y * cotangent) (input and every
# parameter) from the same weights, rtol=1e-5 / 1e-4 of each array's
# largest value (recurrences of a few f32 steps in another order)
EXTRAS = {
    "GRU": (lambda m: m.Recurrent(m.GRU(3, 5)), (2, 6, 3)),
    "GRU-reverse": (lambda m: m.Recurrent(m.GRU(3, 5), reverse=True),
                    (2, 6, 3)),
    "BiRecurrent-LSTM": (lambda m: m.BiRecurrent(m.LSTM(3, 4), m.LSTM(3, 4)),
                         (2, 5, 3)),
    "BiRecurrent-GRU-add": (lambda m: m.BiRecurrent(m.GRU(3, 4),
                                                    merge="add"), (2, 5, 3)),
    "SpatialSeparableConvolution": (
        lambda m: m.SpatialSeparableConvolution(3, 5, 2, 3, 3, 2, 1, 1, 0),
        (2, 3, 9, 8)),
    "UpSampling2D": (lambda m: m.UpSampling2D((3, 2)), (2, 2, 3, 4)),
    "Cropping2D": (lambda m: m.Cropping2D((1, 2), (0, 1)), (2, 2, 6, 5)),
    "TemporalMaxPooling": (lambda m: m.TemporalMaxPooling(3, 2), (2, 9, 4)),
    "Maxout": (lambda m: m.Maxout(6, 4, 3), (5, 6)),
    "Highway": (lambda m: m.Highway(6), (4, 6)),
    "LSTMPeephole": (lambda m: m.Recurrent(m.LSTMPeephole(3, 4)), (2, 5, 3)),
    "ConvLSTMPeephole-even-kernel": (
        lambda m: m.Recurrent(m.ConvLSTMPeephole(2, 3, 2, spatial=(4, 5))),
        (2, 3, 2, 4, 5)),
    "ConvLSTMPeephole3D": (
        lambda m: m.Recurrent(m.ConvLSTMPeephole3D(2, 3, 3,
                                                   spatial=(3, 4, 4))),
        (2, 3, 2, 3, 4, 4)),
    "ConvLSTMPeephole3D-no-peephole": (
        lambda m: m.Recurrent(m.ConvLSTMPeephole3D(2, 3, 3, spatial=(3, 3, 3),
                                                   with_peephole=False)),
        (2, 2, 2, 3, 3, 3)),
    "RecurrentDecoder-LSTM": (lambda m: m.RecurrentDecoder(m.LSTM(4, 4), 5),
                              (3, 4)),
    "RecurrentDecoder-GRU": (lambda m: m.RecurrentDecoder(m.GRU(3, 3), 4),
                             (2, 3)),
}


@pytest.mark.parametrize("name", sorted(EXTRAS))
def test_extra_layer_forward_and_gradients_match_reference(name):
    make, shape = EXTRAS[name]
    tm = make(nn).initialize(5)
    params, state = to_jax_params(tm)
    jm = make(jnn)
    x = _x(shape, seed=2)
    cot = np.random.default_rng(9).normal(0, 1, tm(torch.from_numpy(x))
                                          .shape).astype(np.float32)

    def jloss(p, x):
        y, _ = jm.apply(p, state, x)
        return (y * cot).sum(), y

    (_, yj), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(params, x)
    for p in tm.parameters():
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = tm(xt)
    (yt * torch.from_numpy(cot)).sum().backward()
    _close(yt.detach().numpy(), np.asarray(yj))
    got = to_jax_params(tm)[0]

    def grads(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from grads(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    tgrads = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    from bigdl_tpu_torch.interop.jax_weights import _jax_names
    names = _jax_names(tm, "params")
    for k, g in grads(jax.tree_util.tree_map(np.asarray, gp)):
        np.testing.assert_allclose(tgrads[names[k]], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(gx)).max())
    assert got.keys() == params.keys()


def test_lookup_table_negative_ids_match_reference():
    """Ids in [-n, 0) count from the end, as the reference's ``jnp.take``
    reads them: the same rows forward and the weight gradient on the same
    rows (rtol=1e-6: one f32 sum of cotangents a row); an id at n is
    refused."""
    tm = nn.LookupTable(5, 3).initialize(4)
    params, state = to_jax_params(tm)
    jm = jnn.LookupTable(5, 3)
    ids = np.array([[-1, 0, -5], [4, -1, 2]], np.int32)
    cot = np.random.default_rng(9).normal(0, 1, (2, 3, 3)).astype(np.float32)

    def jloss(p):
        y, _ = jm.apply(p, state, jnp.asarray(ids))
        return (y * cot).sum(), y

    (_, yj), gp = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.weight.requires_grad_(True)
    yt = tm(torch.from_numpy(ids))
    (yt * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-6)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(gp["weight"]), rtol=1e-6)
    with pytest.raises(IndexError):
        tm(torch.tensor([5]))

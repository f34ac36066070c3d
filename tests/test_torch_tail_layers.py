"""The last layers of the port's ``nn/`` on the CPU, against the reference:
``nn/volumetric.py``, the rest of ``nn/spatial_extras.py`` (16 layers) and
of ``nn/tensor_extras.py`` (29 layers).

- The 19 golden torch-float64 fixtures the port had no layer for
  (``volumetric_*``, ``locally_connected_1d/2d``, ``mod2_*``, ``add_layer``,
  ``mul_layer``, ``cosine_layer``, ``euclidean_layer``,
  ``resize_bilinear_align``, ``spatial_within_channel_lrn``,
  ``upsampling_3d``), forward and backward, at the reference replay's
  tolerance (``rtol=2e-4, atol=2e-5``).
- Every new class against its ``bigdl_tpu`` twin on seeded inputs: the
  forward and the gradients of ``sum(out * cot)`` with respect to every
  float input and parameter, the parameters carried across by
  ``load_jax_params``, within ``rtol=1e-5, atol=1e-6`` (convolutions,
  normalizations and products over many terms ``rtol=1e-4, atol=1e-5``);
  and the initialized trees of both packages of the same shapes.  Sound
  readings stay under 2e-6 of the largest value; planted faults (a
  half-pixel resize, a patch order of (row, column, channel), the divisive
  normalization without its mean floor, a full convolution cut at the
  wrong end) read above 1e-2, so each tolerance sits between them.
- The penalties of the penalty layers against the reference's, the
  stochastic layers' training-mode statistics (their noise comes from
  the layer's own ``torch.Generator``, not JAX's numbers), and f16
  forwards of the new convolutions against f32.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_shape_ops import (_flat, _is_float, _leaves,  # noqa: E402
                                  _map, _normal, _positive)

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
TOL = dict(rtol=2e-4, atol=2e-5)
CLOSE = dict(rtol=1e-5, atol=1e-6)
SUM_CLOSE = dict(rtol=1e-4, atol=1e-5)
FAULT_FLOOR = 1e-2  # a planted fault's error, as a share of max|want|

FIXTURES = {
    "volumetric_convolution": lambda m: m.VolumetricConvolution(
        3, 4, 2, 3, 3, 1, 2, 2, 0, 1, 1),
    "volumetric_max_pooling": lambda m: m.VolumetricMaxPooling(2, 2, 2),
    "volumetric_avg_pooling": lambda m: m.VolumetricAveragePooling(2, 2, 2),
    "volumetric_full_convolution": lambda m: m.VolumetricFullConvolution(
        4, 3, 2, 3, 3, 2, 2, 2, 0, 1, 1, 1, 0, 0),
    "locally_connected_2d": lambda m: m.LocallyConnected2D(
        3, 6, 6, 4, 3, 3),
    "locally_connected_1d": lambda m: m.LocallyConnected1D(7, 5, 4, 3, 2),
    "spatial_within_channel_lrn": lambda m: m.SpatialWithinChannelLRN(5),
    "upsampling_3d": lambda m: m.UpSampling3D((2, 2, 2)),
    "resize_bilinear_align": lambda m: m.ResizeBilinear(
        8, 9, align_corners=True),
    "cosine_layer": lambda m: m.Cosine(4, 6),
    "euclidean_layer": lambda m: m.Euclidean(4, 6),
    "add_layer": lambda m: m.Add(6),
    "mul_layer": lambda m: m.Mul(),
    "mod2_bilinear": lambda m: m.Bilinear(3, 4, 5),
    "mod2_mm": lambda m: m.MM(),
    "mod2_dot_product": lambda m: m.DotProduct(),
    "mod2_pairwise_distance": lambda m: m.PairwiseDistance(norm=2),
    "mod2_cosine_distance": lambda m: m.CosineDistance(),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    params = {k[2:]: z[k].astype(np.float32) for k in z.files
              if k.startswith("p_")}
    model = load_jax_params(FIXTURES[name](nn), params)
    for p in model.parameters():
        p.requires_grad_(True)
    keys = ("x1", "x2") if name.startswith("mod2_") else ("x",)
    xs = [torch.from_numpy(z[k].astype(np.float32)).requires_grad_(True)
          for k in keys]
    out = model(tuple(xs) if len(xs) == 2 else xs[0])
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **TOL)
    for k, x in zip(keys, xs):
        np.testing.assert_allclose(x.grad.numpy(), z["d" + k], **TOL,
                                   err_msg=f"d{k}")
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), z[f"dp_{k}"], **TOL,
                                   err_msg=k)


def _pair(a, b, seed=0):
    return _normal(*a, seed=seed), _normal(*b, seed=seed + 1)


CONN = [[0, 0], [1, 0], [1, 1], [2, 1], [0, 2], [2, 2]]

# name: (factory over a package's nn, input maker)
CASES = {
    # volumetric
    "VolumetricConvolution": (lambda m: m.VolumetricConvolution(
        3, 4, 2, 3, 3, 1, 2, 2, 0, 1, 1), lambda: _normal(2, 3, 5, 7, 7)),
    "VolumetricMaxPooling": (lambda m: m.VolumetricMaxPooling(2, 2, 2),
                             lambda: _normal(2, 2, 4, 6, 6)),
    # a pad above half the window, which F.max_pool3d refuses
    "VolumetricMaxPooling_pad": (lambda m: m.VolumetricMaxPooling(
        2, 3, 3, 1, 2, 2, 1, 2, 2), lambda: _normal(1, 2, 4, 7, 6)),
    "VolumetricAveragePooling_pad": (lambda m: m.VolumetricAveragePooling(
        3, 3, 3, 2, 2, 2, 1, 1, 1), lambda: _normal(2, 2, 5, 7, 7)),
    "VolumetricAveragePooling_exclude": (
        lambda m: m.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1,
                                             count_include_pad=False),
        lambda: _normal(2, 2, 5, 7, 7)),
    "VolumetricFullConvolution": (lambda m: m.VolumetricFullConvolution(
        4, 3, 2, 3, 3, 2, 2, 2, 0, 1, 1, 1, 0, 0),
        lambda: _normal(1, 4, 3, 4, 4)),
    # adj at or above the stride, a pad above kernel - 1
    "VolumetricFullConvolution_adj": (lambda m: m.VolumetricFullConvolution(
        2, 3, 2, 2, 2, 2, 2, 2, 2, 0, 1, 3, 2, 1),
        lambda: _normal(1, 2, 3, 3, 4)),
    # spatial extras
    "SpatialDilatedConvolution": (lambda m: m.SpatialDilatedConvolution(
        3, 4, 3, 3, 1, 1, 2, 2, 2, 2), lambda: _normal(2, 3, 9, 9)),
    "SpatialShareConvolution": (lambda m: m.SpatialShareConvolution(
        3, 4, 3, 3, 2, 2, 1, 1), lambda: _normal(2, 3, 7, 7)),
    "SpatialConvolutionMap": (lambda m: m.SpatialConvolutionMap(
        CONN, 3, 3, 1, 1, 1, 1), lambda: _normal(2, 3, 6, 6)),
    "LocallyConnected2D": (lambda m: m.LocallyConnected2D(3, 6, 6, 4, 3, 3),
                           lambda: _normal(2, 3, 6, 6)),
    "LocallyConnected2D_strided": (lambda m: m.LocallyConnected2D(
        2, 7, 5, 3, 3, 2, 2, 1, 1, 0), lambda: _normal(2, 2, 5, 7)),
    "LocallyConnected1D": (lambda m: m.LocallyConnected1D(8, 5, 4, 3, 2),
                           lambda: _normal(2, 8, 5)),
    "SpatialWithinChannelLRN": (lambda m: m.SpatialWithinChannelLRN(3, 0.5),
                                lambda: _normal(2, 3, 6, 6)),
    "SpatialSubtractiveNormalization": (
        lambda m: m.SpatialSubtractiveNormalization(3),
        lambda: _normal(2, 3, 11, 12)),
    "SpatialSubtractiveNormalization_kernel": (
        lambda m: m.SpatialSubtractiveNormalization(
            2, np.arange(1, 16, dtype=np.float32).reshape(3, 5)),
        lambda: _normal(2, 2, 6, 7)),
    "SpatialDivisiveNormalization": (
        lambda m: m.SpatialDivisiveNormalization(3),
        lambda: _normal(2, 3, 11, 12)),
    "SpatialContrastiveNormalization": (
        lambda m: m.SpatialContrastiveNormalization(2),
        lambda: _normal(2, 2, 10, 10)),
    "SpatialDropout1D": (lambda m: m.SpatialDropout1D(0.4),
                         lambda: _normal(2, 5, 3)),
    "SpatialDropout2D": (lambda m: m.SpatialDropout2D(0.4),
                         lambda: _normal(2, 3, 4, 4)),
    "SpatialDropout3D": (lambda m: m.SpatialDropout3D(0.4),
                         lambda: _normal(2, 3, 2, 3, 3)),
    "UpSampling1D": (lambda m: m.UpSampling1D(3), lambda: _normal(2, 4, 3)),
    "UpSampling3D": (lambda m: m.UpSampling3D((2, 1, 3)),
                     lambda: _normal(1, 2, 2, 3, 2)),
    "ResizeBilinear": (lambda m: m.ResizeBilinear(7, 9),
                       lambda: _normal(2, 3, 4, 5)),
    "ResizeBilinear_align": (lambda m: m.ResizeBilinear(7, 9, True),
                             lambda: _normal(2, 3, 4, 5)),
    "ResizeBilinear_down": (lambda m: m.ResizeBilinear(3, 2),
                            lambda: _normal(1, 2, 7, 5)),
    "Cropping3D": (lambda m: m.Cropping3D((1, 0), (0, 1), (1, 1)),
                   lambda: _normal(2, 2, 4, 4, 5)),
    # tensor extras
    "MM": (lambda m: m.MM(), lambda: _pair((2, 3, 4), (2, 4, 5))),
    "MM_trans": (lambda m: m.MM(True, True),
                 lambda: _pair((2, 4, 3), (2, 5, 4))),
    "MV": (lambda m: m.MV(), lambda: _pair((2, 3, 4), (2, 4))),
    "MV_trans": (lambda m: m.MV(True), lambda: _pair((2, 4, 3), (2, 4))),
    "DotProduct": (lambda m: m.DotProduct(), lambda: _pair((3, 5), (3, 5))),
    "CrossProduct": (lambda m: m.CrossProduct(),
                     lambda: tuple(_normal(2, 4, seed=s) for s in range(4))),
    "PairwiseDistance": (lambda m: m.PairwiseDistance(),
                         lambda: _pair((3, 5), (3, 5))),
    "PairwiseDistance_l1": (lambda m: m.PairwiseDistance(1),
                            lambda: _pair((3, 5), (3, 5))),
    "CosineDistance": (lambda m: m.CosineDistance(),
                       lambda: _pair((3, 5), (3, 5))),
    "Bilinear": (lambda m: m.Bilinear(3, 4, 5),
                 lambda: _pair((2, 3), (2, 4))),
    "Cosine": (lambda m: m.Cosine(4, 6), lambda: _normal(5, 4)),
    "Euclidean": (lambda m: m.Euclidean(4, 6), lambda: _normal(5, 4)),
    "Add": (lambda m: m.Add(6), lambda: _normal(4, 6)),
    "Mul": (lambda m: m.Mul(), lambda: _normal(4, 6)),
    "MixtureTable": (lambda m: m.MixtureTable(),
                     lambda: _pair((3, 4), (3, 4, 5))),
    "MixtureTable_list": (lambda m: m.MixtureTable(), lambda: (
        _normal(3, 4), tuple(_normal(3, 5, seed=s) for s in range(1, 5)))),
    "MaskedSelect": (lambda m: m.MaskedSelect(), lambda: (
        _normal(3, 4), (_normal(3, 4, seed=7) > 0).astype(np.int32))),
    "Reverse": (lambda m: m.Reverse(1), lambda: _normal(2, 3, 4)),
    "Tile": (lambda m: m.Tile(1, 3), lambda: _normal(2, 3)),
    "Negative": (lambda m: m.Negative(), lambda: _normal(2, 3)),
    "InferReshape": (lambda m: m.InferReshape((0, -1, 2)),
                     lambda: _normal(3, 4, 6)),
    "InferReshape_batch": (lambda m: m.InferReshape((-1, 3), True),
                           lambda: _normal(2, 4, 6)),
    "NarrowTable": (lambda m: m.NarrowTable(1, 2),
                    lambda: tuple(_normal(2, 3, seed=s) for s in range(4))),
    "NarrowTable_one": (lambda m: m.NarrowTable(2),
                        lambda: tuple(_normal(2, 3, seed=s)
                                      for s in range(4))),
    "BifurcateSplitTable": (lambda m: m.BifurcateSplitTable(1),
                            lambda: _normal(2, 5, 3)),
    "Bottle": (lambda m: m.Bottle(m.Linear(4, 3)), lambda: _normal(2, 5, 4)),
    "Bottle_3": (lambda m: m.Bottle(m.Linear(4, 3), 3),
                 lambda: _normal(2, 5, 4)),
    "MapTable": (lambda m: m.MapTable(m.Linear(4, 3)),
                 lambda: tuple(_normal(2, 4, seed=s) for s in range(3))),
    "GradientReversal": (lambda m: m.GradientReversal(0.5),
                         lambda: _normal(2, 3)),
    "GaussianDropout": (lambda m: m.GaussianDropout(0.3),
                        lambda: _normal(2, 3)),
    "GaussianNoise": (lambda m: m.GaussianNoise(0.3), lambda: _normal(2, 3)),
    "L1Penalty": (lambda m: m.L1Penalty(0.1), lambda: _normal(2, 3)),
    "NegativeEntropyPenalty": (lambda m: m.NegativeEntropyPenalty(),
                               lambda: _positive(2, 3)),
    "ActivityRegularization": (lambda m: m.ActivityRegularization(0.1, 0.2),
                               lambda: _normal(2, 3)),
    "BinaryThreshold": (lambda m: m.BinaryThreshold(0.1),
                        lambda: _normal(2, 3)),
}
SUMS = {"VolumetricConvolution", "VolumetricFullConvolution",
        "VolumetricFullConvolution_adj", "VolumetricAveragePooling_pad",
        "VolumetricAveragePooling_exclude", "SpatialDilatedConvolution",
        "SpatialShareConvolution", "SpatialConvolutionMap",
        "LocallyConnected2D", "LocallyConnected2D_strided",
        "LocallyConnected1D", "SpatialWithinChannelLRN",
        "SpatialSubtractiveNormalization",
        "SpatialSubtractiveNormalization_kernel",
        "SpatialDivisiveNormalization", "SpatialContrastiveNormalization",
        "Bilinear", "MV", "MV_trans", "MM", "MM_trans"}


def port_run(pm, x, cots):
    """(out leaves, input-gradient leaves, param gradients by name) of the
    port module, in eval mode (the reference's ``apply`` default)."""
    pm.eval()
    for p in pm.parameters():
        p.requires_grad_(True)

    def tensor(a):
        t = torch.from_numpy(np.array(a))
        return t.requires_grad_(True) if t.is_floating_point() else t

    def build(a):
        return type(a)(build(e) for e in a) \
            if isinstance(a, (tuple, list)) else tensor(a)
    tx = build(x)
    out = pm(tx)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(_leaves(out), cots))
    if loss.requires_grad:  # a step function's output has no gradient
        loss.backward()
    return ([o.detach().numpy() for o in _leaves(out)],
            [np.zeros(t.shape, np.float32) if t.grad is None
             else t.grad.numpy() for t in _leaves(tx) if t.requires_grad],
            {k: p.grad.numpy() for k, p in pm.named_parameters()})


# cases whose reference does not trace (a data-dependent shape, padding
# read from the input): run op by op
EAGER = {"MaskedSelect", "VolumetricAveragePooling_pad"}


def reference_run(jm, x, cot_seed=9, jit=True):
    """(out leaves, input-gradient leaves, param gradients, params,
    cotangents) of the reference module on ``x``: the forward and the
    gradients of ``sum(out * cot)`` in one call, jitted unless ``jit`` is
    false."""
    params, state = jm.init(jax.random.PRNGKey(0))
    jx = _map(jnp.asarray, x)
    shapes = jm.apply(params, state, jx)[0] if not jit else jax.eval_shape(
        lambda p, a: jm.apply(p, state, a)[0], params, jx)
    cots = [_normal(*o.shape, seed=cot_seed + i)
            for i, o in enumerate(_leaves(shapes))]
    floats = [i for i, a in enumerate(_leaves(x)) if _is_float(a)]

    def loss(p, *fl):
        leaves = list(_leaves(jx))
        for i, v in zip(floats, fl):
            leaves[i] = v
        it = iter(leaves)
        y, _ = jm.apply(p, state, _map(lambda _: next(it), x))
        return sum(jnp.sum(o * c) for o, c in zip(_leaves(y), cots)), y

    both = jax.value_and_grad(loss, argnums=tuple(range(len(floats) + 1)),
                              has_aux=True)
    (_, out), grads = (jax.jit(both) if jit else both)(
        params, *[_leaves(jx)[i] for i in floats])
    return ([np.asarray(o) for o in _leaves(out)],
            [np.asarray(g) for g in grads[1:]],
            jax.tree_util.tree_map(np.asarray, grads[0]),
            jax.tree_util.tree_map(np.asarray, params), cots)


@functools.lru_cache(maxsize=None)
def case_run(name):
    """(input, :func:`reference_run`) of case ``name``, once a process:
    the planted faults reuse their case's reference."""
    make, inputs = CASES[name]
    x = inputs()
    return x, reference_run(make(jnn), x, jit=name not in EAGER)


def reading(name, port=None):
    """(largest error of any output or gradient as a share of its
    reference's max|.|, and whether all are within the case's tolerance)
    of the port (or ``port``, a patched twin) against the reference."""
    make = CASES[name][0]
    x, (want_out, want_dx, want_dp, params, cots) = case_run(name)
    pm = load_jax_params(port or make(nn), params)
    got_out, got_dx, got_dp = port_run(pm, x, cots)
    tol = SUM_CLOSE if name in SUMS else CLOSE
    pairs = list(zip(got_out, want_out)) + list(zip(got_dx, want_dx))
    want_dp = _flat(want_dp)
    assert sorted(got_dp) == sorted(want_dp), name
    pairs += [(got_dp[k], w) for k, w in want_dp.items()]
    assert len(got_out) == len(want_out) and len(got_dx) == len(want_dx)
    worst, ok = 0.0, True
    for g, w in pairs:
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30) if w.size else 1.0
        if w.size:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
        ok = ok and np.allclose(g, w, **tol)
    return worst, ok


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    worst, ok = reading(name)
    assert ok and worst < 2e-6, (name, worst)


# one case a class: its first
CLASS_CASES = {n.split("_")[0]: n for n in sorted(CASES, reverse=True)}


@pytest.mark.parametrize("name", sorted(CLASS_CASES))
def test_initialized_trees_agree(name):
    """The packages' initialized trees have the same leaves and shapes
    (the port's ``initialize`` draws them, the reference's ``init``)."""
    make = CASES[CLASS_CASES[name]][0]
    params, state = make(jnn).init(jax.random.PRNGKey(0))
    got_p, got_s = to_jax_params(make(nn).initialize(0))
    for got, want in ((got_p, params), (got_s, state)):
        want = _flat(jax.tree_util.tree_map(np.asarray, want))
        assert {k: v.shape for k, v in _flat(got).items()} == \
            {k: v.shape for k, v in want.items()}, name


class HalfPixelResize(nn.ResizeBilinear):
    def forward(self, x):
        return F.interpolate(x, self.out_hw, mode="bilinear",
                             align_corners=False)


class RowMajorPatches(nn.LocallyConnected2D):
    def forward(self, x):
        oh, ow = self.out_hw
        n, c = x.shape[:2]
        p = F.unfold(x, self.kernel, padding=self.pad, stride=self.stride)
        p = p.reshape(n, c, -1, oh, ow).transpose(1, 2).reshape(n, -1, oh, ow)
        return torch.einsum("nkhw,hwok->nohw", p, self.weight) + self.bias


class NoMeanFloor(nn.SpatialDivisiveNormalization):
    def forward(self, x):
        return x / torch.sqrt(torch.clamp(self._local_mean(x * x), min=1e-8))


class CutAtTheStart(nn.VolumetricFullConvolution):
    def forward(self, x):
        full = F.conv_transpose3d(x, self.weight, stride=self.stride)
        pt, ph, pw = self.pad
        at, ah, aw = self.adj
        t, h, w = full.shape[2:]
        y = F.pad(full, (0, aw, 0, ah, 0, at))[
            :, :, :t - 2 * pt + at, :h - 2 * ph + ah, :w - 2 * pw + aw]
        return y + self.bias[None, :, None, None, None]


FAULTS = {
    "ResizeBilinear": lambda: HalfPixelResize(7, 9),
    "LocallyConnected2D": lambda: RowMajorPatches(3, 6, 6, 4, 3, 3),
    "SpatialDivisiveNormalization": lambda: NoMeanFloor(3),
    "VolumetricFullConvolution_adj": lambda: CutAtTheStart(
        2, 3, 2, 2, 2, 2, 2, 2, 2, 0, 1, 3, 2, 1),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_planted_faults_exceed_the_tolerance(name):
    worst, ok = reading(name, FAULTS[name]())
    assert not ok and worst > FAULT_FLOOR, (name, worst)


@pytest.mark.parametrize("name,x", [
    ("L1Penalty", _normal(2, 3)), ("NegativeEntropyPenalty", _positive(2, 3)),
    ("ActivityRegularization", _normal(2, 3))])
def test_penalties_match_reference(name, x):
    make = CASES[name][0]
    want = float(make(jnn).penalty(jnp.asarray(x)))
    want_g = np.asarray(jax.grad(make(jnn).penalty)(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    got = make(nn).penalty(t)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-6)


def test_l1_penalty_size_average():
    x = np.arange(-4, 4, dtype=np.float32).reshape(4, 2)
    want = float(jnn.L1Penalty(0.1, True).penalty(jnp.asarray(x)))
    got = float(nn.L1Penalty(0.1, True).penalty(torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-6) and want == \
        pytest.approx(0.4)


def _generated(m, seed=0):
    m.generator = torch.Generator().manual_seed(seed)
    return m.train()


def test_spatial_dropouts_drop_whole_maps_without_rescale():
    x = torch.ones(64, 32, 3, 4)
    y = _generated(nn.SpatialDropout2D(0.25))(x)
    per_map = y.reshape(64, 32, -1)
    assert set(per_map.unique().tolist()) <= {0.0, 1.0}
    assert (per_map.amin(-1) == per_map.amax(-1)).all()  # whole maps
    assert abs(float(per_map[..., 0].mean()) - 0.75) < 0.05
    y1 = _generated(nn.SpatialDropout1D(0.5))(torch.ones(16, 6, 40))
    assert (y1.amin(1) == y1.amax(1)).all()  # one mask over the steps
    with pytest.raises(ValueError, match="generator"):
        nn.SpatialDropout3D(0.5).train()(torch.ones(2, 2, 2, 2, 2))


def test_gaussian_layers_statistics_and_generators():
    x = torch.full((200, 200), 2.0)
    y = _generated(nn.GaussianDropout(0.2))(x)
    assert abs(float(y.mean()) - 2.0) < 0.02
    assert abs(float((y / 2.0).std()) - (0.2 / 0.8) ** 0.5) < 0.01
    n = _generated(nn.GaussianNoise(0.5))(x)
    assert abs(float((n - x).std()) - 0.5) < 0.01
    mean, log_var = torch.zeros(400, 100), torch.full((400, 100), 2.0)
    s = _generated(nn.GaussianSampler(), 3)((mean, log_var))
    eps = torch.randn(400, 100, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(s, torch.exp(log_var * 0.5) * eps)
    assert torch.equal(nn.GaussianNoise(0.5).eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        nn.GaussianSampler()((mean, log_var))


def test_stochastic_layers_get_generators_in_training():
    """``LocalOptimizer`` seeds the new stochastic layers as it seeds
    Dropout: training runs, and twice from one seed gives one result."""
    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    rng = np.random.default_rng(0)
    samples = [Sample(rng.normal(size=(3, 4, 4)).astype(np.float32),
                      np.int64(i % 2)) for i in range(16)]

    def run():
        model = nn.Sequential(nn.SpatialDropout2D(0.3),
                              nn.GaussianNoise(0.1), nn.Reshape((48,)),
                              nn.GaussianDropout(0.2), nn.Linear(48, 2),
                              nn.LogSoftMax()).initialize(0)
        opt = optim.LocalOptimizer(
            model, DataSet.array(samples) >> SampleToMiniBatch(8),
            nn.ClassNLLCriterion(), device="cpu")
        opt.set_end_when(optim.max_iteration(3)).optimize()
        return model[4].weight.detach().clone()
    torch.testing.assert_close(run(), run(), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["VolumetricConvolution",
                                  "VolumetricFullConvolution",
                                  "LocallyConnected2D", "Bilinear"])
def test_f16_forward_matches_f32(name):
    """The layers compute in f16 (``set_compute_dtype(torch.float16)``)
    within f16's rounding of their f32 forward."""
    make, inputs = CASES[name]
    m = make(nn).initialize(0).eval()
    x = inputs()
    xs = tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple) \
        else torch.from_numpy(x)
    want = m(xs)
    half = lambda t: t.half()  # noqa: E731
    got = m.half()(tuple(map(half, xs)) if isinstance(xs, tuple)
                   else half(xs))
    assert got.dtype == torch.float16
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=1e-2 * float(want.abs().max()))

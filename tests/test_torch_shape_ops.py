"""The shape and table layers, ``Lambda``/``Echo`` and the layers
``CMul``, ``CAdd``, ``Normalize``, ``NormalizeScale``,
``TemporalConvolution`` and ``SpatialFullConvolution`` of the port on the
CPU, against the reference.

- Every class against its ``bigdl_tpu`` twin on seeded inputs: the
  forward, and the gradients of ``sum(out * cot)`` (``cot`` a seeded
  cotangent) with respect to every float input and parameter, the
  parameters carried across by ``load_jax_params``; within ``rtol=1e-5,
  atol=1e-6`` (convolutions and the normalizations ``rtol=1e-4,
  atol=1e-5``: f32 sums in another order, scaled by 20 in
  ``NormalizeScale``).  Ties are planted where the gradient at a tie differs between
  the libraries (``Max``, ``Min``, ``CMaxTable``, ``CMinTable``,
  ``Clamp`` at its bounds, ``Abs`` at 0).
- The golden torch-float64 fixtures ``cadd``, ``cmul``, ``power``,
  ``clamp``, ``temporal_convolution`` and ``spatial_full_convolution``,
  forward and backward, at the reference replay's tolerance (``rtol=2e-4,
  atol=2e-5``).
- Named tie cases whose expected gradients ``torch.max(x, dim)`` and
  ``torch.clamp`` would miss, and ``SpatialFullConvolution`` at an
  ``adj`` at or above its stride, which ``F.conv_transpose2d`` refuses.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
TOL = dict(rtol=2e-4, atol=2e-5)
CLOSE = dict(rtol=1e-5, atol=1e-6)
SUM_CLOSE = dict(rtol=1e-4, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(*shape, seed=0):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _positive(*shape, seed=0):
    return _rng(seed).uniform(0.5, 2.0, size=shape).astype(np.float32)


def _tied(*shape, seed=0):
    """Normal values, every row's first two entries along the last axis
    equal (a tie for Max/Min over it) and a few exact zeros."""
    x = _normal(*shape, seed=seed)
    x[..., 1] = x[..., 0]
    x.reshape(-1)[::7] = 0.0
    return x


def _table_tied(n, *shape, seed=0):
    """``n`` tensors, the second equal to the first at every other
    element (ties for the elementwise max and min)."""
    xs = [_normal(*shape, seed=seed + i) for i in range(n)]
    xs[1].reshape(-1)[::2] = xs[0].reshape(-1)[::2]
    return tuple(xs)


def _clamp_input():
    x = _normal(3, 5, seed=3)
    x[0, :2] = (-0.5, 0.8)  # exactly at the bounds
    return x


def _masked_input():
    x = _normal(2, 5, 3, seed=4)
    x[0, 1] = 0.0
    x[1, 3] = 0.0
    return x


# name: (constructor args, input maker); the port's constructor takes the
# reference's arguments
CASES = {
    "View": (((6, 2),), lambda: _normal(2, 3, 4)),
    "View_infer": (((-1, 3),), lambda: _normal(2, 3, 4)),
    "Reshape_whole": (((4, 6), False), lambda: _normal(2, 3, 4)),
    "Flatten": ((), lambda: _normal(2, 3, 4)),
    "Squeeze": ((1,), lambda: _normal(2, 1, 4)),
    "Squeeze_all": ((), lambda: _normal(2, 1, 4, 1)),
    "Unsqueeze": ((1,), lambda: _normal(2, 3)),
    "Transpose": (([(1, 2), (0, 1)],), lambda: _normal(2, 3, 4)),
    "Contiguous": ((), lambda: _normal(2, 3)),
    "Narrow": ((1, 1, 2), lambda: _normal(2, 4, 3)),
    "Narrow_negative": ((2, 1, -1), lambda: _normal(2, 3, 5)),
    "Select": ((1, 2), lambda: _normal(2, 4, 3)),
    "Select_negative": ((2, -1), lambda: _normal(2, 4, 3)),
    "Index": ((1,), lambda: (_normal(2, 5, 3),
                             _rng(1).integers(0, 5, (2, 3)).astype(np.int32))),
    # ids in [-5, 0) count from the end, as jnp.take reads them
    "Index_negative": ((1,), lambda: (_normal(2, 5, 3),
                                      _rng(1).integers(-5, 5, (2, 3)).astype(
                                          np.int32))),
    "Padding": ((1, 2, 0.5), lambda: _normal(2, 3, 4)),
    "Padding_leading": ((2, -1), lambda: _normal(2, 3, 4)),
    "SpatialZeroPadding": ((1, 2, 0, 1), lambda: _normal(2, 3, 4, 5)),
    "JoinTable": ((1,), lambda: (_normal(2, 3), _normal(2, 4, seed=1))),
    "SplitTable": ((1,), lambda: _normal(2, 3, 4)),
    "CAddTable": ((), lambda: _table_tied(3, 2, 3)),
    "CMulTable": ((), lambda: _table_tied(3, 2, 3)),
    "CSubTable": ((), lambda: _table_tied(2, 2, 3)),
    "CDivTable": ((), lambda: (_normal(2, 3), _positive(2, 3, seed=1))),
    "CMaxTable": ((), lambda: _table_tied(3, 2, 4)),
    "CMinTable": ((), lambda: _table_tied(3, 2, 4)),
    "FlattenTable": ((), lambda: ((_normal(2, 3), (_normal(2, 2, seed=1),
                                                   _normal(2, 4, seed=2))),
                                  _normal(2, 1, seed=3))),
    "SelectTable": ((1,), lambda: (_normal(2, 3), _normal(2, 4, seed=1))),
    "MulConstant": ((2.5,), lambda: _normal(2, 3)),
    "AddConstant": ((-1.5,), lambda: _normal(2, 3)),
    "Power": ((1.5, 2.0, 1.0), lambda: _positive(2, 3)),
    "Power_square": ((2.0,), lambda: _normal(2, 3)),
    "Sqrt": ((), lambda: _positive(2, 3)),
    "Square": ((), lambda: _normal(2, 3)),
    "Abs": ((), lambda: _tied(3, 4)),
    "Exp": ((), lambda: _normal(2, 3)),
    "Log": ((), lambda: _positive(2, 3)),
    "Clamp": ((-0.5, 0.8), _clamp_input),
    "Mean": ((1,), lambda: _normal(2, 3, 4)),
    "Mean_keep": ((2, False), lambda: _normal(2, 3, 4)),
    "Sum": ((1,), lambda: _normal(2, 3, 4)),
    "Sum_keep": ((0, False), lambda: _normal(2, 3, 4)),
    "Max": ((2,), lambda: _tied(2, 3, 4)),
    "Min": ((2,), lambda: _tied(2, 3, 4)),
    "Replicate": ((3, 1), lambda: _normal(2, 4)),
    "Pack": ((1,), lambda: (_normal(2, 3), _normal(2, 3, seed=1))),
    "Scale": (((1, 4),), lambda: _normal(3, 4)),
    "Masking": ((0.0,), _masked_input),
    "CMul": (((1, 6),), lambda: _normal(4, 6)),
    "CAdd": (((1, 6),), lambda: _normal(4, 6)),
    "Normalize": ((), lambda: _normal(3, 5)),
    "Normalize_p1.5": ((1.5,), lambda: _normal(3, 5, 2)),
    "NormalizeScale": ((2.0, 1e-10, 20.0, (1, 4, 1, 1)),
                       lambda: _normal(2, 4, 3, 3)),
    "TemporalConvolution": ((5, 6, 3, 2), lambda: _normal(2, 9, 5)),
    "SpatialFullConvolution": ((4, 3, 3, 3, 2, 2, 1, 1, 1, 1),
                               lambda: _normal(2, 4, 5, 5)),
    # adj at or above the stride, and a pad above kernel - 1
    "SpatialFullConvolution_adj": ((2, 3, 3, 3, 2, 2, 1, 1, 2, 3),
                                   lambda: _normal(2, 2, 4, 4)),
    "SpatialFullConvolution_wide_pad": ((2, 3, 2, 2, 3, 3, 2, 2, 3, 3),
                                        lambda: _normal(1, 2, 4, 4)),
}
LONG_SUMS = {"TemporalConvolution", "SpatialFullConvolution",
             "SpatialFullConvolution_adj", "SpatialFullConvolution_wide_pad",
             "Normalize", "Normalize_p1.5", "NormalizeScale"}


def _class(name):
    return "Reshape" if name == "Reshape_whole" else name.split("_")[0]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def reference_run(jm, x, cot_seed=9):
    """(out leaves, input-gradient leaves, param gradients, params,
    cotangents) of the reference module on ``x``."""
    params, state = jm.init(jax.random.PRNGKey(0))
    jx = _map(jnp.asarray, x)
    out, _ = jm.apply(params, state, jx)
    cots = [_normal(*np.shape(o), seed=cot_seed + i)
            for i, o in enumerate(_leaves(out))]
    floats = [i for i, a in enumerate(_leaves(x)) if _is_float(a)]

    def loss(p, *fl):
        leaves = list(_leaves(jx))
        for i, v in zip(floats, fl):
            leaves[i] = v
        it = iter(leaves)
        xx = _map(lambda _: next(it), x)
        y, _ = jm.apply(p, state, xx)
        return sum(jnp.sum(o * c) for o, c in zip(_leaves(y), cots))

    argnums = tuple(range(len(floats) + 1))
    grads = jax.grad(loss, argnums=argnums)(
        params, *[_leaves(jx)[i] for i in floats])
    return ([np.asarray(o) for o in _leaves(out)],
            [np.asarray(g) for g in grads[1:]],
            jax.tree_util.tree_map(np.asarray, grads[0]),
            jax.tree_util.tree_map(np.asarray, params), cots)


def port_run(pm, x, cots):
    """(out leaves, input-gradient leaves, param gradients by name) of the
    port module on ``x``."""
    for p in pm.parameters():
        p.requires_grad_(True)
    tx = _map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        _is_float(a)), x)
    out = pm(tx)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(_leaves(out), cots))
    loss.backward()
    return ([o.detach().numpy() for o in _leaves(out)],
            [np.zeros(t.shape, np.float32) if t.grad is None
             else t.grad.numpy() for t in _leaves(tx) if t.requires_grad],
            {k: p.grad.numpy() for k, p in pm.named_parameters()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name):
    args, make = CASES[name]
    x = make()
    cls = _class(name)
    jm, pm = getattr(jnn, cls)(*args), getattr(nn, cls)(*args)
    want_out, want_dx, want_dp, params, cots = reference_run(jm, x)
    load_jax_params(pm, params)
    got_out, got_dx, got_dp = port_run(pm, x, cots)
    tol = SUM_CLOSE if name in LONG_SUMS else CLOSE
    assert len(got_out) == len(want_out)
    for g, w in zip(got_out, want_out):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{name} forward")
    assert len(got_dx) == len(want_dx)
    for g, w in zip(got_dx, want_dx):
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{name} d input")
    want_dp = _flat(want_dp)
    assert sorted(got_dp) == sorted(want_dp)
    for k, w in want_dp.items():
        np.testing.assert_allclose(got_dp[k], w, **tol,
                                   err_msg=f"{name} d {k}")


LAYERS_WITH_WEIGHTS = ["CMul", "CAdd", "NormalizeScale",
                       "TemporalConvolution", "SpatialFullConvolution",
                       "Scale"]


@pytest.mark.parametrize("name", LAYERS_WITH_WEIGHTS)
def test_weights_cross_without_transposition(name):
    """The reference's arrays land in the port's tensors as they are (same
    shapes, same element order) and come back bitwise; the initialized
    shapes agree, so no layer transposes."""
    args, _ = CASES[name]
    jm, pm = getattr(jnn, name)(*args), getattr(nn, name)(*args)
    params, _ = jm.init(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    fresh = _flat(to_jax_params(getattr(nn, name)(*args).initialize(0))[0])
    assert {k: v.shape for k, v in fresh.items()} == \
        {k: v.shape for k, v in _flat(params).items()}
    load_jax_params(pm, params)
    named = dict(pm.named_parameters())
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(named[k].detach().numpy(), v)
    back = _flat(to_jax_params(pm)[0])
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)


MODULE_FIXTURES = {
    "cadd": lambda: nn.CAdd((1, 6)),
    "cmul": lambda: nn.CMul((1, 6)),
    "power": lambda: nn.Power(1.5, 2.0, 1.0),
    "clamp": lambda: nn.Clamp(-0.5, 0.8),
    "temporal_convolution": lambda: nn.TemporalConvolution(5, 6, 3, 2),
    "spatial_full_convolution": lambda: nn.SpatialFullConvolution(
        4, 3, 3, 3, 2, 2, 1, 1, 1, 1),
}


@pytest.mark.parametrize("name", sorted(MODULE_FIXTURES))
def test_module_fixture_replay(name):
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    params = {k[2:]: z[k].astype(np.float32) for k in z.files
              if k.startswith("p_")}
    model = load_jax_params(MODULE_FIXTURES[name](), params)
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


def _grad(module, x):
    t = torch.tensor(x, requires_grad=True)
    module(t).sum().backward()
    return t.grad.numpy()


def test_max_tie_shares_the_gradient():
    """Tied maxima share the gradient evenly, as JAX splits it;
    ``torch.max(x, dim)`` would give it all to one of them."""
    x = [[0.0, 0.0, 0.5, 0.5], [1.0, -1.0, 1.0, 0.0]]
    want = [[0.0, 0.0, 0.5, 0.5], [0.5, 0.0, 0.5, 0.0]]
    np.testing.assert_array_equal(_grad(nn.Max(1), x), want)
    ref = jax.grad(lambda a: jnn.Max(1).apply({}, {}, a)[0].sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref), want)
    neg = [[-v for v in row] for row in x]
    np.testing.assert_array_equal(_grad(nn.Min(1), neg), want)


def test_clamp_gradient_at_a_bound_is_half():
    """At exactly a bound the gradient is 0.5, as JAX's ``clip`` gives it;
    ``torch.clamp`` would give 1 and ``F.hardtanh`` 0."""
    x = [-0.5, 0.8, 0.0, 1.0]
    want = [0.5, 0.5, 1.0, 0.0]
    np.testing.assert_array_equal(_grad(nn.Clamp(-0.5, 0.8), x), want)
    ref = jax.grad(lambda a: jnn.Clamp(-0.5, 0.8).apply({}, {}, a)[0].sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_full_convolution_adj_at_or_above_stride():
    """``F.conv_transpose2d`` refuses output_padding >= stride; the layer
    gives the reference's size, (in - 1) * stride - 2 * pad + kernel +
    adj, and values (the rows past the uncropped output hold the bias)."""
    m = nn.SpatialFullConvolution(2, 3, 3, 3, 2, 2, 1, 1, 2, 3).initialize(0)
    x = torch.from_numpy(_normal(2, 2, 4, 4))
    with pytest.raises(RuntimeError):
        torch.nn.functional.conv_transpose2d(x, m.weight, stride=2,
                                             padding=1, output_padding=(3, 2))
    y = m(x)
    assert tuple(y.shape) == (2, 3, 3 * 2 - 2 + 3 + 3, 3 * 2 - 2 + 3 + 2)
    jm = jnn.SpatialFullConvolution(2, 3, 3, 3, 2, 2, 1, 1, 2, 3)
    params = {"weight": jnp.asarray(m.weight.numpy()),
              "bias": jnp.asarray(m.bias.numpy())}
    want, _ = jm.apply(params, {}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               **SUM_CLOSE)
    np.testing.assert_allclose(y[:, :, -1, :].detach().numpy(),
                               np.broadcast_to(m.bias.numpy()[None, :, None],
                                               (2, 3, y.shape[3])))


def test_lambda_max_over_time_matches_reference():
    """The text CNN's max over time: ``amax`` in the port against the
    reference's ``x.max(axis=1)``, ties included."""
    x = _tied(2, 5, 3)
    x[:, 2] = x[:, 0]
    jm = jnn.Lambda(lambda a: a.max(axis=1))
    pm = nn.Lambda(lambda a: a.amax(1))
    want, want_dx, _, _, cots = reference_run(jm, x)
    got, got_dx, _ = port_run(pm, x, cots)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got_dx[0], want_dx[0], **CLOSE)


def test_echo_prints_shapes_and_passes_input(capsys):
    x = (torch.zeros(2, 3), (torch.ones(4),))
    assert nn.Echo(name="probe")(x) is x
    assert capsys.readouterr().out.strip() == \
        "[Echo probe] ((2, 3), ((4,),))"

"""Inception's modules in the port on the CPU against the reference:
``Concat``, ``SpatialCrossMapLRN``, the initialization methods, Inception
v1 and v2 and the ImageNet VGG-16.

- ``Concat`` of 12 children: the reference's parameter tree and leaf
  order (``"10"`` and ``"11"`` sort before ``"2"``), and a snapshot
  written by either package read by the other, bitwise.
- ``SpatialCrossMapLRN``: the golden torch-float64 fixture replayed at the
  reference replay's tolerance (``rtol=2e-4, atol=2e-5``); at ``size`` 4
  and 5, NCHW and NHWC, against the reference within ``rtol=1e-5,
  atol=1e-6`` (forward and input gradient).  At ``size`` 4 the window is
  the reference's ``((size-1)//2, size//2)``, not
  ``torch.nn.functional.local_response_norm``'s.
- ``Xavier``: its bound and shape; ``BilinearFiller``, ``Ones`` and
  ``ConstInitMethod``: bitwise.
- ``inception_v1`` (NCHW and NHWC) and ``inception_v2`` at 224x224 in
  eval mode (Dropout's masks come from other generators; v2's BatchNorm
  with random running statistics) from the same weights: the
  log-probabilities within ``rtol=1e-5, atol=1e-5``, as
  ``tests/test_torch_lenet.py`` holds LeNet's, and each gradient leaf
  (the input's too) within ``GRAD_LIMIT`` of its norm (below: why not
  elementwise).  ``vgg16``: the reference's parameter tree and one
  forward.
"""

import math
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.checkpoint.snapshot import load_snapshot as jload_snapshot  # noqa: E402
from bigdl_tpu.checkpoint.snapshot import write_snapshot as jwrite_snapshot  # noqa: E402
from bigdl_tpu.models.inception import inception_v1 as jax_inception_v1  # noqa: E402
from bigdl_tpu.models.inception import inception_v2 as jax_inception_v2  # noqa: E402
from bigdl_tpu.models.vgg import vgg16 as jax_vgg16  # noqa: E402
from bigdl_tpu.nn import initialization as jinit  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.checkpoint.snapshot import load_snapshot, write_snapshot  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.interop.jax_weights import from_jax_tree  # noqa: E402
from bigdl_tpu_torch.models import inception_v1, vgg16  # noqa: E402
from bigdl_tpu_torch.models.inception import inception_v2  # noqa: E402
from bigdl_tpu_torch.nn import initialization as init  # noqa: E402
from bigdl_tpu_torch.parallel import grad_sync  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")
# Inception's gradients, each leaf's ||g_port - g_ref|| / ||g_ref||: f32
# sums in another order through about 60 convolutions and as many ReLUs
# (those whose inputs lie within rounding of 0 flip) read up to 9.9e-3
# (the input gradient of v1 in NHWC; 4.6e-3 in NCHW, 3.4e-3 for v2), the
# median leaf 6e-4, so no elementwise limit holds whole-model gradients
GRAD_LIMIT = 2e-2


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def _shapes(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = tuple(v.shape)
    return out


# ------------------------------------------------------------------ Concat
def _concat12(n):
    m = n.Concat(1)
    for i in range(12):
        m.add(n.Linear(4, i + 1))
    return m


def test_concat_of_12_children_keeps_reference_tree(tmp_path):
    model = _concat12(nn).initialize(3)
    jm = _concat12(jnn)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    params, state = to_jax_params(model)
    assert _shapes(params) == _shapes(jp)
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp))
    # grad_sync's bucket leaves follow the reference's flatten order
    plan = grad_sync.build_plan(params, 1, 1 << 20)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    assert plan.paths == jpaths
    assert jpaths[:6] == ["['0']['bias']", "['0']['weight']", "['1']['bias']",
                          "['1']['weight']", "['10']['bias']",
                          "['10']['weight']"]
    # forward: the reference's, from the same weights
    x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    out = model(torch.from_numpy(x))
    jout, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), state,
                       jnp.asarray(x))
    assert out.shape == (3, 78)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    # snapshots both ways
    write_snapshot(str(tmp_path / "port"), params=params, model_state=state)
    got = jload_snapshot(str(tmp_path / "port"))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(got["params"])[k], v)
    jwrite_snapshot(str(tmp_path / "ref"), params=jp, model_state={})
    back = load_snapshot(str(tmp_path / "ref"))
    named = from_jax_tree(model, back["params"])
    assert set(named) == {k for k, _ in model.named_parameters()}
    for k, v in named.items():
        np.testing.assert_array_equal(
            np.asarray(v), np.asarray(_flat(jax.tree_util.tree_map(
                np.asarray, jp))[k]))


# --------------------------------------------------------------------- LRN
def test_lrn_golden_fixture():
    z = np.load(os.path.join(DATA_DIR, "spatial_cross_map_lrn.npz"))
    x = torch.from_numpy(z["x"].astype(np.float32)).requires_grad_(True)
    out = nn.SpatialCrossMapLRN(5, 1.0, 0.75, 1.0)(x)
    out.sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), z["out"], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [4, 5])
def test_lrn_matches_reference(size, fmt):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 3, (2, 9, 6, 7)).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.normal(size=x.shape).astype(np.float32)
    args = (size, 0.3, 0.75, 2.0)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = nn.SpatialCrossMapLRN(*args, format=fmt)(xt)
    (out * torch.from_numpy(w)).sum().backward()
    jl = jnn.SpatialCrossMapLRN(*args, format=fmt)

    def f(xx):
        return jl.apply({}, {}, xx)[0]
    jout, vjp = jax.vjp(f, jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(w)[0]),
                               rtol=1e-5, atol=1e-6)
    if size % 2 == 0 and fmt == "NCHW":
        # torch's own LRN centres an even window the other way round
        other = torch.nn.functional.local_response_norm(
            torch.from_numpy(x), size, 0.3, 0.75, 2.0)
        assert not np.allclose(other.numpy(), np.asarray(jout), rtol=1e-3)


# ---------------------------------------------------------- initialization
def test_xavier_bound_and_shape():
    w = init.Xavier().init(torch.Generator().manual_seed(0), (64, 32, 3, 3),
                           32 * 9, 64 * 9)
    a = math.sqrt(6.0 / (32 * 9 + 64 * 9))
    assert w.shape == (64, 32, 3, 3) and w.dtype == torch.float32
    assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.95 * a
    assert abs(float(w.mean())) < 0.05 * a
    # uniform: the variance of U(-a, a)
    np.testing.assert_allclose(float(w.var()), a * a / 3, rtol=0.05)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 1, 3, 5), (6, 7)])
def test_deterministic_initializations_bitwise(shape):
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for mine, ref in ((init.BilinearFiller(), jinit.BilinearFiller()),
                      (init.Ones(), jinit.Ones()),
                      (init.ConstInitMethod(0.37),
                       jinit.ConstInitMethod(0.37))):
        a = mine.init(gen, shape, 3, 4).numpy()
        b = np.asarray(ref.init(key, shape, 3, 4))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ models
def _random_running_stats(state, rng):
    if "running_mean" in state:
        return {"running_mean": rng.normal(0, 0.2, state["running_mean"]
                                           .shape).astype(np.float32),
                "running_var": rng.uniform(0.5, 2.0, state["running_var"]
                                           .shape).astype(np.float32)}
    return {k: _random_running_stats(v, rng) for k, v in state.items()}


def _eval_grads_match(model, jm, x, seed=0):
    params, state = to_jax_params(model)
    state = _random_running_stats(state, np.random.default_rng(seed))
    load_jax_params(model, params, state)
    labels = np.arange(x.shape[0], dtype=np.int32) * 7
    xt = torch.from_numpy(x).requires_grad_(True)
    for p in model.parameters():
        p.requires_grad_(True)
    model.eval()
    out = model(xt)
    loss = nn.ClassNLLCriterion().apply(out, torch.from_numpy(labels))
    loss.backward()

    def jloss(p, xx):
        o, _ = jm.apply(p, state, xx, training=False)
        return jnn.ClassNLLCriterion().apply(o, jnp.asarray(labels)), o

    (jl, jout), (jg, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    grads = _flat(jax.tree_util.tree_map(np.asarray, jg))
    grads["input"], tgrads = np.asarray(jdx), {"input": xt.grad.numpy()}
    tgrads.update((k, p.grad.numpy()) for k, p in model.named_parameters())
    assert tgrads.keys() == grads.keys()
    shares = {k: float(np.linalg.norm(tgrads[k] - g) / np.linalg.norm(g))
              for k, g in grads.items()}
    worst = max(shares, key=shares.get)
    assert shares[worst] < GRAD_LIMIT, (worst, shares[worst])


def _image(n, fmt="NCHW", seed=0):
    x = np.random.default_rng(seed).normal(0, 1, (n, 3, 224, 224)) \
        .astype(np.float32)
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1)) if fmt == "NHWC" \
        else x


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_inception_v1_matches_reference(fmt):
    model = inception_v1(1000, format=fmt).initialize(4)
    jm = jax_inception_v1(1000, format=fmt)
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params, state = to_jax_params(model)
    assert _shapes(params) == _shapes(jp) and _shapes(state) == _shapes(js)
    assert [m.name for m in model.children()] == [m.name for m in jm.modules]
    pools = [m for m in model.modules()
             if isinstance(m, nn.SpatialMaxPooling)]
    assert len(pools) == 13
    assert sum(m.ceil_mode for m in pools) == 4
    _eval_grads_match(model, jm, _image(2, fmt))


def test_inception_v2_matches_reference():
    model = inception_v2(1000).initialize(5)
    jm = jax_inception_v2(1000)
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params, state = to_jax_params(model)
    assert _shapes(params) == _shapes(jp) and _shapes(state) == _shapes(js)
    _eval_grads_match(model, jm, _image(1, seed=1), seed=2)


def test_vgg16_tree_and_forward():
    model = vgg16(1000).initialize(0)
    jm = jax_vgg16(1000)
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params, state = to_jax_params(model)
    assert _shapes(params) == _shapes(jp) and _shapes(state) == _shapes(js)
    assert [m.name for m in model.children()] == [m.name for m in jm.modules]
    model.eval()
    x = _image(1, seed=3)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    jout, _ = jax.jit(lambda p, xx: jm.apply(p, state, xx))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    assert out.shape == (1, 1000)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)

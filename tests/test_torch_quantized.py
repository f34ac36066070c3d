"""Port of ``nn/quantized.py`` against the JAX reference.

- ``quantize()`` panels and scales: BITWISE (same numpy math).
- ``QuantizedSpatialConvolution`` against the reference's direct-conv
  simulation ``_apply_sim`` (what JAX runs on the CPU): dynamic is
  BITWISE (exact integer sums, a per-tensor scale taken over the whole
  input, one-rounding epilogue); weight_only is held to
  ``rtol=1e-5, atol=1e-5*max|y|`` (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.resnet import resnet_cifar as jax_resnet_cifar
from bigdl_tpu.nn.quantized import QuantizedLinear as JaxQuantizedLinear
from bigdl_tpu.nn.quantized import \
    QuantizedSpatialConvolution as JaxQuantizedConv
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.utils.config import reset_config

MODES = ["dynamic", "weight_only"]


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _check(got, want, mode):
    assert got.shape == want.shape and got.dtype == np.float32
    if mode == "dynamic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


CONVS = [
    ("1x1_s1", (16, 8, 1, 1, 1, 1, 0, 0), {}, (2, 16, 9, 9)),
    ("1x1_s2", (16, 8, 1, 1, 2, 2, 0, 0), {}, (2, 16, 9, 9)),
    ("3x3_s2_p1", (6, 8, 3, 3, 2, 2, 1, 1), {}, (2, 6, 10, 10)),
    ("7x7_s2_p3", (3, 8, 7, 7, 2, 2, 3, 3), {"with_bias": False},
     (2, 3, 20, 20)),
    ("same_s2", (4, 6, 3, 3, 2, 2, -1, -1), {}, (2, 4, 10, 11)),
    ("dilated", (4, 6, 3, 3, 1, 1, 2, 2),
     {"dilation_w": 2, "dilation_h": 2}, (2, 4, 9, 9)),
    ("grouped", (4, 6, 3, 3, 1, 1, 1, 1), {"n_group": 2}, (2, 4, 8, 8)),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,args,kw,shape", CONVS,
                         ids=[c[0] for c in CONVS])
def test_quantized_conv_matches_apply_sim(name, args, kw, shape, mode):
    jconv = jnn.SpatialConvolution(*args, **kw)
    params, _ = _np_tree(jconv.init(jax.random.PRNGKey(0)))
    jq = JaxQuantizedConv.from_conv(jconv, params, mode=mode)
    x = _x(shape)
    want = np.asarray(jax.jit(jq._apply_sim)(x))
    conv = load_jax_params(nn.SpatialConvolution(*args, **kw), params)
    tq = nn.QuantizedSpatialConvolution.from_conv(conv, mode=mode)
    np.testing.assert_array_equal(tq.weight_q.numpy(), np.asarray(jq.weight_q))
    np.testing.assert_array_equal(tq.weight_scale.numpy(),
                                  np.asarray(jq.weight_scale))
    _check(tq(torch.from_numpy(x)).numpy(), want, mode)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_linear(mode):
    jlin = jnn.Linear(48, 10)
    params, _ = _np_tree(jlin.init(jax.random.PRNGKey(1)))
    jq = JaxQuantizedLinear.from_linear(jlin, params, mode=mode)
    x = _x((5, 48))
    want = np.asarray(jax.jit(lambda x: jq.apply({}, {}, x)[0])(x))
    tq = nn.QuantizedLinear.from_linear(
        load_jax_params(nn.Linear(48, 10), params), mode=mode)
    _check(tq(torch.from_numpy(x)).numpy(), want, mode)


def test_quantize_panels_bitwise_and_tree_shape():
    jm = jax_resnet_cifar(8)
    params, state = to_jax_params(resnet_cifar(8).initialize(2))
    jm._params, jm._state = params, state
    jq = jax_quantize(jm, mode="dynamic")
    tm = load_jax_params(resnet_cifar(8), params, state)
    tq = nn.quantize(tm, mode="dynamic")

    def leaves(m, kinds):
        if hasattr(m, "modules") and isinstance(m.modules, list):
            return [q for c in m.modules for q in leaves(c, kinds)]
        return [m] if isinstance(m, kinds) else []

    jl = leaves(jq, (JaxQuantizedConv, JaxQuantizedLinear))
    tl = [m for m in tq.modules()
          if isinstance(m, (nn.QuantizedSpatialConvolution,
                            nn.QuantizedLinear))]
    assert len(jl) == len(tl) == 10  # 9 convs + the classifier
    for j, t in zip(jl, tl):
        assert t.mode == j.mode == "dynamic"
        np.testing.assert_array_equal(t.weight_q.numpy(),
                                      np.asarray(j.weight_q))
        np.testing.assert_array_equal(t.weight_scale.numpy(),
                                      np.asarray(j.weight_scale))


def test_quantize_copies_and_is_idempotent():
    model = resnet_cifar(8).initialize(3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q1 = nn.quantize(model)
    assert not q1.training and model.training
    bn = q1[0][1]
    bn.running_mean.fill_(5.0)  # the copy's BN is its own
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not any(isinstance(m, (nn.Linear, nn.SpatialConvolution))
                   for m in q1.modules())
    q2 = nn.quantize(q1)
    x = torch.from_numpy(_x((2, 3, 32, 32)))
    assert torch.equal(q1(x), q2(x))


def test_default_mode_follows_config(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_INT8_ACTIVATION_MODE", "dynamic")
    reset_config()
    try:
        q = nn.quantize(nn.Sequential().add(nn.Linear(4, 2)))
        assert q[0].mode == "dynamic"
        with pytest.raises(ValueError, match="mode"):
            nn.quantize(nn.Linear(4, 2), mode="static")
    finally:
        monkeypatch.delenv("BIGDL_TPU_INT8_ACTIVATION_MODE")
        reset_config()


# ------------------------------------------------------- NHWC int8 convs
# The NHWC convolution keeps weight_q OIHW and builds the NCHW twin's
# channel-major patch rows from its input's NCHW view: the same operands
# reach B4 (here its plain version), so its output is the NCHW twin's,
# transposed, bit for bit; against the reference's NHWC ``_apply_sim``
# the limits are the NCHW cases' above.
def _nhwc_pair(args, kw, params):
    return [nn.QuantizedSpatialConvolution.from_conv(
        load_jax_params(nn.SpatialConvolution(*args, format=fmt, **kw),
                        params), mode=mode)
        for fmt, mode in (("NHWC", None), ("NCHW", None))]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,args,kw,shape", CONVS,
                         ids=[c[0] for c in CONVS])
def test_quantized_conv_nhwc_matches_apply_sim_and_nchw_twin(name, args, kw,
                                                            shape, mode):
    jconv = jnn.SpatialConvolution(*args, format="NHWC", **kw)
    params, _ = _np_tree(jconv.init(jax.random.PRNGKey(0)))
    jq = JaxQuantizedConv.from_conv(jconv, params, mode=mode)
    x = _x(shape).transpose(0, 2, 3, 1).copy()
    want = np.asarray(jax.jit(jq._apply_sim)(x))
    nhwc, nchw = (nn.QuantizedSpatialConvolution.from_conv(
        load_jax_params(nn.SpatialConvolution(*args, format=fmt, **kw),
                        params), mode=mode) for fmt in ("NHWC", "NCHW"))
    assert nhwc.format == "NHWC" and nhwc.weight_q.shape == \
        nchw.weight_q.shape
    np.testing.assert_array_equal(nhwc.weight_q.numpy(),
                                  np.asarray(jq.weight_q))
    got = nhwc(torch.from_numpy(x)).numpy()
    _check(got, want, mode)
    twin = nchw(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_array_equal(got, twin.transpose(0, 2, 3, 1))


def _nhwc_resnet_twins(seed=2):
    """(NHWC ResNet-8, its NCHW twin, the reference's NHWC ResNet-8) on
    the same weights, BatchNorm running statistics drawn from the seed."""
    port = resnet_cifar(8, format="NHWC").initialize(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for m in port.modules():
        if isinstance(m, nn.SpatialBatchNormalization):
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                   generator=gen))
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=gen) + 0.5)
    params, state = to_jax_params(port)
    twin = load_jax_params(resnet_cifar(8), params, state)
    ref = jax_resnet_cifar(8, format="NHWC")
    ref._params, ref._state = (jax.tree_util.tree_map(jax.numpy.asarray, t)
                               for t in (params, state))
    return port, twin, ref


@pytest.mark.parametrize("mode", MODES)
def test_quantized_nhwc_resnet_matches_reference_and_nchw_twin(mode):
    """A small NHWC ResNet quantized in each mode: within the NCHW limits
    of the reference's quantized NHWC ResNet (the float layers between
    the int8 ones round in their own order, so the whole model is held by
    the weight_only limit in both modes), and BITWISE the NCHW twin's
    output."""
    port, twin, ref = _nhwc_resnet_twins()
    x = _x((2, 32, 32, 3))
    qport = nn.quantize(port, mode=mode)
    convs = [m for m in qport.modules()
             if isinstance(m, nn.QuantizedSpatialConvolution)]
    assert len(convs) == 9 and {m.format for m in convs} == {"NHWC"}
    with torch.no_grad():
        got = qport(torch.from_numpy(x)).numpy()
        want_twin = nn.quantize(twin, mode=mode)(
            torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_array_equal(got, want_twin)
    jq = jax_quantize(ref, mode=mode)
    jq.evaluate()
    want = np.asarray(jq.forward(x))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _nhwc_convnet(module):
    return (module.Sequential()
            .add(module.SpatialConvolution(3, 8, 3, 3, 1, 1, 1, 1,
                                           format="NHWC"))
            .add(module.ReLU())
            .add(module.SpatialConvolution(8, 4, 3, 3, 2, 2, -1, -1,
                                           format="NHWC"))
            .add(module.SpatialConvolution(4, 6, 1, 1, with_bias=False,
                                           format="NHWC")))


@pytest.mark.parametrize("mode", MODES)
def test_quantized_nhwc_bigdl_file_loads_and_writes_the_same_bytes(
        mode, tmp_path):
    """A ``.bigdl`` file of a quantized NHWC network written by the
    reference loads in the port (format and mode kept) and runs bitwise
    as the port's in-memory quantized twin; the port's writer gives back
    the file's bytes, from the loaded module and from its own quantized
    model."""
    from bigdl_tpu import interop as jinterop
    from bigdl_tpu_torch import interop
    port = _nhwc_convnet(nn).initialize(4)
    ref = _nhwc_convnet(jnn)
    params, state = to_jax_params(port)
    ref._params, ref._state = (jax.tree_util.tree_map(jax.numpy.asarray, t)
                               for t in (params, state))
    ref_path, back_path, own_path = (str(tmp_path / f"{n}.bigdl")
                                     for n in ("ref", "back", "own"))
    jinterop.save_bigdl_module(jax_quantize(ref, mode=mode), ref_path)
    back = interop.load_bigdl_module(ref_path)
    convs = [m for m in back.modules()
             if isinstance(m, nn.QuantizedSpatialConvolution)]
    assert len(convs) == 3
    assert {(m.format, m.mode) for m in convs} == {("NHWC", mode)}
    x = torch.from_numpy(_x((2, 9, 9, 3)))
    qport = nn.quantize(port, mode=mode)
    with torch.no_grad():
        np.testing.assert_array_equal(back.eval()(x).numpy(),
                                      qport(x).numpy())
    interop.save_bigdl_module(back, back_path)
    interop.save_bigdl_module(qport, own_path)
    want = open(ref_path, "rb").read()
    assert open(back_path, "rb").read() == want
    assert open(own_path, "rb").read() == want

"""Port of ``nn/quantized.py`` against the JAX reference.

- ``quantize()`` panels and scales: BITWISE (same numpy math).
- ``QuantizedSpatialConvolution`` against the reference's direct-conv
  simulation ``_apply_sim`` (what JAX runs on the CPU): dynamic is
  BITWISE (exact integer sums, a per-tensor scale taken over the whole
  input, one-rounding epilogue); weight_only is held to
  ``rtol=1e-5, atol=1e-5*max|y|`` (f32 sums in another order).
- The quantized recurrent cells (``QuantizedLSTM``, ``QuantizedGRU``,
  ``QuantizedRnnCell``) through ``Recurrent`` and ``BiRecurrent`` against
  the reference's quantized models from the same weights, both modes:
  ``CELL_TOL`` of max|y| (sound readings ~2e-7: the gates' sigmoid and
  tanh round in their own order, and in dynamic mode each step's scale is
  taken over an ``[x_t, h]`` that carries them; a GRU candidate panel
  scaled x127/128 must read above it).
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
from bigdl_tpu_torch.models import ptb_model, resnet_cifar
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


# --------------------------------------------------- quantized recurrent
CELL_TOL = 1e-5
CELL_KINDS = {"lstm": lambda m: m.LSTM(6, 8, forget_bias=1.0),
              "gru": lambda m: m.GRU(6, 8), "rnn": lambda m: m.RnnCell(6, 8)}
CELL_TYPES = {"lstm": (nn.QuantizedLSTM, "QuantizedLSTM"),
              "gru": (nn.QuantizedGRU, "QuantizedGRU"),
              "rnn": (nn.QuantizedRnnCell, "QuantizedRnnCell")}


def _rnn_net(m, kind, bi):
    """Per-step float projection, the recurrent layer, the last step, a
    classifier: the shape of the Keras text classifiers."""
    cell = CELL_KINDS[kind]
    rec = m.BiRecurrent(cell(m), cell(m)) if bi else m.Recurrent(cell(m))
    return (m.Sequential().add(m.TimeDistributed(m.Linear(5, 6))).add(rec)
            .add(m.Select(1, -1)).add(m.Linear(16 if bi else 8, 3)))


def _rnn_twins(kind, bi, seed=3):
    port = _rnn_net(nn, kind, bi).initialize(seed)
    ref = _rnn_net(jnn, kind, bi)
    ref._params, ref._state = to_jax_params(port)
    return port, ref


def _ref_quantized(ref, mode, x):
    jq = jax_quantize(ref, mode=mode)
    return jq, np.asarray(jax.jit(
        lambda x: jq.apply(jq._params, jq._state, x)[0])(x))


def _quantized_cells(model):
    return [m for m in model.modules() if isinstance(
        m, (nn.QuantizedLSTM, nn.QuantizedGRU, nn.QuantizedRnnCell))]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bi", [False, True], ids=["recurrent", "bi"])
@pytest.mark.parametrize("kind", sorted(CELL_KINDS))
def test_quantized_cells_match_reference(kind, bi, mode):
    port, ref = _rnn_twins(kind, bi)
    x = _x((4, 7, 5))
    jq, want = _ref_quantized(ref, mode, x)
    tq = nn.quantize(port, mode=mode)
    cells = _quantized_cells(tq)
    cls, jname = CELL_TYPES[kind]
    assert len(cells) == (2 if bi else 1)
    assert all(type(c) is cls and c.mode == mode for c in cells)
    jrec = jq.modules[1]
    jcells = [jrec.fwd.cell, jrec.bwd.cell] if bi else [jrec.cell]
    assert [type(c).__name__ for c in jcells] == [jname] * len(cells)
    panels = {"lstm": ("wq", "ws"), "gru": ("gq", "gs", "cq", "cs"),
              "rnn": ("wq", "ws")}[kind]
    for c, jc in zip(cells, jcells):  # the same numpy quantization
        for k in panels:
            np.testing.assert_array_equal(getattr(c, k).numpy(),
                                          np.asarray(getattr(jc, k)))
    with torch.no_grad():
        got = tq(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= CELL_TOL * np.abs(want).max()


def test_quantized_gru_planted_fault_exceeds_the_limit():
    port, ref = _rnn_twins("gru", True)
    x = _x((4, 7, 5))
    _, want = _ref_quantized(ref, "dynamic", x)
    tq = nn.quantize(port, mode="dynamic")
    cell = _quantized_cells(tq)[0]
    cell.cs.mul_(127 / 128)
    with torch.no_grad():
        got = tq(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > CELL_TOL * np.abs(want).max()


def test_quantized_lstm_keeps_forget_bias_and_takes_the_step_path(
        monkeypatch):
    """No hoisted form: ``Recurrent`` runs ``step`` (one int8 product a
    step), never the fused float cell (B2f on the card)."""
    from bigdl_tpu_torch.nn import quantized as qmod
    from bigdl_tpu_torch.ops import lstm_cell
    port, _ = _rnn_twins("lstm", False)
    tq = nn.quantize(port)
    cell = _quantized_cells(tq)[0]
    assert cell.forget_bias == 1.0 and cell.hoist(torch.zeros(7, 4, 6)) is None
    calls = []
    real = qmod.int8_matmul
    monkeypatch.setattr(qmod, "int8_matmul",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(lstm_cell, "lstm_cell", None)  # would raise if run
    with torch.no_grad():
        tq(torch.from_numpy(_x((4, 7, 5))))
    assert calls == [(4, 14)] * 7 + [(4, 8)]  # 7 steps of [x_t, h], the head


def test_quantize_leaves_multirnn_and_time_distributed_float():
    """PTB's model: its ``Recurrent(MultiRNNCell)`` and its
    ``TimeDistributed(Linear)`` head stay float in both packages, so its
    quantized forward is its float forward, bit for bit."""
    from bigdl_tpu.models.rnn import ptb_model as jptb_model
    port = ptb_model(50, 8, 8, 2).initialize(1)
    ref = jptb_model(50, 8, 8, 2)
    ref._params, ref._state = to_jax_params(port)
    jq = jax_quantize(ref, mode="dynamic")
    q = nn.quantize(port, mode="dynamic")
    assert not nn.quantized.is_quantized(q)
    assert not any(isinstance(m, (nn.QuantizedLinear, nn.QuantizedLSTM))
                   for m in q.modules())
    assert type(jq.modules[1].cell).__name__ == "MultiRNNCell"
    assert type(jq.modules[-2].layer).__name__ == "Linear"
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 50, (3, 6)).astype(np.int64))
    with torch.no_grad():
        assert torch.equal(q(ids), port.eval()(ids))


def test_quantize_stamps_mode_on_every_leaf_and_cell():
    m = (nn.Sequential().add(nn.TimeDistributed(nn.Linear(5, 6)))
         .add(nn.BiRecurrent(nn.GRU(6, 4), nn.LSTM(6, 4)))
         .add(nn.Recurrent(nn.RnnCell(8, 4)))
         .add(nn.Select(1, -1)).add(nn.Linear(4, 2))).initialize(0)
    for mode in MODES:
        q = nn.quantize(m, mode=mode)
        leaves = [x for x in q.modules() if hasattr(x, "mode")]
        assert [type(x).__name__ for x in leaves] == [
            "QuantizedGRU", "QuantizedLSTM", "QuantizedRnnCell",
            "QuantizedLinear"]
        assert {x.mode for x in leaves} == {mode}
        assert nn.quantized.is_quantized(q)
        assert type(q[0].layer) is nn.Linear  # TimeDistributed stays
    assert nn.quantized.is_quantized(
        nn.quantize(nn.Recurrent(nn.LSTM(3, 4)).initialize(0)))


@pytest.mark.parametrize("kind", sorted(CELL_KINDS))
def test_quantized_cell_panels_cross_through_jax_params(kind):
    """``to_jax_params`` carries a quantized cell's int8 panels, scales and
    biases (the layer's state; its params are empty, as the reference's
    quantized tree is) and ``load_jax_params`` puts them back bitwise."""
    port, _ = _rnn_twins(kind, True)
    q1 = nn.quantize(port, mode="dynamic")
    params, state = to_jax_params(q1)
    assert params["1"] == {"fwd": {}, "bwd": {}}
    assert state["1"]["fwd"]["ws" if kind != "gru" else "gs"].dtype \
        == np.float32
    q2 = nn.quantize(_rnn_net(nn, kind, True).initialize(9), mode="dynamic")
    load_jax_params(q2, params, state)
    x = torch.from_numpy(_x((2, 5, 5)))
    with torch.no_grad():
        assert torch.equal(q1(x), q2(x))


def test_registry_deploys_a_quantized_keras_bilstm():
    """``ModelRegistry.deploy(quantize=True)`` of a small Keras
    bidirectional LSTM classifier: int8 weights and cells, the served rows
    the in-memory quantized model's, bit for bit."""
    from bigdl_tpu_torch import keras as K
    from bigdl_tpu_torch.serving import ModelRegistry
    model = K.Sequential([K.Embedding(30, 6, input_length=9),
                          K.Bidirectional(K.LSTM(5)),
                          K.Dense(4, activation="softmax")])
    core = model.core_module()
    ids = np.random.default_rng(2).integers(1, 30, (3, 9)).astype(np.int32)
    with ModelRegistry(device="cpu") as reg:
        v = reg.deploy("text", core, input_spec=((9,), np.int32),
                       quantize=True)
        got = v.predict(ids)
        assert v.stats()["weights_dtype"] == "int8"
    q = nn.quantize(core)
    assert len(_quantized_cells(q)) == 2
    with torch.no_grad():
        want = q(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)

"""f16 compute in the port on the CPU, against the reference:
``set_compute_dtype(torch.float16)`` keeps f32 master weights, the update
in f32 and the forward and backward in f16 (``utils/precision.py``), as the
reference's ``set_compute_dtype(jnp.float16)`` does, with no loss scaling
in either.

- Mixed-precision loss and gradients of a small NHWC conv/BN/ReLU/max
  pool/Linear model: the loss within ``rtol=2e-3`` of the reference's f16
  loss and every gradient within 1e-2 of its array's largest value
  (readings 1.3e-4 and up to 2.2e-3: the packages round to f16 at
  different places, PyTorch after each operator, XLA once a fused chain).
- One SGD step (lr 0.01) of LeNet-5 (NCHW, its pools on B1's plain version
  in f16) and of a tiny NHWC ResNet (the stem pool's too) through
  ``LocalOptimizer`` at K=1 from the same weights and batch: the loss
  within ``rtol=5e-3`` and each array's change within ``STEP_LIMIT`` of
  the reference's change, as a share of it (L2): 5e-2 for LeNet (readings
  up to 3.8e-3), 0.5 for the ResNet, whose BatchNorms amplify rounding
  (readings up to 0.17; each package's own f16 step stands 0.02-0.19 off
  its f32 one); a planted fault, f16 master weights (the update rounded to
  f16), exceeds both (0.28 and 4.8).
- The same step of a PTB model at PTB-small's widths (its cell the plain
  version of B2f/B2b in f16: f32 math, h' and c' rounded once; the
  reference's XLA chain rounds after each op): the loss within
  ``rtol=5e-3``, each array's change within ``PTB_STEP_LIMIT`` (5e-2;
  reading 9.6e-3 at the embedding, whose change is smallest), the f16
  master weights fault far above (338).
- A K=2 Adam block of a small Wide&Deep in f16 (its wide part's COO
  values and table in f16 through B3's plain version, the table gradient
  f16 values against an f32 cotangent): the COO values reach the wide part
  as f16, the losses within ``rtol=1e-3``, each array's change within
  ``WD_STEP_LIMIT`` (5e-3; readings up to 6.6e-4 over weight seeds 0, 1,
  4) and f16 master weights above it (0.020-0.024).
- f16 rows into the int8 GEMM (``int8_matmul``) and the quantized Linear
  and convolution (the stem's 7x7/2, K=147) in both modes, with an
  all-zero input (an f16 scale of 0: XLA's conversion takes the NaN
  quotient to 0) and one whose amax is f16's least subnormal (scale 0,
  every quotient +-inf, q = 127): dynamic bitwise (``dyn_quantize`` in f16
  bitwise, the s8 GEMM exact), weight_only ``rtol=1e-5, atol=1e-5 *
  max|y|`` (f32 sums against float64), f32 out of every layer.
- f16 reaches B1 only where it has an f16 form: the plain version on the
  CPU computes in f16 (each window's gradient added in f16).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JBatch  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models import lenet as jlenet  # noqa: E402
from bigdl_tpu.models import resnet as jresnet  # noqa: E402
from bigdl_tpu.models.rnn import ptb_model as jptb_model  # noqa: E402
from bigdl_tpu.nn.quantized import QuantizedLinear as JQuantizedLinear  # noqa: E402
from bigdl_tpu.nn.quantized import \
    QuantizedSpatialConvolution as JQuantizedConv  # noqa: E402
from bigdl_tpu.ops import pallas_int8_gemm as jgemm  # noqa: E402
from bigdl_tpu.utils import precision as jprecision  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import SparseSample, batch_sparse_samples  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet as tlenet  # noqa: E402
from bigdl_tpu_torch.models import ptb_model  # noqa: E402
from bigdl_tpu_torch.models import resnet as tresnet  # noqa: E402
from bigdl_tpu_torch.ops import embed_bag, int8_gemm, lstm_cell, maxpool  # noqa: E402
from bigdl_tpu_torch.utils import precision  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_wide_deep as wd  # noqa: E402
from test_torch_precision import _small_model  # noqa: E402
from test_torch_resnet_training import _tiny_resnet  # noqa: E402

PTB_STEP_LIMIT = 5e-2
STEP_LIMIT = {"lenet": 5e-2, "resnet": 0.5, "ptb": PTB_STEP_LIMIT}


def test_mixed_precision_f16_loss_and_grads_match_reference():
    rng = np.random.default_rng(5)
    tm = _small_model(nn).initialize(3).train()
    params, state = to_jax_params(tm)
    x = rng.normal(0, 1, (6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 5, 6).astype(np.int32)
    jloss_fn = jprecision.mixed_precision_loss_fn(
        _small_model(jnn), jnn.ClassNLLCriterion(), jnp.float16)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jloss_fn(p, state, jnp.asarray(x), jnp.asarray(y), None),
        has_aux=True)(params)
    tparams = dict(tm.named_parameters())
    for p in tparams.values():
        p.requires_grad_(True)
    seen = []
    sound = maxpool.maxpool_bwd_reference

    def spy(x, *a):
        seen.append(x.dtype)
        return sound(x, *a)
    maxpool.maxpool_bwd_reference = spy
    try:
        loss = precision.mixed_precision_loss_fn(
            tm, nn.ClassNLLCriterion(), torch.float16)(
            tparams, torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
    finally:
        maxpool.maxpool_bwd_reference = sound
    assert seen == [torch.float16]  # the pool's backward ran in f16
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-3)
    jflat = {".".join(str(q.key) for q in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == sorted(tparams)
    for k, want in jflat.items():
        got = tparams[k].grad
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-2 * np.abs(want).max(), err_msg=k)


def _lenet_samples(S, n=8):
    rng = np.random.default_rng(0)
    return [S(rng.normal(0, 1, (28, 28)).astype(np.float32),
              np.int32(i % 10)) for i in range(n)]


def _resnet_samples(S, n=8):
    rng = np.random.default_rng(1)
    return [S(rng.normal(0, 1, (32, 32, 3)).astype(np.float32),
              np.int32(i % 10)) for i in range(n)]


# PTB-small's widths (embed and hidden 200, 2 layers), its vocabulary cut to
# 100 words and its 20 steps to 8, batch 8
PTB_VOCAB, PTB_T = 100, 8


def _ptb_samples(S, n=8):
    ids = np.random.default_rng(2).integers(0, PTB_VOCAB, n * PTB_T + 1)
    ids = ids.astype(np.int32)
    return [S(ids[i * PTB_T:(i + 1) * PTB_T],
              ids[i * PTB_T + 1:(i + 1) * PTB_T + 1]) for i in range(n)]


def _nll(m):
    return m.ClassNLLCriterion()


def _time_nll(m):
    return m.TimeDistributedCriterion(m.ClassNLLCriterion())


# name: (port model, reference model, samples, criterion of either package)
MODELS = {
    "lenet": (lambda: tlenet.lenet5(10), lambda: jlenet.lenet5(10),
              _lenet_samples, _nll),
    "resnet": (lambda: _tiny_resnet(tresnet, nn),
               lambda: _tiny_resnet(jresnet, jnn), _resnet_samples, _nll),
    # the reference sends f16 to its XLA chain; the port's f16 LSTM cell
    # computes in f32 and rounds h' and c' once
    "ptb": (lambda: ptb_model(PTB_VOCAB, 200, 200, 2),
            lambda: jptb_model(PTB_VOCAB, 200, 200, 2, kernel_impl="pallas"),
            _ptb_samples, _time_nll),
}


class F16Masters(optim.SGD):
    """The planted fault: master weights kept in f16 (each update rounded
    to f16)."""

    def update(self, grads, params, state, lr, step):
        super().update(grads, params, state, lr, step)
        with torch.no_grad():
            for p in params.values():
                p.copy_(p.half().float())


def _step(name, method=optim.SGD):
    make, jmake, samples, crit = MODELS[name]
    model = make().initialize(0)
    start = copy.deepcopy(to_jax_params(model))
    losses = []

    class Recording(optim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    (Recording(model, DataSet.array(samples(Sample)) >> SampleToMiniBatch(8),
               crit(nn), device="cpu")
     .set_optim_method(method(learning_rate=0.01))
     .set_compute_dtype(torch.float16)
     .set_end_when(optim.max_iteration(1)).optimize())
    return start, losses, to_jax_params(model)


def _ref_step(name, start):
    jm = MODELS[name][1]()
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = jax.tree_util.tree_map(jnp.asarray, start[1])
    losses = []

    class Recording(joptim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    (Recording(jm, JDataSet.array(MODELS[name][2](JSample)) >> JBatch(8),
               MODELS[name][3](jnn))
     .set_optim_method(joptim.SGD(learning_rate=0.01))
     .set_compute_dtype(jnp.float16)
     .set_end_when(joptim.max_iteration(1)).optimize())
    return losses, (jm._params, jm._state)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _worst_change_share(start, got, want):
    init, got, want = (_flat(t[0]) for t in (start, got, want))
    assert sorted(got) == sorted(want)
    return max(np.linalg.norm(got[k] - want[k])
               / np.linalg.norm(want[k] - init[k]) for k in want)


@pytest.fixture(scope="module")
def reference_steps():
    out = {}
    for name in MODELS:
        start, losses, trained = _step(name)
        out[name] = (start, losses, trained, *_ref_step(name, start))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f16_step_matches_reference(reference_steps, name):
    start, losses, trained, jlosses, jtrained = reference_steps[name]
    assert len(losses) == len(jlosses) == 1
    np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
    assert all(v.dtype == np.float32 for v in _flat(trained[0]).values())
    assert _worst_change_share(start, trained, jtrained) < STEP_LIMIT[name]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_f16_master_weights_fault_exceeds_the_limit(reference_steps, name):
    start, _, _, _, jtrained = reference_steps[name]
    _, _, faulty = _step(name, F16Masters)
    assert _worst_change_share(start, faulty, jtrained) > STEP_LIMIT[name]


def test_plain_max_pool_backward_adds_in_f16():
    """Overlapping windows add their gradients in f16, one (dh, dw) offset
    after another, as the kernel does: 1 then three 2^-11 stays 1 in f16
    (each add a tie, rounded to even), where the f32 sum rounded once
    would give 1 + 2^-9."""
    x = torch.full((1, 1, 3, 3), -1.0, dtype=torch.float16)
    x[0, 0, 1, 1] = 0.0  # the max of all four 2x2 windows
    y = torch.zeros(1, 1, 2, 2, dtype=torch.float16)
    # window (1, 1) holds the centre at offset (0, 0): its gradient first
    g = torch.tensor([[[[2.0 ** -11, 2.0 ** -11], [2.0 ** -11, 1.0]]]],
                     dtype=torch.float16)
    gi = maxpool.maxpool_bwd_reference(x, y, g, (2, 2), (1, 1),
                                       ((0, 0), (0, 0)))
    assert gi.dtype == torch.float16
    assert float(gi[0, 0, 1, 1]) == 1.0
    assert float(g.float().sum().half()) == 1.0 + 2.0 ** -9
    assert float(gi.float().sum()) == 1.0


class F16MasterAdam(optim.Adam):
    """The planted fault for Adam: master weights kept in f16."""

    def update(self, grads, params, state, lr, step):
        super().update(grads, params, state, lr, step)
        with torch.no_grad():
            for p in params.values():
                p.copy_(p.half().float())


WD_STEP_LIMIT = 5e-3


def _wd_block(method=optim.Adam, steps=2):
    """A K=2 block of the small Wide&Deep of ``test_torch_wide_deep`` in
    f16 on the CPU: (start, losses, trained params, the dtypes of the COO
    values the wide part received, B3 plain-version calls by table
    dtype)."""
    tmodel, _, start = wd._models(4)
    seen, tables = [], []
    tmodel.wide.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].values.dtype))
    sound = embed_bag.embedding_bag_coo_reference

    def spy(rows, cols, values, table, n_rows):
        tables.append((table.dtype, values.dtype))
        return sound(rows, cols, values, table, n_rows)
    opt = (wd._recording(optim.LocalOptimizer)(
        tmodel, DataSet.array(wd._samples(SparseSample), seed=3)
        >> wd._SparseToMiniBatch(batch_sparse_samples),
        wd._SqueezedBCE(nn.BCECriterion()), device="cpu")
        .set_optim_method(method(learning_rate=0.01))
        .set_compute_dtype(torch.float16)
        .set_steps_per_dispatch(steps)
        .set_end_when(optim.max_iteration(steps)))
    embed_bag.embedding_bag_coo_reference = spy
    try:
        opt.optimize()
    finally:
        embed_bag.embedding_bag_coo_reference = sound
    return start, opt.losses, to_jax_params(tmodel), seen, tables


@pytest.fixture(scope="module")
def wd_reference():
    start, losses, trained, seen, tables = _wd_block()
    _, jmodel, _ = wd._models(4)
    jmodel._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jmodel._state = start[1]
    jopt = (wd._recording(joptim.LocalOptimizer)(
        jmodel, JDataSet.array(wd._samples(wd.JSparseSample), seed=3)
        >> wd._SparseToMiniBatch(wd.jbatch),
        wd._SqueezedBCE(jnn.BCECriterion()))
        .set_optim_method(joptim.Adam(learning_rate=0.01))
        .set_compute_dtype(jnp.float16)
        .set_steps_per_dispatch(2)
        .set_end_when(joptim.max_iteration(2)))
    jopt.optimize()
    return (start, losses, trained, seen, tables, jopt.losses,
            (jmodel._params, jmodel._state))


def test_f16_wide_deep_block_matches_reference(wd_reference):
    start, losses, trained, seen, tables, jlosses, jtrained = wd_reference
    assert set(seen) == {torch.float16}, seen
    # the forward's f16 table with f16 values, the table gradient's f32
    # cotangent with them, two calls a step
    assert tables == [(torch.float16, torch.float16),
                      (torch.float32, torch.float16)] * 2
    assert len(losses) == len(jlosses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert all(v.dtype == np.float32 for v in _flat(trained[0]).values())
    assert _worst_change_share(start, trained, jtrained) < WD_STEP_LIMIT


def test_f16_wide_deep_master_weights_fault_exceeds_the_limit(wd_reference):
    start, jtrained = wd_reference[0], wd_reference[-1]
    faulty = _wd_block(F16MasterAdam)[2]
    assert _worst_change_share(start, faulty, jtrained) > WD_STEP_LIMIT


def test_f16_ptb_step_runs_the_cell_in_f16():
    """The PTB step above reaches the LSTM cell's plain versions with f16
    tensors (B2f's and B2b's f16 forms on the card), forward and backward
    once a time step (layer 0's cell, as on the card)."""
    seen = []
    fwd, bwd = lstm_cell.lstm_cell_fwd_reference, \
        lstm_cell.lstm_cell_bwd_reference

    def spy_fwd(zx, h, c, w_t, fb=0.0):
        seen.append(("fwd", zx.dtype, h.dtype, c.dtype, w_t.dtype))
        return fwd(zx, h, c, w_t, fb)

    def spy_bwd(z, c, dh, dc, fb=0.0):
        seen.append(("bwd", c.dtype, dh.dtype, dc.dtype))
        return bwd(z, c, dh, dc, fb)
    lstm_cell.lstm_cell_fwd_reference = spy_fwd
    lstm_cell.lstm_cell_bwd_reference = spy_bwd
    try:
        _step("ptb")
    finally:
        lstm_cell.lstm_cell_fwd_reference = fwd
        lstm_cell.lstm_cell_bwd_reference = bwd
    h = torch.float16
    assert seen.count(("fwd", h, h, h, h)) == PTB_T
    assert seen.count(("bwd", h, h, h)) == PTB_T
    assert len(seen) == 2 * PTB_T


GEMM_ROWS = {
    "normal": lambda shape: np.random.default_rng(6).normal(
        0, 1, shape).astype(np.float16),
    "zero": lambda shape: np.zeros(shape, np.float16),
    # amax f16's least subnormal: an f16 scale of 0, every quotient +-inf
    "least_subnormal": lambda shape: np.full(
        shape, np.float16(2.0 ** -24)) * np.where(
        np.random.default_rng(7).random(shape) < 0.5, -1, 1).astype(
        np.float16),
}


def _close_in_mode(got, want, mode):
    got = got.detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if mode == "dynamic":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("rows", sorted(GEMM_ROWS))
@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
def test_int8_matmul_f16_rows_match_reference(mode, rows):
    """(4, 256) f16 rows against a (128, 256) int8 panel: the reference's
    jitted XLA chain (which f16 takes), and ``dyn_quantize`` bitwise."""
    rng = np.random.default_rng(8)
    x = GEMM_ROWS[rows]((4, 256))
    wq = rng.integers(-127, 128, (128, 256)).astype(np.int8)
    ws = rng.uniform(0.001, 0.02, (128, 1)).astype(np.float32)
    b = rng.normal(0, 1, 128).astype(np.float32)
    want = np.asarray(jax.jit(lambda *a: jgemm.int8_matmul(
        *a, mode=mode, impl="xla"))(x, wq, ws, b))
    got = int8_gemm.int8_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                                torch.from_numpy(ws), torch.from_numpy(b),
                                mode=mode)
    _close_in_mode(got, want, mode)
    q, scale = int8_gemm.dyn_quantize(torch.from_numpy(x))
    jq, jscale = jax.jit(jgemm.dyn_quantize)(x)
    assert scale.dtype == torch.float16 and str(jscale.dtype) == "float16"
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("rows", sorted(GEMM_ROWS))
@pytest.mark.parametrize("mode", ["weight_only", "dynamic"])
@pytest.mark.parametrize("layer", ["linear", "stem_conv"])
def test_quantized_layers_take_f16_rows_as_reference(layer, mode, rows):
    """``QuantizedLinear`` (256 -> 128) and the quantized stem conv (3 -> 8
    channels, 7x7/2 pad 3: K=147) on f16 input, against the reference's
    quantized modules from the same float weights, jitted (the conv takes
    its direct simulation ``_apply_sim``, the linear the XLA chain)."""
    if layer == "linear":
        jm, shape = jnn.Linear(256, 128), (4, 256)
        make = lambda: nn.Linear(256, 128)  # noqa: E731
        jq_cls, tq = JQuantizedLinear.from_linear, nn.QuantizedLinear.from_linear
    else:
        jm, shape = jnn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3), \
            (2, 3, 20, 20)
        make = lambda: nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3)  # noqa: E731
        jq_cls, tq = (JQuantizedConv.from_conv,
                      nn.QuantizedSpatialConvolution.from_conv)
    params, _ = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(0)))
    jq = jq_cls(jm, params, mode=mode)
    x = GEMM_ROWS[rows](shape)
    want = np.asarray(jax.jit(lambda v: jq.apply({}, {}, v)[0])(x))
    q = tq(load_jax_params(make(), params), mode=mode)
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    _close_in_mode(got, want, mode)

"""Wide&Deep (``models/recommender.py``) on the CPU against the reference's:
the forward and every parameter's gradient from the same weights, with
the wide part as batch COO (the reference's Pallas kernel in interpret
mode) and as id bags; and training through the port's ``LocalOptimizer``
fed by ``SparseSample`` -> ``batch_sparse_samples`` -> ``SparseMiniBatch``
against the reference's ``LocalOptimizer`` on the same data, with the
recipe's ``--sparse-coo`` optimizer (Adam at lr 0.01) and BCE on the
sigmoid score (as ``_run_sparse_driver`` in ``tests/test_pallas_kernels.py``).

Also: the block stager over nested COO batches against the reference's
(bitwise), and the BCE criteria against the reference's.

Sizes are cut (wide 60, fields 7/5/3 at embed 4, dense 4, MLP (8, 6),
batch 8).  Tolerances: forward ``rtol = atol = 1e-6`` and gradients
``1e-5`` of each array's largest value (the MLP's products summed in
another order; the wide part's kernel is bitwise and its gradient one FMA
against a rounded product and sum); training losses ``rtol=1e-5`` and
final parameters ``1e-4`` of each array's largest value over 8 Adam steps.
Within the port, K=1 and K=4 are bitwise-equal.  Criteria: loss
``rtol=1e-6``, input gradient ``rtol=1e-5, atol=1e-6`` (log and log1p
in two libraries).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SparseSample as JSparseSample  # noqa: E402
from bigdl_tpu.dataset import batch_sparse_samples as jbatch  # noqa: E402
from bigdl_tpu.dataset.prefetch import DeviceBlockStager as JStager  # noqa: E402
from bigdl_tpu.dataset import MiniBatch as JMiniBatch  # noqa: E402
from bigdl_tpu.models.recommender import NeuralCF as JNeuralCF  # noqa: E402
from bigdl_tpu.models.recommender import WideAndDeep as JWideAndDeep  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import (DataSet, MiniBatch,  # noqa: E402
                                     SparseSample, Transformer,
                                     batch_sparse_samples)
from bigdl_tpu_torch.dataset.prefetch import DeviceBlockStager  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import NeuralCF, WideAndDeep  # noqa: E402
from bigdl_tpu_torch.ops import embed_bag  # noqa: E402

WIDE, FIELDS, DENSE, EMBED, HIDDEN = 60, [7, 5, 3], 4, 4, (8, 6)
BATCH, STEPS, BUCKET = 8, 8, [64]


def _models(seed=0):
    t = WideAndDeep(WIDE, FIELDS, DENSE, EMBED, HIDDEN).initialize(seed)
    j = JWideAndDeep(WIDE, FIELDS, DENSE, EMBED, HIDDEN, kernel_impl="pallas")
    return t, j, to_jax_params(t)


def _samples(S, n=40, seed=0):
    """Ragged wide ids (1-4 a sample), one id per deep field, dense
    features, and a label from a planted teacher over the wide ids and
    field 0."""
    rng = np.random.default_rng(seed)
    w_wide = rng.normal(0, 1, WIDE)
    w_f0 = rng.normal(0, 1, FIELDS[0])
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 5))
        idx = rng.choice(WIDE, k, replace=False).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, k).astype(np.float32)
        deep = np.array([rng.integers(0, c) for c in FIELDS], np.int32)
        dense = rng.normal(0, 1, DENSE).astype(np.float32)
        logit = float(w_wide[idx] @ vals + w_f0[deep[0]])
        out.append(S(idx, vals, WIDE, dense=[deep, dense],
                     label=np.float32(logit > 0)))
    return out


def _batch_inputs():
    """One batch as both packages' input: COO and bags."""
    jb = jbatch(_samples(JSparseSample)[:BATCH], BUCKET)
    tb = batch_sparse_samples(_samples(SparseSample)[:BATCH], BUCKET)
    jc, jdeep, jdense = jb.input
    tc, tdeep, tdense = tb.input
    # the same stream as fixed-width bags (ids, weights), -1 padded
    r, c, v = (np.asarray(a) for a in (jc.row, jc.col, jc.values))
    ids = np.full((BATCH, 4), -1, np.int32)
    w = np.zeros((BATCH, 4), np.float32)
    fill = np.zeros(BATCH, int)
    for row, col, val in zip(r, c, v):
        if val != 0:
            ids[row, fill[row]], w[row, fill[row]] = col, val
            fill[row] += 1
    jx = {"coo": (jc, jnp.asarray(jdeep), jnp.asarray(jdense)),
          "bags": ((jnp.asarray(ids), jnp.asarray(w)), jnp.asarray(jdeep),
                   jnp.asarray(jdense))}
    tx = {"coo": (tc, torch.from_numpy(tdeep), torch.from_numpy(tdense)),
          "bags": ((torch.from_numpy(ids), torch.from_numpy(w)),
                   torch.from_numpy(tdeep), torch.from_numpy(tdense))}
    return jx, tx, torch.from_numpy(tb.target), jnp.asarray(jb.target)


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("form", ["coo", "bags"])
def test_forward_and_gradients_match_reference(form):
    tmodel, jmodel, (params, state) = _models()
    jx, tx, ty, jy = _batch_inputs()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(p):
        out, _ = jmodel.apply(p, state, jx[form])
        return jnn.BCECriterion().apply(out[:, 0], jy), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    tout = tmodel(tx[form])
    tl = nn.BCECriterion().apply(tout[:, 0], ty)
    tl.backward()
    assert tout.shape == (BATCH, 1)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    jflat = _flat(jg)
    tgrads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    assert tgrads.keys() == jflat.keys()
    for k, want in jflat.items():
        np.testing.assert_allclose(tgrads[k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)
    assert embed_bag.launches == 0


def test_unsorted_coo_rows_match_sorted():
    """The wide part reads rows in any order: the batch's COO stream
    reversed gives the same scores, bitwise."""
    tmodel, _, _ = _models(1)
    _, tx, _, _ = _batch_inputs()
    coo, deep, dense = tx["coo"]
    rev = nn.COOBatch(coo.row.flip(0), coo.col.flip(0), coo.values.flip(0),
                      coo.dense_shape)
    with torch.no_grad():
        assert torch.equal(tmodel((coo, deep, dense)),
                           tmodel((rev, deep, dense)))


class _SparseToMiniBatch(Transformer):
    """SparseSamples in batches of ``BATCH`` through batch_sparse_samples
    at one nnz bucket, so every batch has one signature."""

    def __init__(self, batch):
        self.batch = batch

    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == BATCH:
                yield self.batch(buf, BUCKET)
                buf = []


class _SqueezedBCE:
    """BCE on the (N, 1) score's column (the recipe's loss)."""

    def __init__(self, bce):
        self.bce = bce

    def apply(self, out, y):
        return self.bce.apply(out[:, 0], y)


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _port_run(k):
    model, _, start = _models(2)
    opt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(_samples(SparseSample), seed=3)
        >> _SparseToMiniBatch(batch_sparse_samples),
        _SqueezedBCE(nn.BCECriterion()), device="cpu")
        .set_optim_method(optim.Adam(learning_rate=0.01))
        .set_steps_per_dispatch(k)
        .set_end_when(optim.max_iteration(STEPS)))
    assert opt.optimize() is model
    return start, opt, to_jax_params(model)[0]


@pytest.fixture(scope="module")
def port_runs():
    return {k: _port_run(k) for k in (1, 4)}


def test_local_optimizer_matches_reference(port_runs):
    start, topt, tparams = port_runs[4]
    _, jmodel, _ = _models()
    jmodel._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jmodel._state = start[1]
    jopt = (_recording(joptim.LocalOptimizer)(
        jmodel, JDataSet.array(_samples(JSparseSample), seed=3)
        >> _SparseToMiniBatch(jbatch), _SqueezedBCE(jnn.BCECriterion()))
        .set_optim_method(joptim.Adam(learning_rate=0.01))
        .set_steps_per_dispatch(4)
        .set_end_when(joptim.max_iteration(STEPS)))
    jopt.optimize()
    assert len(topt.losses) == len(jopt.losses) == STEPS
    np.testing.assert_allclose(topt.losses, jopt.losses, rtol=1e-5)
    for key in ("neval", "epoch", "records_processed_this_epoch"):
        assert topt.state[key] == jopt.state[key], key
    assert topt.state["epoch"] == 1  # 5 batches an epoch: one rollover
    tflat = _flat(tparams)
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jmodel._params))
    assert tflat.keys() == jflat.keys()
    for key, want in jflat.items():
        np.testing.assert_allclose(tflat[key], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)
    assert np.mean(topt.losses[-3:]) < np.mean(topt.losses[:3])


# a bf16 block against the reference's: both round the forward and the
# backward to bf16 (8 bits of mantissa, about 4e-3 relative), but at other
# places (PyTorch's bf16 matmul accumulates in f32 and rounds once, XLA's
# CPU dot may round its partial sums), so they agree to a few bf16 ulps,
# not bitwise.  Adam's first steps move a weight by about lr * sign(g), so
# where g is within rounding of 0 the update's size is rounding's choice:
# the largest reading, deep.0.weight, is 1.7e-2 of its largest update
# (the losses 5e-4)
BF16_TOL = 3e-2


def test_bf16_step_matches_reference():
    """Under ``set_compute_dtype(bf16)`` the wide part computes in bf16 in
    both packages (the COO values are cast with the batch), and a K=2
    block of Adam steps agrees with the reference within BF16_TOL."""
    steps = 2

    tmodel, jmodel, start = _models(4)
    seen = []  # the dtype of the COO values the wide part receives
    tmodel.wide.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].values.dtype))
    topt = (_recording(optim.LocalOptimizer)(
        tmodel, DataSet.array(_samples(SparseSample), seed=3)
        >> _SparseToMiniBatch(batch_sparse_samples),
        _SqueezedBCE(nn.BCECriterion()), device="cpu")
        .set_optim_method(optim.Adam(learning_rate=0.01))
        .set_compute_dtype(torch.bfloat16)
        .set_steps_per_dispatch(steps)
        .set_end_when(optim.max_iteration(steps)))
    topt.optimize()
    assert seen and set(seen) == {torch.bfloat16}, seen
    jmodel._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jmodel._state = start[1]
    jopt = (_recording(joptim.LocalOptimizer)(
        jmodel, JDataSet.array(_samples(JSparseSample), seed=3)
        >> _SparseToMiniBatch(jbatch), _SqueezedBCE(jnn.BCECriterion()))
        .set_optim_method(joptim.Adam(learning_rate=0.01))
        .set_compute_dtype(jnp.bfloat16)
        .set_steps_per_dispatch(steps)
        .set_end_when(joptim.max_iteration(steps)))
    jopt.optimize()
    assert len(topt.losses) == len(jopt.losses) == steps
    np.testing.assert_allclose(topt.losses, jopt.losses, rtol=BF16_TOL)
    tflat = _flat(to_jax_params(tmodel)[0])
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jmodel._params))
    sflat = _flat(start[0])
    assert tflat.keys() == jflat.keys()
    for key, want in jflat.items():
        # Adam moves each weight by about lr: compare the update
        np.testing.assert_allclose(
            tflat[key] - sflat[key], want - sflat[key], rtol=BF16_TOL,
            atol=BF16_TOL * np.abs(want - sflat[key]).max(), err_msg=key)


def test_k1_and_k4_bitwise(port_runs):
    (_, o1, p1), (_, o4, p4) = port_runs[1], port_runs[4]
    assert o1.losses == o4.losses
    f1, f4 = _flat(p1), _flat(p4)
    for key in f1:
        np.testing.assert_array_equal(f1[key], f4[key])
    assert o1._dispatch_count == STEPS
    # K=4 blocks capped at the epoch end (step 5): 4+1, then 3
    assert o4._dispatch_count == 3
    assert embed_bag.launches == 0


def test_stager_blocks_nested_coo_like_reference():
    """Blocks of ``(COOBatch, deep_ids, dense)`` batches: every leaf
    stacked along the step axis, and a block broken where the nnz bucket
    changes, as the reference's stager does."""
    buckets = [[32], [32], [64], [64], [64], [32]]

    def batches(S, batch):
        ss = _samples(S, n=8 * len(buckets), seed=5)
        return iter([batch(ss[8 * i:8 * i + 8], b)
                     for i, b in enumerate(buckets)])

    ts = DeviceBlockStager(batches(SparseSample, batch_sparse_samples), "cpu")
    js = JStager(batches(JSparseSample, jbatch), lambda x, y: (x, y))
    for want_k in (2, 3, 1):
        block = ts.take(4, 10 ** 6)
        jxs, jys, jsizes = js.take(4, 10 ** 6)
        assert block.sizes == jsizes == [8] * want_k
        (tc, tdeep, tdense), (jc, jdeep, jdense) = block.xs, jxs
        assert tc.dense_shape == jc.dense_shape == (8, WIDE)
        for a, b in ((tc.row, jc.row), (tc.col, jc.col),
                     (tc.values, jc.values), (tdeep, jdeep),
                     (tdense, jdense), (block.ys, jys)):
            assert a.shape[0] == want_k
            assert np.array_equal(a.numpy(), np.asarray(b))
        x1, y1 = block.step(want_k - 1)
        assert torch.equal(x1[0].row, tc.row[want_k - 1])
        assert torch.equal(y1, block.ys[want_k - 1])


@pytest.mark.parametrize("name", ["bce", "bce_weighted_sum", "bce_logits"])
def test_criteria_match_reference(name):
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, 12).astype(np.float32)
    x[:2] = (0.0, 1.0)  # saturated: the f32 eps clamp keeps log finite
    if name == "bce_logits":
        x = rng.normal(0, 4, 12).astype(np.float32)
    y = rng.integers(0, 2, 12).astype(np.float32)
    w = rng.uniform(0.5, 2, 12).astype(np.float32)
    if name == "bce":
        tc, jc = nn.BCECriterion(), jnn.BCECriterion()
    elif name == "bce_weighted_sum":
        tc = nn.BCECriterion(w, size_average=False)
        jc = jnn.BCECriterion(jnp.asarray(w), size_average=False)
    else:
        tc, jc = nn.BCEWithLogitsCriterion(), jnn.BCEWithLogitsCriterion()
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = tc.apply(xt, torch.from_numpy(y))
    loss.backward()
    jl, jg = jax.value_and_grad(lambda a: jc.apply(a, jnp.asarray(y)))(
        jnp.asarray(x))
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------- NeuralCF
# the reference's NeuralCF at small counts (its default widths): forward
# and gradients from the same weights within rtol 1e-5 (f32 sums in
# another order), a LocalOptimizer run (Adam, BCE) within the Wide&Deep
# run's limits
NCF_USERS, NCF_ITEMS = 30, 20


def _ncf_ratings(seed):
    from bigdl_tpu_torch.dataset import movielens
    r = movielens.synthetic_ratings(NCF_USERS, NCF_ITEMS, 64, seed=seed)
    return r[:, 0] - 1, r[:, 1] - 1, (r[:, 2] >= 4).astype(np.float32)


class _PairsToMiniBatch(Transformer):
    """(user, item, clicked) triples in batches of ``BATCH``: input the
    (users, items) pair, as NeuralCF takes it."""

    def __init__(self, make):
        self.make = make

    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == BATCH:
                u, i, y = (np.asarray([b[k] for b in buf]) for k in range(3))
                yield self.make((u.astype(np.int32), i.astype(np.int32)), y)
                buf = []


def test_neural_cf_forward_and_gradients_match_reference():
    tmodel = NeuralCF(NCF_USERS, NCF_ITEMS).initialize(4)
    params, state = to_jax_params(tmodel)
    assert sorted(params) == ["head", "item_gmf", "item_mlp", "mlp",
                              "user_gmf", "user_mlp"]
    jmodel = JNeuralCF(NCF_USERS, NCF_ITEMS)
    users, items, y = _ncf_ratings(1)

    def jloss(p):
        out, _ = jmodel.apply(p, state, (jnp.asarray(users),
                                         jnp.asarray(items)))
        return jnn.BCECriterion().apply(out[:, 0], jnp.asarray(y)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    for p in tmodel.parameters():
        p.requires_grad_(True)
    tout = tmodel((torch.from_numpy(users), torch.from_numpy(items)))
    tl = nn.BCECriterion().apply(tout[:, 0], torch.from_numpy(y))
    tl.backward()
    assert tout.shape == (64, 1)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tgrads = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    jflat = _flat(jg)
    assert tgrads.keys() == jflat.keys()
    for k, want in jflat.items():
        np.testing.assert_allclose(tgrads[k], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_neural_cf_local_optimizer_matches_reference():
    users, items, y = _ncf_ratings(2)
    triples = list(zip(users, items, y))
    model = NeuralCF(NCF_USERS, NCF_ITEMS).initialize(5)
    start = to_jax_params(model)
    topt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(triples, seed=3) >> _PairsToMiniBatch(MiniBatch),
        _SqueezedBCE(nn.BCECriterion()), device="cpu")
        .set_optim_method(optim.Adam(learning_rate=0.01))
        .set_end_when(optim.max_iteration(STEPS)))
    topt.optimize()
    jmodel = JNeuralCF(NCF_USERS, NCF_ITEMS)
    jmodel._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jmodel._state = start[1]
    jopt = (_recording(joptim.LocalOptimizer)(
        jmodel, JDataSet.array(triples, seed=3)
        >> _PairsToMiniBatch(JMiniBatch), _SqueezedBCE(jnn.BCECriterion()))
        .set_optim_method(joptim.Adam(learning_rate=0.01))
        .set_end_when(joptim.max_iteration(STEPS)))
    jopt.optimize()
    assert len(topt.losses) == len(jopt.losses) == STEPS
    np.testing.assert_allclose(topt.losses, jopt.losses, rtol=1e-5)
    tflat = _flat(to_jax_params(model)[0])
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jmodel._params))
    for key, want in jflat.items():
        np.testing.assert_allclose(tflat[key], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)

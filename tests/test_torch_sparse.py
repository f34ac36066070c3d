"""The port's sparse layers (``nn/sparse.py``), sparse batching
(``dataset/sample.py``), feature columns (``dataset/datamining.py``) and
MovieLens helpers on the CPU against the reference package.

Weights cross with ``load_jax_params``.  The reference's COO path runs its
Pallas kernel in interpret mode (``impl="pallas"``), so a COO ``sum``
layer is held BITWISE (both add each row's entries in nnz order with one
FMA each); ``mean``/``sqrtn`` divide by a per-row sum taken in the same
order and are held bitwise too.  The id-bag path sums a bag with
``einsum`` on both sides, in orders that may differ: ``rtol = atol =
1e-6``.  Gradients of the weight: the reference's COO backward is XLA's
scatter-add (product and sum rounded apart), the port's is kernel B3 with
rows and cols swapped (one FMA each): within ``1e-6`` of the largest
value.  Host-side batching and the feature columns are integer and copy
work and are held bitwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import dataset as jdataset  # noqa: E402
from bigdl_tpu.dataset import datamining as jdm  # noqa: E402
from bigdl_tpu.dataset import movielens as jml  # noqa: E402
from bigdl_tpu.nn import sparse as jsparse  # noqa: E402
from bigdl_tpu_torch import dataset as tdataset  # noqa: E402
from bigdl_tpu_torch.dataset import datamining as tdm  # noqa: E402
from bigdl_tpu_torch.dataset import movielens as tml  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params  # noqa: E402
from bigdl_tpu_torch.nn import sparse as tsparse  # noqa: E402
from bigdl_tpu_torch.ops import embed_bag  # noqa: E402

N, V, O, B = 6, 40, 5, 4


def _coo_arrays(seed=0, nnz=20, pad=4):
    """Unsorted rows with duplicates, row 4 left empty, then a padding
    tail."""
    rng = np.random.default_rng(seed)
    rows = rng.choice([0, 1, 2, 3, 5], nnz).astype(np.int32)
    cols = rng.integers(0, V, nnz).astype(np.int32)
    vals = rng.normal(0, 1, nnz).astype(np.float32)
    z = np.zeros(pad, np.int32)
    return (np.concatenate([rows, z]), np.concatenate([cols, z]),
            np.concatenate([vals, np.zeros(pad, np.float32)]))


def _coos(seed=0, **kw):
    r, c, v = _coo_arrays(seed, **kw)
    return (jsparse.COOBatch(jnp.asarray(r), jnp.asarray(c), jnp.asarray(v),
                             (N, V)),
            tsparse.COOBatch(torch.from_numpy(r), torch.from_numpy(c),
                             torch.from_numpy(v), (N, V)))


def _bags(seed=1, weighted=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (N, B)).astype(np.int32)
    ids[rng.random((N, B)) < 0.3] = -1
    ids[2] = -1  # an empty bag
    w = rng.normal(0, 1, (N, B)).astype(np.float32)
    if not weighted:
        return jnp.asarray(ids), torch.from_numpy(ids)
    return ((jnp.asarray(ids), jnp.asarray(w)),
            (torch.from_numpy(ids), torch.from_numpy(w)))


def _pair(jmodule, tmodule, seed):
    params, state = jmodule.init(jax.random.PRNGKey(seed))
    load_jax_params(tmodule, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    return params


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    if tol == 0:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())


def _weight_grads(jmodule, tmodule, params, jin, tin):
    def loss(p):
        out, _ = jmodule.apply(p, {}, jin)
        return (out.astype(jnp.float32) ** 3).sum()

    jg = jax.grad(loss)(params)
    for p in tmodule.parameters():
        p.requires_grad_(True)
    (tmodule(tin).float() ** 3).sum().backward()
    return jg, {k: p.grad for k, p in tmodule.named_parameters()}


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("form", ["coo", "bags", "bags_unweighted"])
def test_lookup_table_sparse(combiner, form):
    jm = jsparse.LookupTableSparse(V, O, combiner, impl="pallas")
    tm = tsparse.LookupTableSparse(V, O, combiner)
    params = _pair(jm, tm, 3)
    if form == "coo":
        jin, tin = _coos()
    else:
        jin, tin = _bags(weighted=form == "bags")
    want, _ = jm.apply(params, {}, jin)
    got = tm(tin)
    _close(got, want, 0 if form == "coo" else 1e-6)
    jg, tg = _weight_grads(jm, tm, params, jin, tin)
    _close(tg["weight"], jg["weight"], 1e-6)
    assert embed_bag.launches == 0


@pytest.mark.parametrize("form", ["coo", "bags"])
def test_sparse_linear(form):
    jm = jsparse.SparseLinear(V, O, impl="pallas")
    tm = tsparse.SparseLinear(V, O)
    params = _pair(jm, tm, 4)
    assert tuple(tm.weight.shape) == (V, O)  # W.T, as in the reference
    jin, tin = _coos(2) if form == "coo" else _bags(3)
    want, _ = jm.apply(params, {}, jin)
    _close(tm(tin), want, 0 if form == "coo" else 1e-6)
    jg, tg = _weight_grads(jm, tm, params, jin, tin)
    for k in ("weight", "bias"):
        _close(tg[k], jg[k], 1e-6)


def test_sparse_linear_init_bounds():
    """RandomUniform at fan_in = input_size, weight and bias."""
    tm = tsparse.SparseLinear(400, 3).initialize(0)
    b = 1 / np.sqrt(400)
    for p in (tm.weight, tm.bias):
        assert p.abs().max() <= b and p.abs().max() > 0.5 * b


def test_sparse_join_table_coo_unsorted_rows():
    (ja, ta), (jb, tb) = _coos(5, nnz=7, pad=0), _coos(6, nnz=9, pad=2)
    jm, tm = jsparse.SparseJoinTable([V, V]), tsparse.SparseJoinTable([V, V])
    want, _ = jm.apply({}, {}, [ja, jb])
    got = tm([ta, tb])
    assert got.dense_shape == want.dense_shape == (N, 2 * V)
    for a, b in ((got.row, want.row), (got.col, want.col),
                 (got.values, want.values)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert not np.all(np.diff(got.row.numpy()) >= 0)  # rows unsorted
    # and a layer over the joined stream agrees bitwise
    jl = jsparse.SparseLinear(2 * V, O, impl="pallas")
    tl = tsparse.SparseLinear(2 * V, O)
    params = _pair(jl, tl, 7)
    _close(tl(got), jl.apply(params, {}, want)[0], 0)
    with pytest.raises(ValueError, match="batch size"):
        tm([ta, tsparse.COOBatch(tb.row, tb.col, tb.values, (N + 1, V))])


def test_sparse_join_table_bags():
    (ja, ta), (jb, tb) = _bags(8), _bags(9)
    jm, tm = jsparse.SparseJoinTable([V, 7]), tsparse.SparseJoinTable([V, 7])
    (jids, jw), _ = jm.apply({}, {}, [ja, jb])
    tids, tw = tm([ta, tb])
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tw.numpy(), np.asarray(jw))


def test_dense_to_sparse_ties_follow_top_k():
    x = np.array([[0.0, 2.0, -2.0, 1.0, 2.0, 0.0, -2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 3.0]], np.float32)
    (jids, jw), _ = jsparse.DenseToSparse(3).apply({}, {}, jnp.asarray(x))
    tids, tw = tsparse.DenseToSparse(3)(torch.from_numpy(x))
    assert tids.dtype == torch.int32
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert tids[0].tolist() == [1, 2, 4]  # ties to the lower index


def test_dense_to_bags_and_to_dense():
    x = np.random.default_rng(2).normal(0, 1, (5, 9)).astype(np.float32)
    x[x < 0.5] = 0.0
    for bag in (None, 2):
        for a, b in zip(tsparse.dense_to_bags(x, bag),
                        jsparse.dense_to_bags(x, bag)):
            assert np.array_equal(a, b)
    jc, tc = _coos(11)
    assert np.array_equal(tc.to_dense().numpy(), np.asarray(jc.to_dense()))
    assert tc.to("cpu").dense_shape == (N, V)


def test_coo_row_reduce_is_the_reference_segment_sum():
    jc, tc = _coos(12)
    w = np.random.default_rng(4).normal(0, 1, tc.row.numel()).astype(
        np.float32)
    want = jsparse.coo_row_reduce(jc, jnp.asarray(w))
    got = tsparse.coo_row_reduce(tc, torch.from_numpy(w))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- batching
def _sparse_samples(mod, n=7, width=30, seed=0, dense=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 5))
        idx = rng.choice(width, k, replace=False).astype(np.int32)
        d = [rng.integers(0, 9, 3).astype(np.int32),
             rng.normal(0, 1, 2).astype(np.float32)] if dense else None
        out.append(mod.SparseSample(idx, rng.normal(0, 1, k), width,
                                    dense=d, label=np.float32(i % 2)))
    return out


@pytest.mark.parametrize("buckets", [None, [16, 64]], ids=["pow2", "buckets"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "coo_only"])
def test_batch_sparse_samples_bitwise(buckets, dense):
    jb = jdataset.batch_sparse_samples(
        _sparse_samples(jdataset, dense=dense), buckets)
    tb = tdataset.batch_sparse_samples(
        _sparse_samples(tdataset, dense=dense), buckets)
    assert isinstance(tb, tdataset.SparseMiniBatch)
    assert tb.size() == jb.size() == 7
    jin = jb.input if dense else (jb.input,)
    tin = tb.input if dense else (tb.input,)
    assert len(jin) == len(tin)
    jc, tc = jin[0], tin[0]
    assert tc.dense_shape == jc.dense_shape == (7, 30)
    for a, b in ((tc.row, jc.row), (tc.col, jc.col),
                 (tc.values, jc.values)):
        assert a.dtype in (torch.int32, torch.float32)
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the padding tail: (row 0, col 0, 0.0) up to the bucket
    total = sum(s.nnz for s in _sparse_samples(tdataset, dense=dense))
    cap = tc.row.numel()
    want_cap = min(b for b in buckets if b >= total) if buckets \
        else 1 << (total - 1).bit_length()
    assert cap == want_cap > total
    for a in (tc.row, tc.col, tc.values):
        assert not a[total:].any()
    for a, b in zip(tin[1:], jin[1:]):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    assert np.array_equal(tb.target, jb.target)
    with pytest.raises(TypeError):
        tb.slice(0, 2)


def test_batch_sparse_samples_bucket_overflow_raises():
    with pytest.raises(ValueError, match="largest bucket"):
        tdataset.batch_sparse_samples(_sparse_samples(tdataset), [4])


# ------------------------------------------------------ feature columns
CITIES = ["paris", "rome,paris", "", "oslo", "lima,rome,oslo", "rome"]
GENRES = ["a", "b,c", "c", "", "a,b", "zz"]
KV = ["0:1.5,3:2", "", "1:-1,1:2.5", "4:0.25", "2:1,0:1", "3:3"]


def _same_coo(t, j):
    assert t.dense_shape == j.dense_shape
    for a, b in ((t.row, j.row), (t.col, j.col), (t.values, j.values)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("col", [
    lambda m: m.CategoricalColHashBucket(97),
    lambda m: m.CategoricalColVocaList(["paris", "rome"]),
    lambda m: m.CategoricalColVocaList(["paris", "rome"],
                                       is_set_default=True),
    lambda m: m.CategoricalColVocaList(["paris", "rome"], num_oov_buckets=3),
], ids=["hash", "voca", "voca_default", "voca_oov"])
def test_categorical_columns_bitwise(col):
    _same_coo(col(tdm)(CITIES), col(jdm)(CITIES))
    _same_coo(col(tdm)(["", ""]), col(jdm)(["", ""]))  # placeholder entry


def test_cross_col_bitwise():
    _same_coo(tdm.CrossCol(1000)([CITIES, GENRES]),
              jdm.CrossCol(1000)([CITIES, GENRES]))


@pytest.mark.parametrize("trans_type", [0, 1])
def test_kv2tensor_bitwise(trans_type):
    t = tdm.Kv2Tensor(trans_type=trans_type)(KV, 5)
    j = jdm.Kv2Tensor(trans_type=trans_type)(KV, 5)
    if trans_type == 0:
        assert np.array_equal(t, j)
    else:
        _same_coo(t, j)


@pytest.mark.parametrize("is_count", [True, False])
def test_indicator_and_bucketized_bitwise(is_count):
    t = tdm.IndicatorCol(1000, is_count)(tdm.CrossCol(1000)([CITIES,
                                                             CITIES]))
    j = jdm.IndicatorCol(1000, is_count)(jdm.CrossCol(1000)([CITIES,
                                                             CITIES]))
    assert np.array_equal(t, j)
    x = [-3.0, 0.0, 0.5, 2.0, 10.0]
    assert np.array_equal(tdm.BucketizedCol([0.0, 1.0, 5.0])(x),
                          jdm.BucketizedCol([0.0, 1.0, 5.0])(x))


def test_row_transformer_bitwise():
    names = ["age", "city", "income"]
    rows = [(31, "rome", 2.5), (45, "oslo", 1.0)]

    def build(m):
        return m.RowTransformer(
            [m.ColToTensor("a", "age"),
             m.ColsToNumeric("num", ["age", "income"]),
             m.ColToSchema("c", ["city"], lambda v: len(v[0]))],
            field_names=names)

    for t, j in zip(build(tdm)(iter(rows)), build(jdm)(iter(rows))):
        assert t.keys() == j.keys()
        for k in t:
            assert np.array_equal(t[k], j[k]) and t[k].dtype == j[k].dtype
    t = list(tdm.RowTransformer.atomic(names)(iter(rows)))
    j = list(jdm.RowTransformer.atomic(names)(iter(rows)))
    assert [sorted(r) for r in t] == [sorted(r) for r in j]
    with pytest.raises(ValueError, match="replicated"):
        tdm.RowTransformer([tdm.ColToTensor("a", 0), tdm.ColToTensor("a", 1)])


def test_movielens_helpers(tmp_path):
    assert np.array_equal(tml.synthetic_ratings(30, 20, 200, seed=3),
                          jml.synthetic_ratings(30, 20, 200, seed=3))
    (tmp_path / "ratings.dat").write_text(
        "1::10::5::978300760\n2::3::3.0::978302109\nbad line\n")
    assert np.array_equal(tml.load(str(tmp_path)), jml.load(str(tmp_path)))
    r = tml.synthetic_ratings(10, 8, 40)
    t, j = tml.to_implicit_samples(r), jml.to_implicit_samples(r)
    assert isinstance(t[0], tdataset.Sample)
    assert all(np.array_equal(a.feature, b.feature) and a.label == b.label
               for a, b in zip(t, j))

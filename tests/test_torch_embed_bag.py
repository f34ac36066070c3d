"""The port's COO embedding-bag (kernel B3's plain version,
``ops/embed_bag.py``) on the CPU against the reference's Pallas kernel
``pallas_embed.embedding_bag_coo`` run in interpret mode, and against the
XLA chain it replaces (``take`` -> multiply -> ``segment_sum``).

Cases: the reference test's five (``tests/test_pallas_kernels.py``:
aligned, wide_d1, odd_d, single_row, bf16) and its unsorted-rows case with
duplicates, empty rows and the ``(0, 0, 0.0)`` padding tail.  Beside them,
without JAX: the sizes of the card's grouping passes (``group_plan``) and
the plain grouping (``row_index``) with keys outside ``[0, n_keys)``.

Tolerances:
- forward against the Pallas kernel: BITWISE.  Both add each row's
  entries in nnz order with one single-rounding FMA each (XLA on the CPU
  contracts the kernel's ``acc + v * t``), from 0, in f32, then cast.
- forward against the XLA chain, which rounds the product and the sum
  apart: ``rtol = atol = 1e-5`` in f32 (one ulp of each product); with a
  bf16 table and bf16 values the chain multiplies and sums in bf16 while
  both kernels sum in f32, so 5e-2, the reference test's own bf16 bound.
- gradients against ``jax.grad`` of the Pallas path, whose backward is
  XLA's scatter-add (product and sum rounded apart, its own order):
  ``d_table`` and ``d_values`` within ``1e-5`` of the largest value
  (f32), one bf16 ulp of it for bf16 cotangents.
"""

import functools

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import embed_bag

try:  # JAX, the reference's framework; absent on the card
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = jnp = pallas_embed = None
else:  # a broken reference fails here, at collection
    from bigdl_tpu.ops import pallas_embed
needs_jax = pytest.mark.skipif(jax is None,
                               reason="compares with the JAX reference")

CASES = {
    # name: (N, V, D, nnz, dtype)
    "aligned": (4, 64, 128, 9, "float32"),
    "wide_d1": (8, 100, 1, 40, "float32"),
    "odd_d": (5, 30, 10, 17, "float32"),
    "single_row": (1, 20, 8, 5, "float32"),
    "bf16": (6, 50, 16, 32, "bfloat16"),
}
TT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# unsorted rows, a duplicate (row, col) pair, empty rows 2 and 4, and
# the padding tail of batch_sparse_samples
UNSORTED = (np.array([3, 0, 3, 1, 0, 0, 0], np.int32),
            np.array([2, 5, 2, 1, 0, 0, 0], np.int32),
            np.array([1.0, 2.0, 0.5, -1.0, 3.0, 0.0, 0.0], np.float32), 5)


def _inputs(name):
    N, V, D, nnz, dtype = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 17)
    rows = rng.integers(0, N, nnz).astype(np.int32)
    cols = rng.integers(0, V, nnz).astype(np.int32)
    vals = rng.normal(0, 1, nnz).astype(np.float32)
    table = rng.normal(0, 1, (V, D)).astype(np.float32)
    return rows, cols, vals, table, N, dtype


def _to_torch(rows, cols, vals, table, dtype, vals_dtype="float32"):
    t = torch.from_numpy(table).to(TT[dtype])
    return (torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(vals).to(TT[vals_dtype]), t)


def _to_jax(rows, cols, vals, table, dtype, vals_dtype="float32"):
    return (jnp.asarray(rows), jnp.asarray(cols),
            jnp.asarray(vals).astype(getattr(jnp, vals_dtype)),
            jnp.asarray(table).astype(getattr(jnp, dtype)))


def _pallas(r, c, v, t, n):
    return pallas_embed.embedding_bag_coo(r, c, v, t, n, interpret=True)


def _xla_chain(r, c, v, t, n):
    g = jnp.take(t, c, axis=0) * v[:, None]
    return jax.ops.segment_sum(g, r, num_segments=n)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.float().numpy()


# every case with f32 values; bf16 values on the bf16 table (bf16 out) and
# on an f32 table (f32 out)
FORWARD = [(n, "float32") for n in sorted(CASES)] + [
    ("bf16", "bfloat16"), ("wide_d1", "bfloat16")]


@needs_jax
@pytest.mark.parametrize("name,vals_dtype", FORWARD)
def test_forward_matches_pallas_bitwise_and_xla(name, vals_dtype):
    rows, cols, vals, table, N, dtype = _inputs(name)
    got = embed_bag.embedding_bag_coo(*_to_torch(rows, cols, vals, table,
                                                 dtype, vals_dtype), N)
    jin = _to_jax(rows, cols, vals, table, dtype, vals_dtype)
    want = _pallas(*jin, N)
    chain = _xla_chain(*jin, N)
    assert str(got.dtype).split(".")[1] == str(want.dtype) == \
        str(chain.dtype)
    assert np.array_equal(_f32(got), _f32(want))
    tol = 5e-2 if str(chain.dtype) == "bfloat16" else 1e-5
    np.testing.assert_allclose(_f32(got), _f32(chain), rtol=tol, atol=tol)
    assert embed_bag.launches == 0


@needs_jax
def test_unsorted_rows_duplicates_and_padding():
    rows, cols, vals, n = UNSORTED
    table = np.random.default_rng(0).normal(0, 1, (8, 4)).astype(np.float32)
    got = embed_bag.embedding_bag_coo(*_to_torch(rows, cols, vals, table,
                                                 "float32"), n)
    want = _pallas(*_to_jax(rows, cols, vals, table, "float32"), n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # rows 2 and 4 hold no entry: an exact 0
    assert not got[2].any() and not got[4].any()
    # row 3: the duplicate pair adds twice, in nnz order
    t2 = torch.from_numpy(table[2])
    assert torch.equal(got[3], (t2 * 1.0 + t2 * 0.5))


def _grads_port(rows, cols, vals, table, N, dtype):
    r, c, v, t = _to_torch(rows, cols, vals, table, dtype)
    v.requires_grad_(True)
    t.requires_grad_(True)
    out = embed_bag.embedding_bag_coo(r, c, v, t, N)
    (out.float() ** 2).sum().backward()
    return v.grad, t.grad


def _grads_ref(rows, cols, vals, table, N, dtype):
    r, c, v, t = _to_jax(rows, cols, vals, table, dtype)

    def loss(v, t):
        return (_pallas(r, c, v, t, N).astype(jnp.float32) ** 2).sum()

    return jax.grad(loss, argnums=(0, 1))(v, t)


@needs_jax
@pytest.mark.parametrize("name", sorted(CASES) + ["unsorted"])
def test_gradients_match_jax_grad(name):
    if name == "unsorted":
        rows, cols, vals, N = UNSORTED
        table = np.random.default_rng(0).normal(0, 1, (8, 4)).astype(
            np.float32)
        dtype = "float32"
    else:
        rows, cols, vals, table, N, dtype = _inputs(name)
    dv, dt = _grads_port(rows, cols, vals, table, N, dtype)
    jdv, jdt = _grads_ref(rows, cols, vals, table, N, dtype)
    assert dv.dtype == torch.float32 and dt.dtype == TT[dtype]
    for got, want in ((dv, jdv), (dt, jdt)):
        want = _f32(want)
        scale = np.abs(want).max()
        tol = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(_f32(got), want, rtol=tol,
                                   atol=tol * scale)
    # ids no entry names get an exact 0 in the table's gradient
    unused = np.setdiff1d(np.arange(table.shape[0]), cols)
    assert not dt[torch.from_numpy(unused)].any()


def test_table_gradient_is_the_swapped_bag():
    """d_table is B3 with rows and cols swapped, bitwise: the same plain
    version, called as the backward calls it."""
    rows, cols, vals, table, N, _ = _inputs("odd_d")
    r, c, v, t = _to_torch(rows, cols, vals, table, "float32")
    t.requires_grad_(True)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (N, table.shape[1])).astype(np.float32))
    embed_bag.embedding_bag_coo(r, c, v, t, N).backward(g)
    want = embed_bag.embedding_bag_coo_reference(c, r, v, g, table.shape[0])
    assert torch.equal(t.grad, want)


def test_row_index_is_stable_and_drops_outside_rows():
    rows = torch.tensor([2, 0, 2, 5, -1, 0, 2], dtype=torch.int32)
    perm, offsets = embed_bag.row_index(rows, 4)
    assert perm.tolist() == [4, 1, 5, 0, 2, 6, 3]
    # row 0: perm[1:3]; row 1: empty; row 2: perm[3:6]; row 3: empty; -1
    # and 5 lie outside every bound
    assert offsets.tolist() == [1, 3, 3, 6, 6]


def test_row_index_leaves_outside_keys_out_of_every_bound():
    """Keys below 0 sort before every row and keys at or above n_rows after,
    by key (a stable sort of the raw keys), int32's extremes included; no
    bound covers them."""
    rows = torch.tensor([3, -7, 9, 0, -1, 4, 3, -2 ** 31, 2 ** 31 - 1, 0],
                        dtype=torch.int32)
    perm, offsets = embed_bag.row_index(rows, 4)
    assert perm.tolist() == [7, 1, 4, 3, 9, 0, 6, 5, 2, 8]
    assert offsets.tolist() == [3, 5, 5, 5, 7]


def test_launch_needs_cuda():
    rows, cols, vals, table, N, dtype = _inputs("wide_d1")
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        embed_bag.launch(*_to_torch(rows, cols, vals, table, dtype), N)
    with pytest.raises(RuntimeError, match="run on CUDA"):
        embed_bag.group_index(torch.from_numpy(rows), N)


# the stream lengths and key counts of the sizing test: one, the census
# batch (8192) and wide table (100,000), the 64-bit case's table (2^24 + 1)
# and both sides of 2^31
EDGES = [1, 8192, 100_000, 2 ** 24 + 1, 2 ** 31 - 1, 2 ** 31]


@pytest.mark.parametrize("n_keys", EDGES, ids=lambda n: f"keys{n}")
@pytest.mark.parametrize("nnz", EDGES, ids=lambda n: f"nnz{n}")
def test_group_plan_sizes(nnz, n_keys):
    """The grouping passes' sizes from the shapes alone: the least shift
    that keeps the coarse digit of every domain key (0 .. n_keys + 1) under
    256 buckets; chunks of whole 1024-entry tiles, at most 128 of them,
    covering the stream with none empty; int32 perm and offsets below 2^31
    entries; the scratch as csrc/embed_bag.cu carves it."""
    plan = embed_bag.group_plan(nnz, n_keys)
    top = n_keys + 1  # the largest domain key: keys at or above n_keys
    assert plan.buckets == (top >> plan.shift) + 1 <= 256
    assert plan.shift == 0 or (top >> (plan.shift - 1)) + 1 > 256
    assert plan.buckets << plan.shift > top
    assert plan.chunk % 1024 == 0 and 1 <= plan.chunks <= 128
    assert plan.chunks * plan.chunk >= nnz > (plan.chunks - 1) * plan.chunk
    assert plan.chunk == 1024 or plan.chunks * plan.chunk < nnz + 128 * 1024
    wide = nnz >= 2 ** 31
    assert plan.index_dtype == (torch.int64 if wide else torch.int32)
    es = 8 if wide else 4

    def aligned(n):
        return (n + 255) // 256 * 256
    assert plan.scratch_bytes == (aligned(plan.chunks * plan.buckets * es)
                                  + aligned((plan.buckets + 1) * es)
                                  + aligned(nnz * 2 * es))


@pytest.mark.parametrize("nnz,n_keys,want", [
    (65_536, 8192, (6, 129, 1024, 64)),      # census forward
    (65_536, 100_000, (9, 196, 1024, 64)),   # census table gradient
    (4096, 2 ** 24 + 1, (17, 129, 1024, 4)),  # the 64-bit case's gradient
    (0, 1000, (2, 251, 1024, 1)),            # an empty stream: one chunk
    (3_000_000, 100_000, (9, 196, 23 * 1024, 128)),
])
def test_group_plan_at_known_shapes(nnz, n_keys, want):
    plan = embed_bag.group_plan(nnz, n_keys)
    assert (plan.shift, plan.buckets, plan.chunk, plan.chunks) == want


@pytest.mark.parametrize("nnz,n_keys", [(10, 0), (10, 2 ** 31 + 1),
                                        (-1, 10)])
def test_group_plan_refuses_what_the_passes_do_not_take(nnz, n_keys):
    with pytest.raises(ValueError, match="grouping takes"):
        embed_bag.group_plan(nnz, n_keys)


@functools.lru_cache(maxsize=None)
def _census_cut():
    """The census wide path's shape, cut: batch 64, 8 ids a sample from a
    1000 x 1 table, plus a padding tail."""
    rng = np.random.default_rng(8)
    rows = np.concatenate([np.repeat(np.arange(64, dtype=np.int32), 8),
                           np.zeros(16, np.int32)])
    cols = np.concatenate([rng.integers(0, 1000, 512).astype(np.int32),
                           np.zeros(16, np.int32)])
    vals = np.concatenate([np.ones(512, np.float32), np.zeros(16, np.float32)])
    table = rng.uniform(-0.03, 0.03, (1000, 1)).astype(np.float32)
    return rows, cols, vals, table


@needs_jax
def test_census_shape_cut_bitwise():
    rows, cols, vals, table = _census_cut()
    got = embed_bag.embedding_bag_coo(*_to_torch(rows, cols, vals, table,
                                                 "float32"), 64)
    want = _pallas(*_to_jax(rows, cols, vals, table, "float32"), 64)
    assert np.array_equal(got.numpy(), np.asarray(want))

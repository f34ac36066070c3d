"""The pure functions of the port's ``parallel/grad_sync.py`` and
``utils/precision.py``'s ``stochastic_round`` against the reference's, on
the CPU (the collectives run in ``tests/test_torch_distri.py``).

- Bucket plans: the same leaf order (the reference's sorted dict keys on a
  model with twelve children: ``"10"`` before ``"2"``, ``bias`` before
  ``weight``), buckets, padding and content sizes as the reference's plan
  of the same tree; flattening bitwise equal to the reference's and
  undone exactly; the size cap splits.
- ``stochastic_round`` bitwise equal to the reference's given the
  reference's own noise words (``jax.random.bits``), unbiased in
  expectation with the port's generator; the f16 wire saturates within
  the +-65504/n budget.
- ``reshard_state`` 2 -> 4 -> 2 round-trips and equals the reference's;
  ``init_state`` refuses an optimizer whose state is not elementwise.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu.parallel import grad_sync as jgs  # noqa: E402
from bigdl_tpu.utils.precision import stochastic_round as jstochastic_round  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.interop import jax_tree  # noqa: E402
from bigdl_tpu_torch.parallel import grad_sync as gs  # noqa: E402
from bigdl_tpu_torch.utils.precision import (stochastic_round,  # noqa: E402
                                             stochastic_round_bits)


def wide_model():
    """Twelve children, so the reference's key order ("10" < "2") differs
    from the module order."""
    m = nn.Sequential()
    for i in range(12):
        m.add(nn.Linear(5 + i, 6 + i))
    return m.initialize(0)


def port_tree(model):
    return jax_tree(model, {k: p.detach() for k, p in
                            model.named_parameters()}, "params")


def as_jax(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.mark.parametrize("n_shard,bucket_bytes", [(1, 4 << 20), (2, 256),
                                                  (4, 1000), (3, 1)])
def test_plan_equals_reference(n_shard, bucket_bytes):
    tree = port_tree(wide_model())
    plan = gs.build_plan(tree, n_shard, bucket_bytes)
    jtree = as_jax(tree)
    jplan = jgs.build_plan(jtree, n_shard, bucket_bytes)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert plan.paths == paths
    assert plan.paths[:4] == ["['0']['bias']", "['0']['weight']",
                              "['1']['bias']", "['1']['weight']"]
    assert plan.paths[4] == "['10']['bias']"
    assert plan.buckets == jplan.buckets
    assert plan.bucket_sizes == jplan.bucket_sizes
    assert all(s % n_shard == 0 for s in plan.bucket_sizes)
    assert gs.bucket_content_sizes(plan) == jgs.bucket_content_sizes(jplan)
    leaves = gs.tree_leaves(tree)
    flats = gs.flatten_to_buckets(plan, leaves)
    jflats = jgs.flatten_to_buckets(jplan, jtree)
    for a, b in zip(flats, jflats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = gs.unflatten_from_buckets(plan, flats)
    for a, b in zip(back, leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_size_cap_splits_buckets():
    tree = port_tree(wide_model())
    one = gs.build_plan(tree, 1, 1 << 30)
    assert one.num_buckets == 1
    many = gs.build_plan(tree, 1, 400)  # 100 f32 elements
    assert many.num_buckets > 6
    for idxs in many.buckets:  # only a leaf alone may exceed the cap
        size = sum(many.leaf_meta[i][1] for i in idxs)
        assert size <= 100 or len(idxs) == 1


def test_wire_dtype_resolution():
    assert gs.resolve_wire_dtype("bf16") is torch.bfloat16
    assert gs.resolve_wire_dtype("F16") is torch.float16
    assert gs.resolve_wire_dtype(None) is torch.float32
    assert gs.resolve_wire_dtype(torch.float32) is torch.float32
    assert gs.wire_dtype_name(torch.bfloat16) == "bfloat16"
    with pytest.raises(ValueError, match="unknown grad wire dtype"):
        gs.resolve_wire_dtype("fp8")


def test_stochastic_round_bitwise_against_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 4096).astype(np.float32)
    x[:8] = [0.0, -0.0, 3.4e38, -3.4e38, 1e-40, -1e-40, np.inf, -np.inf]
    x[8:2048] *= np.float32(10.0) ** rng.integers(-30, 30, 2040)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jstochastic_round(jnp.asarray(x), jnp.bfloat16, key)
        words = np.array(jax.random.bits(key, x.shape, jnp.uint32))
        got = stochastic_round_bits(torch.from_numpy(x), torch.bfloat16,
                                    torch.from_numpy(words.view(np.int32)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    # the noise as unsigned words too
    got_u = stochastic_round_bits(torch.from_numpy(x), torch.bfloat16,
                                  torch.from_numpy(words))
    np.testing.assert_array_equal(got_u.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_stochastic_round_unbiased_in_expectation():
    x = torch.full((512,), 1.0 + 2 ** -12)  # between two bf16 values
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(512, dtype=torch.float64)
    n = 64
    for _ in range(n):
        acc += stochastic_round(x, torch.bfloat16, gen).double()
    mean = acc.mean().item() / n
    assert abs(mean - x[0].item()) < 2e-4, mean
    assert mean != 1.0  # round to nearest would give 1.0 exactly


def test_bf16_wire_cast_unbiased_in_expectation():
    """The wire's own round, with its per-step noise seeds, averages to
    the value it rounds (round-to-nearest would give 1.0 every time)."""
    x = torch.full((512,), 1.0 + 2 ** -12)
    gen = torch.Generator()
    acc = torch.zeros(512, dtype=torch.float64)
    n = 64
    for step in range(n):
        gen.manual_seed(gs.wire_seed(step, 0, 0))
        acc += gs.wire_cast(x, torch.bfloat16, gen).double()
    mean = acc.mean().item() / n
    assert abs(mean - x[0].item()) < 2e-4, mean
    assert mean != 1.0


def test_stochastic_round_identity_paths():
    x = torch.ones(4)
    assert stochastic_round(x, torch.float32, None) is x
    assert stochastic_round(x, torch.float16, None).dtype == torch.float16
    assert gs.wire_cast(x, torch.float32, None) is x


def test_f16_wire_saturates_instead_of_inf():
    x = torch.tensor([1e6, -1e6, 1.0])
    w = gs.wire_cast(x, torch.float16, None)
    want = jgs.wire_cast(jnp.asarray(x.numpy()), jnp.float16,
                         jax.random.PRNGKey(0))
    assert w.dtype == torch.float16
    np.testing.assert_array_equal(w.numpy(), np.asarray(want))
    assert w[0].item() == torch.finfo(torch.float16).max
    assert w[2].item() == 1.0


def test_f16_wire_clamp_budgets_the_sum():
    n = 8
    w = gs.wire_cast(torch.full((4,), 6e4), torch.float16, None, n_sum=n)
    lim = torch.finfo(torch.float16).max / n
    assert w.float().max().item() <= lim
    total = torch.zeros((), dtype=torch.float16)
    for _ in range(n):  # a coherent worst case, summed in f16
        total = total + w[0]
    assert torch.isfinite(total)


def test_wire_noise_seeds_differ():
    seeds = {gs.wire_seed(s, t, r) for s in range(4) for t in range(60)
             for r in range(4)}
    assert len(seeds) == 4 * 60 * 4


def test_reshard_state_round_trips_and_equals_reference():
    tree = port_tree(wide_model())
    leaves = gs.tree_leaves(tree)
    method = optim.SGD(0.1, momentum=0.9)
    p2 = gs.build_plan(tree, 2, 600)
    p4 = gs.build_plan(tree, 4, 600)
    assert p2.bucket_sizes != p4.bucket_sizes
    state2 = gs.init_state(p2, leaves, method)
    state2["opt"]["velocity"] = [torch.arange(len(m), dtype=torch.float32)
                                 * (b + 1) for b, m in
                                 enumerate(state2["opt"]["velocity"])]
    content = gs.bucket_content_sizes(p2)
    for b, v in enumerate(state2["opt"]["velocity"]):
        v[content[b]:] = 0  # padding holds zeros
    host2 = {"master": [m.numpy() for m in state2["master"]],
             "opt": {"velocity": [v.numpy()
                                  for v in state2["opt"]["velocity"]]}}
    host4 = gs.reshard_state(p4, host2)
    want4 = jgs.reshard_state(jgs.build_plan(as_jax(tree), 4, 600), host2)
    for a, b in zip(gs.tree_leaves(host4), jax.tree_util.tree_leaves(want4)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [len(m) for m in host4["master"]] == p4.bucket_sizes
    back = gs.reshard_state(p2, host4)
    for a, b in zip(gs.tree_leaves(back), gs.tree_leaves(host2)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not just the world size"):
        gs.reshard_state(gs.build_plan(tree, 2, 1 << 20), host2)


class FlatHistory(optim.OptimMethod):
    """A method whose state is one flat history vector (as L-BFGS's)."""

    def init_state(self, params):
        return {"history": torch.zeros(7)}


def test_init_state_refuses_non_elementwise_state():
    tree = port_tree(wide_model())
    plan = gs.build_plan(tree, 2, 1 << 20)
    with pytest.raises(ValueError, match="elementwise"):
        gs.init_state(plan, gs.tree_leaves(tree), FlatHistory())
    st = gs.init_state(plan, gs.tree_leaves(tree), optim.Adam())
    assert set(st["opt"]) == {"m", "v"}
    assert [len(m) for m in st["opt"]["m"]] == plan.bucket_sizes


def test_owned_state_slices_partition_the_buckets():
    tree = port_tree(wide_model())
    plan = gs.build_plan(tree, 3, 500)
    full = gs.init_state(plan, gs.tree_leaves(tree), optim.SGD(momentum=0.5))
    parts = [gs.owned_state(plan, full, r) for r in range(3)]
    for b, m in enumerate(full["master"]):
        assert torch.equal(torch.cat([p["master"][b] for p in parts]), m)
        assert all(len(p["master"][b]) == plan.slice_size(b) for p in parts)

"""Sequence and pipeline parallelism of the port (``parallel/mesh.py``'s
``seq`` and ``pipe`` axes, ``parallel/ring_attention.py``,
``parallel/pipeline.py``) against the reference's runs on the conftest's
virtual CPU devices, the port's groups being ``["cpu"] * n``.

Limits:

- ring attention against the reference's ``ring_attention`` (a
  ``seq=n`` mesh of virtual devices) and against the port's full
  ``dot_product_attention``: ``RING_TOL`` of max|y|, forward and the
  gradients of ``sum(out**2)`` (sound readings ~1e-7: the blocks' sums
  and the online rescaling round in their own order); the planted fault,
  the source rank's offset dropped from the causal mask, reads ~1e-1;
- GPipe against the reference's ``GPipe`` on a ``pipe`` mesh (the cases of
  the reference's ``tests/test_pipeline.py``): outputs, gradients and
  BatchNorm statistics within ``PIPE_ATOL`` (the reference test's 1e-5);
- ``MicrobatchedSequential`` against the reference's and against the
  unpipelined model within ``PIPE_ATOL``.
"""

import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import parallel as jparallel  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.parallel import (GPipe, MicrobatchedSequential,  # noqa: E402
                                      create_mesh, mesh_shape,
                                      partition_sequential, ring_attention)

# the module (the package's ``ring_attention`` is the function)
ring_mod = sys.modules["bigdl_tpu_torch.parallel.ring_attention"]

RING_TOL = 1e-5
PIPE_ATOL = 1e-5


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return create_mesh(devices=["cpu"] * n, **axes)


# ------------------------------------------------------------------ mesh
def test_mesh_seq_and_pipe_layout_matches_reference():
    """One process's group of model x seq x pipe devices in the
    reference's C-order layout: each axis's devices are the reference
    mesh's ``devices[0, ...]`` line of that axis."""
    for axes in ({"seq": 4}, {"pipe": 2}, {"model": 2, "seq": 2},
                 {"seq": 2, "pipe": 2}, {"model": 2, "seq": 2, "pipe": 2}):
        n = int(np.prod(list(axes.values())))
        mesh = create_mesh(devices=[f"cpu:{i}" for i in range(n)], **axes)
        jmesh = jparallel.create_mesh(data=1, devices=jax.devices()[:n],
                                      **axes)
        assert mesh_shape(mesh) == jparallel.mesh_shape(jmesh)
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)[0]
        for k, axis in enumerate(("model", "seq", "pipe")):
            line = np.moveaxis(ids, k, 0).reshape(ids.shape[k], -1)[:, 0]
            assert [d.index for d in mesh.axis_devices(axis)] == list(line)
        assert mesh.home == torch.device("cpu", 0)
    with pytest.raises(ValueError, match="device group"):
        create_mesh(seq=2, pipe=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="not a device axis"):
        cpu_mesh(seq=2).axis_devices("data")


# --------------------------------------------------------- ring attention
def _qkv(B, H, T, D, seed=0):
    return [_x((B, H, T, D), seed + i) for i in range(3)]


def _ref_ring(q, k, v, n, causal):
    jmesh = jparallel.create_mesh(data=1, seq=n, devices=jax.devices()[:n])
    return np.asarray(jax.jit(lambda q, k, v: jparallel.ring_attention(
        q, k, v, jmesh, causal=causal))(q, k, v))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_attention_matches_reference_and_full_attention(n, causal):
    q, k, v = _qkv(2, 2, 32, 8)
    want = _ref_ring(q, k, v, n, causal)
    got = ring_attention(*map(torch.from_numpy, (q, k, v)), cpu_mesh(seq=n),
                         causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 32, 8)
    assert _rel(got, want) <= RING_TOL
    full = nn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal)
    assert _rel(got, full) <= RING_TOL


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_gradient_matches_reference(causal):
    q, k, v = _qkv(1, 2, 24, 8, seed=3)
    jmesh = jparallel.create_mesh(data=1, seq=4, devices=jax.devices()[:4])

    def jloss(q, k, v):
        return jnp.sum(jparallel.ring_attention(q, k, v, jmesh,
                                                causal=causal) ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (ring_attention(*ts, cpu_mesh(seq=4), causal=causal) ** 2).sum() \
        .backward()
    fs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (nn.dot_product_attention(*fs, causal=causal) ** 2).sum().backward()
    for t, f, w in zip(ts, fs, want):
        assert _rel(t.grad, w) <= RING_TOL
        assert _rel(t.grad, f.grad) <= RING_TOL


def test_ring_attention_bf16_and_planted_mask_fault(monkeypatch):
    """bf16 in, bf16 out (the products in bf16, the statistics in f32), as
    close to full bf16 attention as the full one is to f32; the causal
    mask without the source rank's offset must read far above
    ``RING_TOL``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 2, 32, 8, seed=5))
    mesh = cpu_mesh(seq=4)
    b = [t.bfloat16() for t in (q, k, v)]
    got = ring_attention(*b, mesh, causal=True)
    assert got.dtype == torch.bfloat16
    full32 = nn.dot_product_attention(q, k, v, causal=True)
    full16 = nn.dot_product_attention(*b, causal=True)
    assert _rel(got.float(), full32) <= 2 * max(_rel(full16.float(), full32),
                                                1e-2)
    sound = ring_mod._mask
    monkeypatch.setattr(ring_mod, "_mask", lambda r, src, tl, causal, d:
                        sound(r, r, tl, causal, d))
    bad = ring_attention(q, k, v, mesh, causal=True)
    assert _rel(bad, full32) > 100 * RING_TOL


def test_ring_attention_refuses_a_ragged_split():
    q = torch.zeros(1, 1, 10, 4)
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(q, q, q, cpu_mesh(seq=4))
    with pytest.raises(ValueError, match="device group"):
        ring_attention(q, q, q, create_mesh())


# ------------------------------------------------------------------ GPipe
def _gpipe_pair(stage_fn, pipe, data):
    """The port's GPipe on ``["cpu"] * pipe`` (seeded) and the reference's
    on a ``data x pipe`` mesh, with the port's stacked weights."""
    port = GPipe(stage_fn(nn), pipe, mesh=cpu_mesh(pipe=pipe)).initialize(0)
    jmesh = jparallel.create_mesh(data=data, pipe=pipe)
    ref = jparallel.GPipe(stage_fn(jnn), num_stages=pipe, mesh=jmesh)
    params, state = to_jax_params(port)
    return port, ref, params, state


def _mlp_stage(m):
    return m.Sequential(m.Linear(12, 12), m.Tanh())


def test_gpipe_matches_reference_and_apply_reference():
    port, ref, params, _ = _gpipe_pair(_mlp_stage, 4, 2)
    assert params["0"]["weight"].shape == (4, 12, 12)
    x = _x((8, 4, 12), 1)
    want, _ = ref.apply(jax.tree_util.tree_map(jnp.asarray, params), {}, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        oracle = port.apply_reference(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_ATOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=PIPE_ATOL)


def test_gpipe_gradient_matches_reference():
    port, ref, params, _ = _gpipe_pair(_mlp_stage, 2, 4)
    x = _x((4, 4, 12), 2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    g_ref = jax.grad(lambda p: jnp.mean(ref.apply(p, {}, x)[0] ** 2))(jp)
    for p in port.parameters():
        p.requires_grad_(True)
    (port(torch.from_numpy(x)) ** 2).mean().backward()
    from bigdl_tpu_torch.interop import jax_tree
    g_port = jax_tree(port, {k: p.grad.numpy()
                             for k, p in port.named_parameters()})
    flat_p = jax.tree_util.tree_leaves(g_port)
    flat_r = jax.tree_util.tree_leaves(g_ref)
    assert len(flat_p) == len(flat_r) == 2  # stacked weight, bias
    for a, b in zip(flat_p, flat_r):
        np.testing.assert_allclose(a, np.asarray(b), atol=PIPE_ATOL)


def test_gpipe_batchnorm_state_matches_reference():
    """Training mode: each stage's BatchNorm statistics advance once a
    microbatch, in order, as on the reference's valid ticks."""
    def stage(m):
        return m.Sequential(m.Linear(6, 6), m.BatchNormalization(6),
                            m.ReLU())
    port, ref, params, state = _gpipe_pair(stage, 2, 4)
    assert state["1"]["running_mean"].shape == (2, 6)
    x = _x((4, 8, 6), 1)
    want, want_state = ref.apply(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state)),
        x, training=True)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_ATOL)
    got_state = to_jax_params(port)[1]
    for a, b in zip(jax.tree_util.tree_leaves(got_state),
                    jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=PIPE_ATOL)


def test_gpipe_params_cross_packages_and_refuse_misuse():
    port, _, params, state = _gpipe_pair(_mlp_stage, 4, 2)
    other = GPipe(_mlp_stage(nn), 4).initialize(7)
    load_jax_params(other, params, state)
    for (k, a), (_, b) in zip(port.named_parameters(),
                              other.named_parameters()):
        assert torch.equal(a, b), k
    x = torch.from_numpy(_x((4, 2, 12), 3))
    with torch.no_grad():  # no mesh: the sequential oracle
        np.testing.assert_allclose(other(x).numpy(),
                                   port.apply_reference(x).numpy(),
                                   atol=PIPE_ATOL)
    with pytest.raises(ValueError, match="divide"):
        port(torch.from_numpy(_x((6, 2, 12), 5)))
    with pytest.raises(ValueError, match="one stage a device"):
        GPipe(_mlp_stage(nn), 3, mesh=cpu_mesh(pipe=2))
    with pytest.raises(ValueError, match="stack of 4"):
        load_jax_params(other, {"0": {"weight": params["0"]["weight"][:2],
                                      "bias": params["0"]["bias"][:2]}})


# ------------------------------------------------- MicrobatchedSequential
def test_partition_sequential_and_its_raises():
    m = nn.Sequential(*[nn.Linear(4, 4) for _ in range(7)])
    stages = partition_sequential(m, 3)
    assert [len(s) for s in stages] == [3, 2, 2]
    assert stages[1][0] is m[3]
    for bad in (0, 8):
        with pytest.raises(ValueError, match="cannot split"):
            partition_sequential(m, bad)


def _five(m):
    return m.Sequential(m.Linear(8, 16), m.ReLU(), m.Linear(16, 16),
                        m.Tanh(), m.Linear(16, 4))


def test_microbatched_sequential_matches_reference_and_unpipelined():
    flat = _five(nn).initialize(0)
    mb = MicrobatchedSequential(partition_sequential(flat, 3), 4)
    params, state = to_jax_params(mb)
    assert sorted(params) == ["0", "1", "2"]
    jstages = jparallel.partition_sequential(_five(jnn), 3)
    jmb = jparallel.MicrobatchedSequential(jstages, num_microbatches=4)
    x = _x((16, 8), 1)
    want, _ = jmb.apply(jax.tree_util.tree_map(jnp.asarray, params), state, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = mb(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=PIPE_ATOL)
    np.testing.assert_allclose(got.detach().numpy(),
                               flat(torch.from_numpy(x)).detach().numpy(),
                               atol=PIPE_ATOL)
    got.sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    with pytest.raises(ValueError, match="not divisible"):
        MicrobatchedSequential([nn.Identity()], 3)(torch.zeros(8, 2))


def test_microbatched_sequential_threads_batchnorm_state():
    def net(m):
        return m.Sequential(m.Linear(5, 6), m.BatchNormalization(6),
                            m.ReLU(), m.Linear(6, 3))
    mb = MicrobatchedSequential(partition_sequential(net(nn).initialize(2),
                                                     2), 4).train()
    params, state = to_jax_params(mb)
    jmb = jparallel.MicrobatchedSequential(
        jparallel.partition_sequential(net(jnn), 2), num_microbatches=4)
    x = _x((16, 5), 4)
    want, want_state = jmb.apply(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state)),
        x, training=True)
    with torch.no_grad():
        got = mb(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PIPE_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(mb)[1]),
                    jax.tree_util.tree_leaves(want_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=PIPE_ATOL)

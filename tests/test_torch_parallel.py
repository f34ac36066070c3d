"""Tensor parallelism of the port (``parallel/mesh.py``,
``parallel/tensor_parallel.py``, ``Linear(shard=)``,
``MultiHeadAttention(shard=True)``, ``transformer_lm(shard=True)``,
``DistriOptimizer(param_specs=)``) against the reference's sharded runs on
the conftest's virtual CPU devices, the port's model groups being
``["cpu"] * m``.

Limits (a row-parallel product adds its partial sums in another order
than one matmul, so nothing here is bitwise):

- the sharded forward of the reference's MLP and of
  ``transformer_lm(shard=True)`` at ``model`` 2 and 4 against the
  reference's sharded forward: ``FORWARD_LIMIT`` of max|y| (sound
  readings about 1e-7); a planted fault, the two halves of one split
  weight swapped, must read above ``FAULT_FLOOR``;
- ``DistriOptimizer(param_specs=)`` at ``data=2, model=2`` (two gloo
  processes, each driving ``["cpu", "cpu"]``: the suite's one spawned
  world) against the reference's ``data=2, model=2`` run on the same
  batches (Adam 5e-3, the reference test's MLP, 8 steps): losses within
  ``LOSS_RTOL``, final weights within ``W_ATOL`` (absolute); at world 1,
  ``data=1, model=2`` against the unsharded port run to the same limits,
  with the global-norm clip engaged, which a norm that counts the shards
  twice breaks.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import Sample as JSample  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.models.transformer import transformer_lm as jtransformer_lm  # noqa: E402
from bigdl_tpu.parallel import build_param_specs as jbuild_param_specs  # noqa: E402
from bigdl_tpu.parallel import create_mesh as jcreate_mesh  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint.snapshot import load_snapshot  # noqa: E402
from bigdl_tpu_torch.dataset import (DistributedDataSet,  # noqa: E402
                                     SampleToMiniBatch)
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models.transformer import transformer_lm  # noqa: E402
from bigdl_tpu_torch.optim import optimizer as optimizer_mod  # noqa: E402
from bigdl_tpu_torch.parallel import (REPLICATED, Shards, Spec,  # noqa: E402
                                      build_param_specs,
                                      column_parallel_linear_specs,
                                      create_mesh, mesh_shape,
                                      row_parallel_linear_specs,
                                      shard_module)
from bigdl_tpu_torch.parallel import tensor_parallel as tp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distri_worker as W  # noqa: E402

FORWARD_LIMIT, FAULT_FLOOR = 1e-5, 1e-2
LOSS_RTOL, W_ATOL = 1e-5, 1e-4


def cpu_mesh(m):
    return create_mesh(model=m, devices=["cpu"] * m)


def mlp(module, shard, din=16, hidden=32, dout=8):
    return (module.Sequential()
            .add(module.Linear(din, hidden,
                               shard="column" if shard else None))
            .add(module.ReLU())
            .add(module.Linear(hidden, dout, shard="row" if shard else None)))


def small_lm(module_fn, shard):
    return module_fn(vocab_size=64, embed_dim=32, num_heads=4, num_layers=2,
                     max_len=32, shard=shard)


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def ref_sharded_forward(jmodel, params, state, x, m):
    """The reference's forward with its params placed by its own specs
    over a ``model=m`` mesh of virtual devices (GSPMD's collectives)."""
    mesh = jcreate_mesh(model=m, devices=jax.devices()[:m])
    specs = jbuild_param_specs(jmodel, params)
    p_sh = jax.tree_util.tree_map(
        lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)),
        jtree(params), specs,
        is_leaf=lambda v: isinstance(v, (P, jnp.ndarray)))

    @jax.jit
    def fwd(p, x):
        return jmodel.apply(p, jtree(state), x)[0]
    return np.asarray(fwd(p_sh, jnp.asarray(x)))


def swap_halves(shards: Shards):
    """A planted fault: slices 0 and 1 of a split weight exchanged."""
    with torch.no_grad():
        a = shards[0].detach().clone()
        shards[0].copy_(shards[1])
        shards[1].copy_(a)


# ------------------------------------------------------------------ mesh
def test_mesh_model_axis_and_unported_axes():
    # with no process group (and no launcher's) the mesh is local
    local = not torch.distributed.is_initialized()
    for m in (2, 4):
        mesh = cpu_mesh(m)
        assert mesh_shape(mesh) == {"data": 1, "model": m, "seq": 1,
                                    "pipe": 1}
        assert mesh.devices == (torch.device("cpu"),) * m
        assert mesh.home == torch.device("cpu")
        assert (mesh.backend is None) == local and mesh.rank == 0
    with pytest.raises(ValueError, match="device group"):
        create_mesh(model=2, devices=["cpu"] * 3)
    for axis in ("seq", "pipe"):  # ported since: a device group each
        mesh = create_mesh(**{axis: 2}, devices=["cpu"] * 2)
        assert mesh_shape(mesh)[axis] == 2 and mesh.axis_devices("model") \
            == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_mesh(model=2)


# ----------------------------------------------------------------- specs
def test_param_specs_built():
    """The reference's ``test_param_specs_built``: the spec tree has the
    parameter tree's structure, the opt-ins are split, and it agrees with
    the reference's own tree leaf for leaf."""
    model = small_lm(transformer_lm, True).initialize(0)
    specs = build_param_specs(model)
    params, _ = to_jax_params(model)

    def skeleton(t):
        return {k: skeleton(v) if isinstance(v, dict) else None
                for k, v in t.items()}
    assert skeleton(specs) == skeleton(params)
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda v: isinstance(v, Spec))
    # a block: wq, wk, wv, their biases and wo; the MLP's column weight
    # and bias and its row weight
    assert len([sp for sp in leaves if sp != REPLICATED]) == 2 * (7 + 3)
    jm = small_lm(jtransformer_lm, True)
    jspecs = jbuild_param_specs(jm, jm.init(jax.random.PRNGKey(0))[0])
    jleaves = jax.tree_util.tree_leaves(jspecs,
                                        is_leaf=lambda v: isinstance(v, P))
    assert [tuple(s) for s in leaves] == [tuple(s) for s in jleaves]


def test_specs_traverse_wrappers():
    """The reference's ``test_specs_traverse_wrappers``: an opt-in inside
    ``TimeDistributed`` keeps its split, a ``Recurrent`` cell is
    replicated; placed, the wrapped layer computes on its shards."""
    model = (nn.Sequential()
             .add(nn.TimeDistributed(nn.Linear(8, 16, shard="column")))
             .add(nn.Recurrent(nn.GRU(16, 8)))).initialize(0)
    specs = build_param_specs(model)
    assert specs["0"]["weight"] == Spec("model", None)
    assert specs["0"]["bias"] == Spec("model")
    assert all(sp == REPLICATED for sp in specs["1"].values())
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 5, 8)).astype(np.float32))
    placed = shard_module(copy.deepcopy(model), cpu_mesh(2))
    assert isinstance(placed[0].layer.weight, Shards)
    with torch.no_grad():
        assert rel(placed(x), model(x)) <= FORWARD_LIMIT


def test_linear_specs_and_unknown_mode():
    assert column_parallel_linear_specs() == {
        "weight": Spec("model", None), "bias": Spec("model")}
    assert row_parallel_linear_specs(False) == {"weight": Spec(None, "model")}
    assert nn.Linear(4, 2).param_specs() is None
    assert nn.Linear(4, 2, shard="row").param_specs() == \
        row_parallel_linear_specs()
    with pytest.raises(ValueError, match="unknown shard mode"):
        nn.Linear(4, 2, shard="diagonal").param_specs()
    assert repr(Spec("model", None)) == "Spec('model', None)"


def test_shard_module_placement_and_refusals():
    model = mlp(nn, True).initialize(0)
    placed = shard_module(copy.deepcopy(model), cpu_mesh(4))
    w0, w2 = placed[0].weight, placed[2].weight
    assert [tuple(p.shape) for p in w0.parts] == [(8, 16)] * 4
    assert [tuple(p.shape) for p in placed[0].bias.parts] == [(8,)] * 4
    assert [tuple(p.shape) for p in w2.parts] == [(8, 8)] * 4
    assert isinstance(placed[2].bias, torch.nn.Parameter)  # replicated
    assert w0.spec == Spec("model", None) and w2.spec == Spec(None, "model")
    # the logical tree is the unsharded one, both ways
    want = to_jax_params(model)[0]
    got = to_jax_params(placed)[0]
    for k in want:
        for n in want[k]:
            np.testing.assert_array_equal(got[k][n], want[k][n])
    other = shard_module(mlp(nn, True), cpu_mesh(4))
    load_jax_params(other, want)
    assert torch.equal(tp.logical_parameters(other)["0.weight"],
                       model[0].weight)
    # a model group of one device is the unsharded model
    one = shard_module(copy.deepcopy(model), cpu_mesh(1))
    assert isinstance(one[0].weight, torch.nn.Parameter)
    with pytest.raises(ValueError, match="does not split"):
        shard_module(mlp(nn, True, hidden=30), cpu_mesh(4))
    with pytest.raises(ValueError, match="declares"):
        shard_module(mlp(nn, False), cpu_mesh(2),
                     {"0": {"weight": Spec("model", None)}})
    with pytest.raises(ValueError, match="model device group"):
        shard_module(model, create_mesh(data=1))


# ------------------------------------------------------ sharded forward
@pytest.mark.parametrize("m", [2, 4])
def test_tp_mlp_forward_matches_reference(m):
    """The reference's ``test_tp_forward_matches_replicated`` across
    packages: the port's placed MLP against the reference's sharded
    forward; the swapped-halves fault must fail the same limit."""
    model = mlp(nn, True).initialize(0)
    params, state = to_jax_params(model)
    x = np.random.default_rng(1).normal(0, 1, (8, 16)).astype(np.float32)
    want = ref_sharded_forward(mlp(jnn, True), params, state, x, m)
    placed = shard_module(copy.deepcopy(model), cpu_mesh(m))
    with torch.no_grad():
        got = placed(torch.from_numpy(x)).numpy()
        assert rel(got, want) <= FORWARD_LIMIT
        swap_halves(placed[0].weight)
        assert rel(placed(torch.from_numpy(x)).numpy(), want) > FAULT_FLOOR


@pytest.mark.parametrize("m", [2, 4])
def test_tp_transformer_lm_forward_matches_reference(m):
    model = small_lm(transformer_lm, True).initialize(0).eval()
    params, state = to_jax_params(model)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 12))
    want = ref_sharded_forward(small_lm(jtransformer_lm, True), params,
                               state, tokens.astype(np.int32), m)
    placed = shard_module(copy.deepcopy(model), cpu_mesh(m))
    mha = placed[2][0][0][0][1]
    assert mha.heads_split and len(mha.wq) == m
    with torch.no_grad():
        got = placed(torch.from_numpy(tokens)).numpy()
        assert rel(got, want) <= FORWARD_LIMIT
        swap_halves(mha.wq)
        assert rel(placed(torch.from_numpy(tokens)).numpy(), want) \
            > FAULT_FLOOR


def test_tp_attention_heads_not_divisible_gathers():
    """A group of 8 over 4 heads: the projections split by columns, the
    heads gathered home; the forward is the unsharded one's."""
    model = small_lm(transformer_lm, True).initialize(0).eval()
    placed = shard_module(copy.deepcopy(model), cpu_mesh(8))
    mha = placed[2][0][0][0][1]
    assert not mha.heads_split and len(mha.wq) == 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64,
                                                               (2, 9)))
    with torch.no_grad():
        assert rel(placed(tokens), model(tokens)) <= FORWARD_LIMIT


def test_tp_backward_reaches_every_shard():
    """Autograd carries the backward through the copies: each shard's
    gradient is its slice of the unsharded gradient (within
    ``FORWARD_LIMIT`` of the model's largest gradient: the key biases'
    gradients are zero but for rounding)."""
    model = small_lm(transformer_lm, True).initialize(0)
    placed = shard_module(copy.deepcopy(model), cpu_mesh(2))
    for net in (model, placed):
        for p in net.parameters():
            p.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 64,
                                                               (2, 8)))
    model(tokens).sum().backward()
    placed(tokens).sum().backward()
    want = {k: p.grad for k, p in model.named_parameters()}
    got = tp.logical_tensors(placed, {k: p.grad for k, p in
                                      placed.named_parameters()})
    assert got.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    for k in want:
        assert float((got[k] - want[k]).abs().max()) \
            <= FORWARD_LIMIT * scale, k


# ------------------------------------------------- DistriOptimizer(TP)
N_ROWS, GLOBAL, ITERS = 256, 32, 8


def tp_samples():
    """The reference test's batches made once: x ~ N(0, 1) rows of 16,
    labels the argmax of a fixed random projection to 4."""
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (16, 4)).astype(np.float32)
    x = rng.normal(0, 1, (N_ROWS, 16)).astype(np.float32)
    return x, (x @ w).argmax(-1).astype(np.int32)


def tp_mlp(module, shard):
    return (module.Sequential()
            .add(module.Linear(16, 64, shard="column" if shard else None))
            .add(module.ReLU())
            .add(module.Linear(64, 4, shard="row" if shard else None))
            .add(module.LogSoftMax()))


class Recording:
    def __init__(self):
        self.losses = []

    def add_train_step(self, step, loss, lr, throughput):
        self.losses.append(loss)

    def add_scalar(self, *a):
        pass

    def trigger_for(self, name):
        return None


def ref_tp_run(start):
    """The reference's DistriOptimizer at data=2, model=2 with the
    model's own specs: (losses, final params flat)."""
    x, y = tp_samples()
    jm = tp_mlp(jnn, True)
    jm._params = jtree(start)
    jm._state = jtree(to_jax_params(tp_mlp(nn, True))[1])
    rec = Recording()
    mesh = jcreate_mesh(data=2, model=2, devices=jax.devices()[:4])
    ds = JDataSet.array([JSample(a, b) for a, b in zip(x, y)]) \
        >> JSampleToMiniBatch(GLOBAL)
    opt = (joptim.DistriOptimizer(jm, ds, jnn.ClassNLLCriterion(),
                                  mesh=mesh,
                                  param_specs=jbuild_param_specs(
                                      jm, jm._params))
           .set_optim_method(joptim.Adam(5e-3)).set_seed(5)
           .set_train_summary(rec)
           .set_end_when(joptim.max_iteration(ITERS)))
    opt.optimize()
    return rec.losses, W.flat_params(jm._params)


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    """The suite's one spawned world: two gloo processes, each driving a
    model group of ["cpu", "cpu"] (data=2, model=2)."""
    start = to_jax_params(tp_mlp(nn, True).initialize(0))[0]
    out = W.run_world(2, str(tmp_path_factory.mktemp("tp")), start,
                      {"tp": {}}, fn=W.train_tp)
    return start, out


def test_distri_optimizer_tp_matches_reference(tp_world):
    start, out = tp_world
    losses, params = ref_tp_run(start)
    r0, r1 = out[0]["tp"], out[1]["tp"]
    assert r0["world"] == 2 and r0["model"] == 2
    assert r0["losses"] == r1["losses"]  # the averaged loss, every rank
    np.testing.assert_allclose(r0["losses"], losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert r0["params"].keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
        np.testing.assert_allclose(r0["params"][k], params[k], rtol=0,
                                   atol=W_ATOL)


class Histograms:
    """A train summary that keeps the "Parameters" histograms' shapes."""

    def __init__(self):
        self.shapes = {}

    def add_train_step(self, *a):
        pass

    def add_scalar(self, *a):
        pass

    def add_histogram(self, tag, values, step):
        self.shapes[tag] = tuple(values.shape)

    def trigger_for(self, name):
        return optim.several_iteration(2) if name == "Parameters" else None


def local_tp_run(shard, clip=None, ckpt=None, resume=None, iters=ITERS,
                 summary=None):
    """One process: the port's DistriOptimizer over the rows of
    :func:`tp_samples`, unsharded (the ZeRO-1 path) or at ``data=1,
    model=2`` with ``param_specs``; Adam 5e-3, or with a norm ``clip``
    SGD at 0.5 (Adam's update hardly feels a scale on the gradient)."""
    x, y = tp_samples()
    model = tp_mlp(nn, shard).initialize(0)
    losses = []

    class Rec(optim.DistriOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    kw = {}
    if shard:
        kw = {"mesh": create_mesh(model=2, devices=["cpu"] * 2),
              "param_specs": build_param_specs(model)}
    ds = DistributedDataSet(W.rows_as_samples(x, y), process_index=0,
                            process_count=1) >> SampleToMiniBatch(GLOBAL)
    opt = (Rec(model, ds, nn.ClassNLLCriterion(), device="cpu", **kw)
           .set_optim_method(optim.Adam(5e-3) if clip is None
                             else optim.SGD(0.5)).set_seed(5)
           .set_end_when(optim.max_iteration(iters)))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, optim.several_iteration(4))
    if resume:
        assert opt.resume()
    if summary is not None:
        opt.set_train_summary(summary)
    opt.optimize()
    return losses, {k: v.detach().numpy().copy()
                    for k, v in model.named_parameters()}, opt


@pytest.fixture
def world1():
    yield
    Engine.reset()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_distri_optimizer_tp_world1_matches_unsharded(world1, monkeypatch):
    """data=1, model=2 against the unsharded port run, the global-norm
    clip engaged (0.05 is below every step's norm here); a norm that
    counts the shards twice must fail the same limits."""
    for clip in (None, 0.05):
        l_ref, p_ref, _ = local_tp_run(False, clip)
        l_tp, p_tp, opt = local_tp_run(True, clip)
        assert not opt._use_grad_sync
        np.testing.assert_allclose(l_tp, l_ref, rtol=LOSS_RTOL)
        for k in p_ref:
            np.testing.assert_allclose(p_tp[k], p_ref[k], rtol=0,
                                       atol=W_ATOL)
    real = optimizer_mod.global_norm

    def twice(grads):  # the planted fault: every shard counted twice
        return real({**grads, **{k + "#": g for k, g in grads.items()
                                 if k.rpartition(".")[2].isdigit()}})
    monkeypatch.setattr(optimizer_mod, "global_norm", twice)
    l_bad, p_bad, _ = local_tp_run(True, 0.05)
    worst = max(float(np.abs(p_bad[k] - p_ref[k]).max()) for k in p_ref)
    assert worst > 10 * W_ATOL


def test_distri_optimizer_tp_snapshot_is_unsharded(world1, tmp_path):
    """A tensor-parallel run's snapshot holds the unsharded tree (an
    unsharded model loads it, the optimizer state too), its "Parameters"
    histograms the unsharded tensors, and a sharded run resumed from the
    snapshot ends where the uninterrupted one ends."""
    hist = Histograms()
    whole, p_whole, _ = local_tp_run(True, summary=hist)
    assert hist.shapes == {"Parameters/0/bias": (64,),
                           "Parameters/0/weight": (64, 16),
                           "Parameters/2/bias": (4,),
                           "Parameters/2/weight": (4, 64)}
    ckpt = str(tmp_path / "ckpt")
    _, p_half, opt = local_tp_run(True, ckpt=ckpt, iters=4)
    mgr = opt._checkpoint_manager()
    mgr.wait()
    snap = load_snapshot(mgr.latest_valid())
    plain = load_jax_params(tp_mlp(nn, False), snap["params"])
    for k, v in plain.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), p_half[k])
    m = snap["opt_state"]["m"]
    assert tuple(np.shape(m["0"]["weight"])) == (64, 16)
    tail, p_tail, _ = local_tp_run(True, ckpt=ckpt, resume=True)
    np.testing.assert_allclose(tail, whole[4:], rtol=LOSS_RTOL)
    for k in p_whole:
        np.testing.assert_allclose(p_tail[k], p_whole[k], rtol=0,
                                   atol=W_ATOL)

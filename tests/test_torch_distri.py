"""The port's ``DistriOptimizer`` on the CPU over gloo, against itself and
against the reference's ``DistriOptimizer`` on the conftest's virtual CPU
devices.

Spawned worlds (``tests/torch_distri_worker.py``; one spawn a world size,
shared by the tests through module fixtures): the small MLP on synthetic
MNIST, global batch 64, buckets of 64 KiB (three buckets), SGD lr 0.05
momentum 0.9, 6 iterations, each rank reading the rows the reference's
mesh gives its device.

- Within the port, bitwise: the f32 wire against the all-reduce path
  (``parameter_sharding=False``) at 2 and 4 processes, K=1 against K=4,
  value clipping against the baseline's, every rank's master slices
  reassembled against the published weights; one rank's non-finite step
  skipped on every rank.
- Within stated limits: the bf16 wire tracks the f32 wire's losses
  (``rtol=0.05, atol=0.02``, the reference's own limit) and its f32
  masters stay within ``WIRE_DRIFT_LIMIT`` of the f32 wire's weights, which
  a wire that never updates them exceeds; its published weights are each
  one of the two bf16 values around their master, which a wire that
  publishes stale weights breaks; norm clipping
  matches the baseline within ``rtol=1e-5, atol=1e-7`` (the norm sums the
  slices in another order).
- Against the reference (world 2 and 4): losses within ``rtol=1e-5``,
  weights within ``rtol=1e-4, atol=1e-4*max|w|`` (f32 both sides, the
  products summed in another order: ``tests/test_torch_training.py``'s
  limits); a grad_sync snapshot resumes across packages both ways and the
  continuation matches the other package's uninterrupted run within the
  same limits.

In process, at world 1: bitwise equal to ``LocalOptimizer`` (SGD and
Adam), resumed bitwise from its own grad_sync snapshot, and refusing a
state from the other sync path.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset import image as jimage  # noqa: E402
from bigdl_tpu.dataset import mnist as jmnist  # noqa: E402
from bigdl_tpu.dataset.dataset import DistributedDataSet as JDistributedDataSet  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import SchemaMismatchError  # noqa: E402
from bigdl_tpu_torch.checkpoint.snapshot import load_snapshot  # noqa: E402
from bigdl_tpu_torch.dataset import (DataSet, DistributedDataSet,  # noqa: E402
                                     SampleToMiniBatch, image, mnist)
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.parallel import (create_mesh, data_sharding,  # noqa: E402
                                      init_process_group, mesh_shape,
                                      replicated)
from bigdl_tpu_torch.utils.config import configure, reset_config  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distri_worker as W  # noqa: E402

LOSS_RTOL, W_RTOL, W_ATOL_SHARE = 1e-5, 1e-4, 1e-4
# the bf16 wire's f32 masters against the f32 wire's weights, the worst
# leaf's ||w_bf16 - w_f32|| / ||w_f32 - w_0||: the sound wire reads about
# 0.013 here, a wire that never updates the weights 1.0
WIRE_DRIFT_LIMIT = 0.1


class Recording:
    def __init__(self):
        self.losses = []

    def add_train_step(self, step, loss, lr, throughput):
        self.losses.append(loss)

    def add_scalar(self, *a):
        pass

    def trigger_for(self, name):
        return None


def jax_pipeline():
    imgs, labels = jmnist.synthetic_mnist(W.N_SAMPLES, seed=0)
    return (JDataSet.array(jmnist.to_samples(imgs, labels))
            >> jimage.BytesToGreyImg()
            >> jimage.GreyImgNormalizer(jmnist.TRAIN_MEAN, jmnist.TRAIN_STD)
            >> JSampleToMiniBatch(W.GLOBAL_BATCH))


def jax_mlp():
    return (jnn.Sequential().add(jnn.Reshape((784,)))
            .add(jnn.Linear(784, 64)).add(jnn.ReLU())
            .add(jnn.Linear(64, 10)).add(jnn.LogSoftMax()))


def jax_run(start, devices, world, iters=W.ITERS, ckpt=None, resume=None):
    """The reference's DistriOptimizer on ``world`` virtual devices:
    (losses, final parameters as numpy, optimizer)."""
    jm = jax_mlp()
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    rec = Recording()
    opt = (joptim.DistriOptimizer(
        jm, jax_pipeline(), jnn.ClassNLLCriterion(),
        mesh=JMesh(np.array(devices[:world]), ("data",)),
        grad_wire_dtype="f32", grad_bucket_bytes=W.BUCKET_BYTES)
        .set_optim_method(joptim.SGD(learning_rate=0.05, momentum=0.9))
        .set_seed(5).set_train_summary(rec)
        .set_end_when(joptim.max_iteration(iters)))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, joptim.several_iteration(2))
    if resume is not None:
        assert opt.resume(resume)
    opt.optimize()
    return rec.losses, flat_tree(jm._params), opt


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_weights_close(port_params, want):
    assert port_params.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(port_params[k], w, rtol=W_RTOL,
                                   atol=W_ATOL_SHARE * np.abs(w).max(),
                                   err_msg=k)


def assert_bitwise(a, b):
    assert a["losses"] == b["losses"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                      err_msg=k)


@pytest.fixture(scope="module")
def start():
    return to_jax_params(W.small_mlp().initialize(0))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, start, devices):
    """The reference at world 2 (with snapshots), then one spawned port
    world of 2 running every configuration the tests read."""
    tmp = tmp_path_factory.mktemp("world2")
    jlosses, jparams, _ = jax_run(start, devices, 2, ckpt=str(tmp / "jax"))
    clip = {"lr": 0.5, "momentum": 0.0, "iters": 4}
    runs = {
        "gs": {"ckpt": str(tmp / "port")},
        "plain": {"parameter_sharding": False},
        "k4": {"k": 4},
        "bf16": {"grad_wire_dtype": "bf16"},
        "bf16_no_update": {"grad_wire_dtype": "bf16", "fault": "no_update"},
        "bf16_stale_gather": {"grad_wire_dtype": "bf16",
                              "fault": "stale_gather"},
        "value": {"clip": "value", **clip},
        "value_plain": {"clip": "value", "parameter_sharding": False,
                        **clip},
        "norm": {"clip": "norm", **clip},
        "norm_plain": {"clip": "norm", "parameter_sharding": False, **clip},
        "skip": {"guard": "skip", "poison_at": 2, "rank1_only_poison": True},
        "resumed": {"resume": str(tmp / "jax" / "model.4"),
                    "ckpt": str(tmp / "resumed")},
        "summary": {"summary": str(tmp / "summary")},
    }
    ranks = W.run_world(2, str(tmp), start[0], runs)
    return {"ranks": ranks, "jax": (jlosses, jparams), "dir": tmp}


@pytest.fixture(scope="module")
def world4(tmp_path_factory, start, devices):
    tmp = tmp_path_factory.mktemp("world4")
    jlosses, jparams, _ = jax_run(start, devices, 4)
    ranks = W.run_world(4, str(tmp), start[0], {
        "gs": {}, "plain": {"parameter_sharding": False}})
    return {"ranks": ranks, "jax": (jlosses, jparams)}


@pytest.fixture(params=[2, 4], ids=["world2", "world4"])
def world(request):
    return request.getfixturevalue(f"world{request.param}")


def test_f32_wire_equals_all_reduce_bitwise(world):
    for rank in world["ranks"]:
        assert len(rank["gs"]["losses"]) == W.ITERS
        assert_bitwise(rank["gs"], rank["plain"])


def test_ranks_hold_the_same_weights(world):
    r0 = world["ranks"][0]["gs"]
    for rank in world["ranks"][1:]:
        assert_bitwise(rank["gs"], r0)


def test_zero1_slices_reassemble(world):
    ranks = world["ranks"]
    gs = ranks[0]["gs"]
    for b, flat in enumerate(gs["flat_params"]):
        full = np.concatenate([r["gs"]["masters"][b] for r in ranks])
        np.testing.assert_array_equal(full, flat)
        assert len(full) % len(ranks) == 0


def test_matches_reference_distri_optimizer(world):
    jlosses, jparams = world["jax"]
    gs = world["ranks"][0]["gs"]
    np.testing.assert_allclose(gs["losses"], jlosses, rtol=LOSS_RTOL)
    assert_weights_close(gs["params"], jparams)
    assert gs["state"] == {"neval": W.ITERS, "epoch": 0,
                           "records_processed_this_epoch":
                               W.ITERS * W.GLOBAL_BATCH}


def test_plan_takes_reference_leaf_order(world2):
    plan = world2["ranks"][0]["gs"]["plan"]
    # bias before weight: the reference's sorted dict keys
    assert plan["paths"] == ["['1']['bias']", "['1']['weight']",
                             "['3']['bias']", "['3']['weight']"]
    assert plan["buckets"] == [[0], [1], [2, 3]]
    assert plan["sizes"] == [64, 784 * 64, 650]


def test_k1_and_k4_bitwise(world2):
    r0 = world2["ranks"][0]
    assert_bitwise(r0["k4"], r0["gs"])
    assert r0["k4"]["dispatches"] < r0["gs"]["dispatches"] == W.ITERS


def bf16_drift(run, f32_run):
    return W.wire_drift(run["master_params"], f32_run["params"],
                        f32_run["init"])


def test_bf16_wire_tracks_f32(world2):
    r0 = world2["ranks"][0]
    l32, l16 = np.array(r0["gs"]["losses"]), np.array(r0["bf16"]["losses"])
    assert l16.shape == l32.shape == (W.ITERS,)
    assert np.all(np.isfinite(l16))
    np.testing.assert_allclose(l16, l32, rtol=0.05, atol=0.02)
    assert l16.tolist() != l32.tolist()  # the wire did round
    assert set(r0["bf16"]["master_dtypes"]) == {"torch.float32"}
    # the f32 masters, leaf by leaf, against the f32 wire's weights
    assert bf16_drift(r0["bf16"], r0["gs"]) <= WIRE_DRIFT_LIMIT


def test_bf16_wire_publishes_its_masters_rounded(world2):
    for rank in world2["ranks"]:
        run = rank["bf16"]
        for pub, master in zip(run["flat_params"], run["full_masters"]):
            assert W.bf16_neighbours(pub, master)


@pytest.mark.parametrize("fault", ["no_update", "stale_gather"])
def test_bf16_wire_checks_fail_a_planted_fault(world2, fault):
    r0 = world2["ranks"][0]
    run = r0[f"bf16_{fault}"]
    if fault == "no_update":
        assert bf16_drift(run, r0["gs"]) > WIRE_DRIFT_LIMIT
    else:
        assert not all(W.bf16_neighbours(pub, master) for pub, master
                       in zip(run["flat_params"], run["full_masters"]))


@pytest.mark.parametrize("kind", ["value", "norm"])
def test_clipping_matches_all_reduce_baseline(world2, kind):
    r0 = world2["ranks"][0]
    got, want = r0[kind], r0[f"{kind}_plain"]
    if kind == "value":  # elementwise: the same bits
        assert_bitwise(got, want)
        return
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k in want["params"]:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_one_rank_nonfinite_step_is_skipped_everywhere(world2):
    ranks = world2["ranks"]
    for rank in ranks:
        skip = rank["skip"]
        assert skip["skipped"] == 1
        assert np.isnan(skip["losses"][2])
        assert np.all(np.isfinite(np.delete(skip["losses"], 2)))
        for v in skip["params"].values():
            assert np.all(np.isfinite(v))
    assert_bitwise_params(ranks[0]["skip"], ranks[1]["skip"])


def assert_bitwise_params(a, b):
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])


def test_port_resumes_reference_grad_sync_snapshot(world2):
    jlosses, jparams = world2["jax"]
    resumed = world2["ranks"][0]["resumed"]
    assert resumed["start_neval"] == 4
    np.testing.assert_allclose(resumed["losses"], jlosses[4:],
                               rtol=LOSS_RTOL)
    assert_weights_close(resumed["params"], jparams)


def test_reference_resumes_port_grad_sync_snapshot(world2, start, devices,
                                                   tmp_path):
    gs = world2["ranks"][0]["gs"]
    blob = load_snapshot(str(world2["dir"] / "port" / "model.4"))
    assert set(blob["opt_state"]) == {"master", "opt"}
    assert [m.shape for m in blob["opt_state"]["master"]] == \
        [(s,) for s in gs["plan"]["sizes"]]
    assert blob["manifest"]["schema"]["grad_sync"]["n_shard"] == 2
    jlosses, jparams, jopt = jax_run(
        start, devices, 2, ckpt=str(tmp_path),
        resume=str(world2["dir"] / "port" / "model.4"))
    assert jopt.state["neval"] == W.ITERS
    np.testing.assert_allclose(jlosses, gs["losses"][4:], rtol=LOSS_RTOL)
    assert_weights_close(gs["params"], jparams)


def test_rank0_alone_writes_the_summaries(world2):
    """Every rank hands the optimizer the same summaries; the files hold
    one version record each and every record once: the train scalars a
    step, the "Parameters" histograms and the validation score at
    iterations 3 and 6."""
    root = world2["dir"] / "summary" / "w"
    recs = {}
    for phase in ("train", "validation"):
        (f,) = os.listdir(root / phase)
        recs[phase] = W.summary_records(str(root / phase / f))
        assert recs[phase].count("version") == 1
        assert recs[phase][0] == "version"
    train = recs["train"][1:]
    steps = list(range(1, W.ITERS + 1))
    for tag in ("Loss", "LearningRate", "Throughput"):
        assert [s for t, s in train if t == tag] == steps, tag
    hist = [(t, s) for t, s in train if t.startswith("Parameters/")]
    paths = ["1/bias", "1/weight", "3/bias", "3/weight"]
    assert hist == [(f"Parameters/{p}", s) for s in (3, 6) for p in paths]
    assert recs["validation"][1:] == [("Top1Accuracy", 3),
                                      ("Top1Accuracy", 6)]


# ---------------------------------------------------------- world 1
@pytest.fixture(scope="module", autouse=True)
def _world1_group():
    """The world-1 group the in-process runs start stays for the module,
    then goes."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    Engine.set_mesh(None)


def lenet_pipeline(n=96, batch=16):
    imgs, labels = mnist.synthetic_mnist(n, seed=0)
    return (DataSet.array(mnist.to_samples(imgs, labels))
            >> image.BytesToGreyImg()
            >> image.GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
            >> SampleToMiniBatch(batch))


def port_run(cls, method, iters=8, ckpt=None, resume=False, **kw):
    model = lenet5(10).initialize(3)
    losses = []

    class Rec(cls):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    opt = (Rec(model, lenet_pipeline(), nn.ClassNLLCriterion(), device="cpu",
               **kw)
           .set_optim_method(method).set_steps_per_dispatch(4)
           .set_end_when(optim.max_iteration(iters)))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, optim.several_iteration(2))
    if resume:
        assert opt.resume(os.path.join(ckpt, "model.4"))
    opt.optimize()
    return losses, model, opt


@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_world1_equals_local_optimizer_bitwise(method):
    make = {"sgd": lambda: optim.SGD(0.05, momentum=0.9, weight_decay=1e-4),
            "adam": lambda: optim.Adam(0.01)}[method]
    l_loc, m_loc, _ = port_run(optim.LocalOptimizer, make())
    # 8 iterations cross the 6-batch epoch; buckets of 4 KiB: several
    l_dis, m_dis, opt = port_run(optim.DistriOptimizer, make(),
                                 grad_bucket_bytes=1 << 12)
    assert opt._use_grad_sync and opt._gs_plan.num_buckets > 2
    assert opt._world == 1 and opt.state["epoch"] == 1
    assert l_loc == l_dis
    for a, b in zip(m_loc.parameters(), m_dis.parameters()):
        assert torch.equal(a, b)


def test_grad_sync_snapshot_resumes_bitwise(tmp_path):
    sgd = lambda: optim.SGD(0.05, momentum=0.9)  # noqa: E731
    ref, m_ref, _ = port_run(optim.DistriOptimizer, sgd())
    first, _, _ = port_run(optim.DistriOptimizer, sgd(), iters=6,
                           ckpt=str(tmp_path))
    blob = load_snapshot(str(tmp_path / "model.4"))
    st = blob["opt_state"]
    assert set(st) == {"master", "opt"} and isinstance(st["master"], list)
    assert set(st["opt"]) == {"velocity"}
    assert len(st["opt"]["velocity"]) == len(st["master"])
    assert blob["manifest"]["schema"]["grad_sync"]["enabled"]
    second, m_res, _ = port_run(optim.DistriOptimizer, sgd(),
                                ckpt=str(tmp_path), resume=True)
    assert first[:4] + second == ref
    for a, b in zip(m_ref.parameters(), m_res.parameters()):
        assert torch.equal(a, b)


def test_snapshot_of_the_other_sync_path_is_refused(tmp_path):
    port_run(optim.DistriOptimizer, optim.SGD(0.05, momentum=0.9), iters=4,
             ckpt=str(tmp_path))
    # a real snapshot: its schema says grad_sync
    with pytest.raises(SchemaMismatchError, match="grad_sync"):
        port_run(optim.DistriOptimizer, optim.SGD(0.05, momentum=0.9),
                 ckpt=str(tmp_path), resume=True, parameter_sharding=False)
    # states alone, as a retry hands them over
    ds = lenet_pipeline()
    opt = (optim.DistriOptimizer(lenet5(10).initialize(3), ds,
                                 nn.ClassNLLCriterion(), device="cpu")
           .set_end_when(optim.max_iteration(1)))
    opt._resume_opt_state = {"velocity": {"0": np.zeros((4,), np.float32)}}
    with pytest.raises(ValueError, match="not grad_sync-format"):
        opt.optimize()
    opt = (optim.DistriOptimizer(lenet5(10).initialize(3), ds,
                                 nn.ClassNLLCriterion(), device="cpu",
                                 parameter_sharding=False)
           .set_end_when(optim.max_iteration(1)))
    opt._resume_opt_state = {"master": [np.zeros((4,), np.float32)],
                             "opt": {}}
    with pytest.raises(ValueError, match="grad_sync disabled"):
        opt.optimize()


def test_unported_distributed_features_raise():
    ds = lenet_pipeline()
    with pytest.raises(NotImplementedError, match="slice 10"):
        optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                              device="cpu", param_specs={})
    opt = optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="membership"):
        opt.set_elastic()
    for axis in ("model", "seq", "pipe"):
        with pytest.raises(NotImplementedError, match="slice 10"):
            create_mesh(**{axis: 2}, backend="gloo")


def test_grad_sync_keyword_must_agree_with_parameter_sharding():
    ds = lenet_pipeline()
    for sharding in (True, False):
        opt = optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                                    device="cpu", grad_sync=sharding,
                                    parameter_sharding=sharding)
        assert opt.parameter_sharding is sharding
        with pytest.raises(ValueError, match="disagrees"):
            optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                                  device="cpu", grad_sync=not sharding,
                                  parameter_sharding=sharding)


def test_backend_follows_the_device(monkeypatch):
    ds = lenet_pipeline()
    opt = optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion(),
                                device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="CPU run takes backend='gloo'"):
        opt.optimize()
    init_process_group("gloo")  # the module's world-1 group
    with pytest.raises(ValueError, match="runs 'gloo'"):
        init_process_group("nccl")  # never swapped quietly
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optim.DistriOptimizer(lenet5(10), ds, nn.ClassNLLCriterion())


def test_engine_topology_and_mesh():
    init_process_group("gloo")
    assert Engine.node_number() == Engine.device_count() == 1
    mesh = create_mesh(backend="gloo")
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1, "pipe": 1}
    assert mesh.rank == 0 and mesh.size == 1
    Engine.set_mesh(mesh)
    assert Engine.get_mesh() is mesh
    assert mesh_shape(mesh) == mesh.shape
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(data_sharding(mesh).local(t), t)  # one process
    assert replicated(mesh).local(t) is t
    with pytest.raises(ValueError, match="spans the world"):
        create_mesh(data=2, backend="gloo")


def test_config_fields_and_env_overlay(monkeypatch):
    from bigdl_tpu.utils.config import Config as JConfig
    from bigdl_tpu_torch.utils.config import Config
    assert Config().grad_bucket_bytes == JConfig().grad_bucket_bytes
    assert Config().grad_wire_dtype == JConfig().grad_wire_dtype == "f32"
    monkeypatch.setenv("BIGDL_TPU_GRAD_WIRE_DTYPE", "bf16")
    monkeypatch.setenv("BIGDL_TPU_GRAD_BUCKET_BYTES", "1024")
    reset_config()
    try:
        from bigdl_tpu_torch.utils.config import get_config
        cfg = get_config()
        assert (cfg.grad_wire_dtype, cfg.grad_bucket_bytes) == ("bf16", 1024)
        configure(grad_wire_dtype="f16")
        assert get_config().grad_wire_dtype == "f16"
    finally:
        reset_config()


@pytest.mark.parametrize("count", [1, 3])
def test_distributed_dataset_matches_reference(count):
    data = list(range(10))
    for p in range(count):
        ours = DistributedDataSet(data, seed=4, process_index=p,
                                  process_count=count)
        ref = JDistributedDataSet(data, seed=4, process_index=p,
                                  process_count=count)
        assert ours.size() == ref.size() == 10
        assert ours.local_size() == ref.local_size()
        for _ in range(3):
            it, jt = ours.data(train=True), ref.data(train=True)
            assert [next(it) for _ in range(7)] == \
                [next(jt) for _ in range(7)]
            assert list(ours.data(train=False)) == \
                list(ref.data(train=False))
            ours.shuffle()
            ref.shuffle()
        again = DistributedDataSet(data, seed=4, process_index=p,
                                   process_count=count)
        again.restore_position(ours.position_state())
        assert list(again.data(train=False)) == list(ours.data(train=False))


def _parameter_tags(run_dir):
    (f,) = [f for f in os.listdir(run_dir) if "tfevents" in f]
    return [t for t in W.summary_records(os.path.join(run_dir, f))
            if t != "version" and t[0].startswith("Parameters/")]


def test_parameter_histograms_match_reference(tmp_path):
    """The reference's own test (``tests/test_round3_closures.py``,
    ``TestParameterHistograms``) through the port's DistriOptimizer: the
    trigger-gated "Parameters" histograms, tagged with the reference's
    leaf paths at the reference's steps."""
    from bigdl_tpu.dataset.sample import Sample as JSample
    from bigdl_tpu.utils.summary import TrainSummary as JTrainSummary
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.utils.summary import TrainSummary

    def run(name, n, o, data, summary_cls, **kw):
        sample, dataset, to_batch = data
        rng = np.random.RandomState(0)
        samples = [sample(rng.rand(8).astype(np.float32),
                          np.int32(rng.randint(0, 2))) for _ in range(64)]
        model = n.Sequential(n.Linear(8, 2), n.LogSoftMax())
        if name == "port":
            model.initialize(0)
        summary = summary_cls(str(tmp_path / name), "run")
        summary.set_summary_trigger("Parameters", o.several_iteration(2))
        (o.DistriOptimizer(model, dataset.array(samples) >> to_batch(16),
                           n.ClassNLLCriterion(), **kw)
         .set_optim_method(o.SGD(learning_rate=0.1))
         .set_end_when(o.max_iteration(4))
         .set_train_summary(summary)
         .optimize())
        summary.close()
        return _parameter_tags(tmp_path / name / "run" / "train")

    port = run("port", nn, optim, (Sample, DataSet, SampleToMiniBatch),
               TrainSummary, device="cpu")
    ref = run("ref", jnn, joptim, (JSample, JDataSet, JSampleToMiniBatch),
              JTrainSummary)
    assert ref == [("Parameters/0/bias", 2), ("Parameters/0/weight", 2),
                   ("Parameters/0/bias", 4), ("Parameters/0/weight", 4)]
    assert port == ref

"""Elastic training in the port (``resilience/membership.py``,
``DistriOptimizer.set_elastic``) against the reference.

- ``ClusterMembership`` passes the reference's unit cases, over rosters
  of launch ranks.
- The reference's end-to-end gate (``tests/test_membership.py``) at the
  port: a spawned gloo world 4 under ``resize@at=2,to=2;resize@at=5,to=4``
  against an uninterrupted world-4 run.  The losses and the ``model.3``
  snapshot are bitwise equal up to the replay boundary, and the whole run
  (losses and final parameters) is within ``atol=1e-5``, as the
  reference's own gate; a second elastic run repeats the first bitwise;
  the port's elastic losses are within ``atol=1e-5`` of the reference's
  own elastic run of the same model, weights and data (f32 on both
  sides).  spmdcheck records every rank's schedule: the ranks that stay
  in the roster agree, and so do the two that sit out the world-2
  segment.
- ``device_loss`` resumes from ``latest_valid()`` and pays the steps
  since it; an operator's ``request_resize`` before ``optimize()`` is
  adopted at run start with no restore; elastic training without a
  checkpoint is refused loudly.
"""

import os
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distri_worker as W  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import Sample as JSample  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.utils import config as jconfig  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.checkpoint.snapshot import load_snapshot  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.resilience import (ClusterMembership,  # noqa: E402
                                        FaultInjector, parse_fault_plan)
from bigdl_tpu_torch.telemetry import MetricRegistry  # noqa: E402
from bigdl_tpu_torch.utils import config  # noqa: E402

PLAN = "resize@at=2,to=2;resize@at=5,to=4"
BOUNDARY = 3  # at=2 opens the epoch in the block of step 3: model.3
ATOL = 1e-5


# ------------------------------------------------------ the ledger itself
class TestClusterMembership:
    def test_initial_epoch_freezes_full_pool(self):
        m = ClusterMembership((0, 1, 2, 3))
        cur = m.current()
        assert (m.epoch(), cur.world, cur.reason) == (1, 4, "initial")
        assert cur.devices == (0, 1, 2, 3) and m.pool_size() == 4

    def test_resize_opens_monotonic_epochs_with_prefix_rosters(self):
        m = ClusterMembership((0, 1, 2, 3))
        e2 = m.request_resize(2)
        assert (e2.epoch, e2.world, e2.graceful) == (2, 2, True)
        assert e2.devices == (0, 1)
        e3 = m.request_resize(4)
        assert (e3.epoch, e3.world, e3.devices) == (3, 4, (0, 1, 2, 3))
        assert [e.epoch for e in m.history()] == [1, 2, 3]
        assert m.describe() == \
            "e1:w4(initial) -> e2:w2(resize) -> e3:w4(resize)"

    def test_same_size_resize_is_not_epoch_churn(self):
        m = ClusterMembership((0, 1))
        assert m.request_resize(2).epoch == 1 and m.epoch() == 1

    def test_resize_outside_pool_refused(self):
        m = ClusterMembership((0, 1))
        for bad in (3, 0):
            with pytest.raises(ValueError, match="outside"):
                m.request_resize(bad)

    def test_loss_signals_and_their_defaults(self):
        ep = ClusterMembership(tuple(range(8))).signal_host_loss()
        assert (ep.world, ep.reason, ep.graceful) == (4, "host_loss", True)
        ep = ClusterMembership(tuple(range(4))).signal_device_loss()
        assert (ep.world, ep.reason, ep.graceful) == \
            (3, "device_loss", False)

    def test_changed_since_is_the_replay_boundary_predicate(self):
        m = ClusterMembership((0, 1, 2, 3))
        assert m.changed_since(1) is None
        m.request_resize(2)
        assert m.changed_since(1).epoch == 2 and m.changed_since(2) is None

    def test_epoch_gauge_and_flight_events(self):
        from bigdl_tpu_torch.telemetry import FlightRecorder
        reg, rec = MetricRegistry(), FlightRecorder()
        m = ClusterMembership((0, 1, 2, 3), registry=reg, recorder=rec)
        m.request_resize(2)
        m.request_resize(4)
        assert reg.snapshot()["gauges"]["resilience/membership_epoch"] == 3
        assert [e["world"] for e in rec.events()] == [4, 2, 4]

    def test_signals_race_safely(self):
        m = ClusterMembership(tuple(range(8)))
        stop = threading.Event()

        def churn():
            while not stop.is_set():
                m.request_resize(2)
                m.request_resize(8)

        ts = [threading.Thread(target=churn) for _ in range(4)]
        for t in ts:
            t.start()
        for _ in range(200):
            m.epoch()
        stop.set()
        for t in ts:
            t.join()
        hist = m.history()
        assert [e.epoch for e in hist] == list(range(1, len(hist) + 1))
        assert all(h.world in (2, 8) for h in hist)

    def test_empty_pool_refused(self):
        with pytest.raises(ValueError, match=">= 1"):
            ClusterMembership(())

    def test_membership_clauses(self):
        (c,) = parse_fault_plan("resize@at=5,to=2")
        assert (c.kind, c.at, c.to, c.where, c.count) == \
            ("resize", 5, 2, "driver", 1)
        fi = FaultInjector("resize@at=3,to=2;host_loss@at=7", seed=1)
        assert fi.has_membership_kinds()
        assert fi.membership_events(2) == []
        assert [c.kind for c in fi.membership_events(3)] == ["resize"]
        assert fi.membership_events(3) == []  # one-shot
        assert [c.kind for c in fi.membership_events(7)] == ["host_loss"]
        assert not FaultInjector("corrupt_batch@at=1").has_membership_kinds()


# --------------------------------------------------------- end to end
def _start():
    model = (nn.Sequential().add(nn.Linear(16, 16)).add(nn.ReLU())
             .add(nn.Linear(16, 4)).add(nn.LogSoftMax())).initialize(11)
    return to_jax_params(model)


def _jax_elastic(start, ckpt):
    """The reference's own elastic run (``elastic_run``) from ``start``."""
    from jax.sharding import Mesh
    jconfig.configure(fault_plan=PLAN)
    try:
        model = jnn.Sequential(jnn.Linear(16, 16), jnn.ReLU(),
                               jnn.Linear(16, 4), jnn.LogSoftMax())
        model._params = jax.tree_util.tree_map(jnp.asarray, start[0])
        model._state = start[1]
        losses = []

        class Rec(joptim.DistriOptimizer):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])

        samples = [JSample(s.feature, s.label)
                   for s in W.grouped_samples()]
        opt = (Rec(model, JDataSet.array(samples) >> JSampleToMiniBatch(4),
                   jnn.ClassNLLCriterion(),
                   mesh=Mesh(np.array(jax.devices()[:4]), ("data",)),
                   grad_wire_dtype="f32")
               .set_optim_method(joptim.SGD(learning_rate=0.1)).set_seed(7)
               .set_end_when(joptim.max_iteration(8))
               .set_checkpoint(ckpt, joptim.several_iteration(1),
                               keep_last=100))
        opt.optimize()
        return np.asarray(losses)
    finally:
        jconfig.reset_config()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    start = _start()
    d = {n: str(tmp / n) for n in ("ref", "ela", "ela2", "loss")}
    ranks = W.run_world(4, str(tmp), start[0], {
        "ref": {"ckpt": d["ref"]},
        "ela": {"plan": PLAN, "ckpt": d["ela"], "spmd": True},
        "ela2": {"plan": PLAN, "ckpt": d["ela2"]},
        "loss": {"plan": "device_loss@at=4,to=2", "ckpt": d["loss"],
                 "ckpt_every": 4, "iters": 6, "sync_every_step": True},
        "refused": {"plan": "resize@at=2,to=2"},
        "adopt": {"ckpt": str(tmp / "adopt"), "iters": 6,
                  "resize_before": 2}},
        fn=W.train_elastic)
    return start, d, ranks, str(tmp)


def test_shrink_regrow_meets_the_references_gate(world4):
    start, d, ranks, _ = world4
    ref, ela = ranks[0]["ref"], ranks[0]["ela"]
    # every rank came back: the two that sat out took rank 0's model
    for r in ranks:
        assert r["ela"]["worlds"] == [4, 2, 4] and r["ela"]["epoch"] == 3
        assert r["ela"]["neval"] == 8
        for k, v in ela["params"].items():
            np.testing.assert_array_equal(r["ela"]["params"][k], v)
    assert ref["worlds"] is None  # the uninterrupted run stayed inert
    assert ela["gauges"]["resilience/membership_epoch"] == 3
    assert ela["counters"]["resilience/steps_lost_to_resize"] == 0
    assert ela["downtimes"] == 2
    assert [len(r["ela"]["losses"]) for r in ranks] == [8, 8, 5, 5]
    # bitwise to the replay boundary: losses and the snapshot resumed
    np.testing.assert_array_equal(ref["losses"][:BOUNDARY],
                                  ela["losses"][:BOUNDARY])
    a = load_snapshot(os.path.join(d["ref"], f"model.{BOUNDARY}"))
    b = load_snapshot(os.path.join(d["ela"], f"model.{BOUNDARY}"))
    for (path, x), y in zip(
            jax.tree_util.tree_flatten_with_path(a["params"])[0],
            jax.tree_util.tree_leaves(b["params"])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), path)
    # the elastic trajectory repeats itself bitwise
    np.testing.assert_array_equal(ela["losses"], ranks[0]["ela2"]["losses"])
    for k, v in ela["params"].items():
        np.testing.assert_array_equal(ranks[0]["ela2"]["params"][k], v)
    # the whole run: the reference's own tolerance
    np.testing.assert_allclose(ref["losses"], ela["losses"], rtol=0,
                               atol=ATOL)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(ela["params"][k], v, rtol=0, atol=ATOL)


def test_elastic_losses_match_the_references_elastic_run(world4,
                                                        tmp_path):
    start, _, ranks, _ = world4
    jl = _jax_elastic(start, str(tmp_path / "jck"))
    np.testing.assert_allclose(ranks[0]["ela"]["losses"], jl, rtol=0,
                               atol=ATOL)


def test_schedules_agree_within_each_roster(world4):
    _, _, ranks, _ = world4
    sched = [r["ela"]["schedule"] for r in ranks]
    assert sched[0] == sched[1] and sched[2] == sched[3]
    kinds = {k for k, _, _ in sched[0]}
    assert {"dispatch", "block_fetch", "checkpoint", "make_global"} <= kinds
    # a resize resumes from a snapshot: no adoption between runs
    assert "membership_adopt" not in kinds
    # the two that sat out skipped the world-2 segment's steps
    assert len(sched[2]) < len(sched[0])


def test_operator_resize_before_the_run_is_adopted(world4):
    # the reference's explicit set_elastic path: the epoch opened before
    # optimize() is adopted at run start, no snapshot restored; the run
    # trains at world 2 from its first step
    _, _, ranks, _ = world4
    ref = ranks[0]["ref"]
    for r in ranks:
        got = r["adopt"]
        assert got["worlds"] == [4, 2] and got["neval"] == 6
        assert "resilience/steps_lost_to_resize" not in got["counters"]
        for k, v in ranks[0]["adopt"]["params"].items():
            np.testing.assert_array_equal(got["params"][k], v)
    assert [len(r["adopt"]["losses"]) for r in ranks] == [6, 6, 0, 0]
    np.testing.assert_allclose(ranks[0]["adopt"]["losses"], ref["losses"][:6],
                               rtol=0, atol=ATOL)


def test_device_loss_resumes_from_latest_valid(world4):
    _, _, ranks, _ = world4
    got = ranks[0]["loss"]
    assert got["worlds"] == [4, 2] and got["epoch"] == 2
    assert got["graceful"] is False
    assert got["counters"]["resilience/steps_lost_to_resize"] == 1
    assert got["neval"] == 6 and all(r["loss"]["neval"] == 6 for r in ranks)
    assert np.isfinite(got["losses"]).all()


def test_elastic_without_checkpoint_refused_loudly(world4):
    _, _, ranks, _ = world4
    for r in ranks:
        assert "set_checkpoint" in r["refused"]["refused"]
    assert config.get_config().fault_plan == ""

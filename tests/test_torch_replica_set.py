"""``bigdl_tpu_torch.resilience.ReplicaSet``, its health ledgers and the
serving deadlines, against the reference.

The reference's own contract classes (``tests/test_resilience.py``:
``TestReplicaHealth``, ``TestDeadlines``, ``TestRetryAfterHint``,
``TestReplicaSet``, ``TestReplicaSetReviewRegressions``,
``TestReplicaElasticity``) run here against the port: their source is
read, the reference's names are pointed at the port's (replica sets and
services on CPU devices), and the few lines that reach into JAX state are
rewritten to the port's equivalent (listed in ``SUBS``).  The
``_Clock``-driven health transitions are deterministic.

Beside them: a serial request schedule under one seeded fault plan gives
the same ``resilience/*`` counters and the same flight-event kinds and
counts in both packages, ``tools.obs_report`` reads the port's flight
file and reports the victim as failed over, and every row the port
serves is within 1e-6 of the reference's forward (the same f32 MLP in
another order; sound readings ~1e-7).
"""

import functools
import json
import os
import subprocess
import sys
import threading  # noqa: F401  (the reference classes use it)
import time  # noqa: F401

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu_torch import nn, optim  # noqa: E402,F401
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.resilience import (CircuitBreaker,  # noqa: E402,F401
                                        FaultInjector, HealthPolicy,
                                        ReplicaHealth, parse_fault_plan)
from bigdl_tpu_torch.resilience import replica_set as _rs  # noqa: E402
from bigdl_tpu_torch.resilience.faults import (InjectedFault,  # noqa: E402,F401
                                               ReplicaDeathFault)
from bigdl_tpu_torch.resilience.health import (  # noqa: E402,F401
    ADMIT, DEGRADED, HEALTHY, PROBE, QUARANTINED, REFUSE)
from bigdl_tpu_torch.serving import (DeadlineExceeded,  # noqa: E402,F401
                                     ModelRegistry, ServiceClosed,
                                     ServiceOverloaded)
from bigdl_tpu_torch.serving import service as _service  # noqa: E402
from bigdl_tpu_torch.telemetry.registry import MetricRegistry  # noqa: E402,F401
from bigdl_tpu_torch.utils.config import configure, reset_config  # noqa: E402
from torch_reference_cases import reference_classes  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CPU = torch.device("cpu")

ReplicaSet = functools.partial(_rs.ReplicaSet, devices=[CPU])
InferenceService = functools.partial(_service.InferenceService, device="cpu")


def make_model(din=16, dout=4):
    return nn.Sequential(nn.Linear(din, 32), nn.ReLU(),
                         nn.Linear(32, dout), nn.SoftMax()).initialize(0)


SPEC16 = ((16,), np.float32)


def rows(rng, n, din=16):
    return rng.normal(0, 1, (n, din)).astype(np.float32)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _clean_config():
    reset_config()
    yield
    reset_config()


# --------------------------------------------- the reference's contracts
KEEP = ["TestReplicaHealth", "TestDeadlines", "TestRetryAfterHint",
        "TestReplicaSet", "TestReplicaSetReviewRegressions",
        "TestReplicaElasticity"]
# methods that drive the training driver, not serving
DROP = ["test_fault_plan_change_between_runs_is_honored"]
# (reference text, the port's) — each must apply
SUBS = [
    # a replica's direct forward: the port's model holds its weights
    ("        direct, _ = rs._replicas[1].model.apply(\n"
     "            rs._replicas[1].params, rs._replicas[1].state, x,\n"
     "            training=False)\n",
     "        direct = rs._replicas[1]._forward(x)\n"),
    # a retired replica releases its model (the reference: its params)
    ("        assert rs.replica(1).params is None\n",
     "        assert rs.replica(1).model is None\n"),
    ("        from bigdl_tpu.resilience.replica_set import _Route\n",
     "        from bigdl_tpu_torch.resilience.replica_set import _Route\n"),
    ("        from bigdl_tpu.optim.predictor import PredictionService\n"
     "        shim = PredictionService(make_model(), batch_size=4)\n",
     "        from bigdl_tpu_torch.optim.predictor import PredictionService\n"
     "        shim = PredictionService(make_model(), batch_size=4,\n"
     "                                 device=\"cpu\")\n"),
    ("        from bigdl_tpu.serving import ServiceClosed\n",
     "        from bigdl_tpu_torch.serving import ServiceClosed\n"),
]


exec(reference_classes("test_resilience.py", KEEP, DROP, SUBS))  # noqa: S102


# --------------------------------------------------------------- the port
def test_placement_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert _rs.default_devices() == [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _rs.ReplicaSet(make_model(), input_spec=SPEC16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _rs.ReplicaSet(make_model(), input_spec=SPEC16,
                       devices=[torch.device("cuda", 0)])


def test_more_replicas_than_devices_round_robin_and_own_copies():
    model = make_model()
    rs = ReplicaSet(model, n_replicas=3, input_spec=SPEC16,
                    max_batch_size=4, start=False)
    try:
        assert [r.device for r in rs._replicas] == [CPU] * 3
        models = [r.model for r in rs._replicas]
        assert len({id(m) for m in models}) == 3 and model not in models
    finally:
        rs.stop(drain=False)


def test_params_in_the_reference_layout_load_into_every_replica():
    model = make_model()
    params, state = to_jax_params(model)
    params["2"]["bias"] = params["2"]["bias"] + 1.0
    rs = ReplicaSet(model, params, state, n_replicas=2, input_spec=SPEC16,
                    max_batch_size=4)
    try:
        for r in rs._replicas:
            np.testing.assert_array_equal(r.model[2].bias.numpy(),
                                          params["2"]["bias"])
        assert not np.array_equal(model[2].bias.numpy(),
                                  params["2"]["bias"])
    finally:
        rs.stop()


def test_served_rows_match_the_reference_forward():
    from bigdl_tpu import nn as jnn
    model = make_model()
    params, state = to_jax_params(model)
    jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4),
                        jnn.SoftMax())
    x = rows(np.random.default_rng(3), 3)
    want, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                       jax.tree_util.tree_map(jnp.asarray, state),
                       jnp.asarray(x), training=False)
    rs = ReplicaSet(model, n_replicas=2, input_spec=SPEC16,
                    max_batch_size=4)
    try:
        got = rs.predict(x, timeout=30)
    finally:
        rs.stop()
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-6


PLAN = "replica_death@target=0,after=2,count=1;dispatch_error@target=1,at=5"


def _serial_story(pkg, flight_path):
    """Ten serial requests through a 2-replica set of ``pkg`` under
    ``PLAN``: the counters and the flight stream's event counts."""
    if pkg == "port":
        from bigdl_tpu_torch.telemetry.flight import FlightRecorder as FR
        cls, injector, model = ReplicaSet, FaultInjector, make_model()
        extra = {}
    else:
        from bigdl_tpu import nn as jnn
        from bigdl_tpu.resilience import FaultInjector as jFI
        from bigdl_tpu.resilience import ReplicaSet as jRS
        from bigdl_tpu.resilience import HealthPolicy as jHP
        from bigdl_tpu.telemetry.flight import FlightRecorder as FR
        cls, injector = jRS, jFI
        model = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(),
                               jnn.Linear(32, 4), jnn.SoftMax())
        params, state = to_jax_params(make_model())
        extra = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "state": jax.tree_util.tree_map(jnp.asarray, state),
                 "devices": jax.local_devices()[:1]}
    policy = (HealthPolicy if pkg == "port" else jHP)(probe_backoff_s=60.0)
    flight = FR(flight_path)
    rs = cls(model, n_replicas=2, input_spec=SPEC16, max_batch_size=4,
             fault_injector=injector(PLAN, seed=0), health=policy,
             flight=flight, request_tracing=True, name="story",
             deadline_ms=0, **extra)
    outs = []
    try:
        rng = np.random.default_rng(0)
        for _ in range(10):
            try:
                outs.append(np.asarray(rs.predict(rows(rng, 1),
                                                  timeout=30)))
            except Exception as e:  # either package's InjectedFault
                assert type(e).__name__ == "InjectedFault", e
                outs.append(None)
        counters = rs.stats()["resilience"]
        states = rs.health_states()
    finally:
        rs.stop()
    return counters, flight.counts(), states, outs


def test_serial_fault_story_matches_the_reference(tmp_path):
    port = _serial_story("port", str(tmp_path / "port.jsonl"))
    ref = _serial_story("ref", str(tmp_path / "ref.jsonl"))
    assert port[0] == ref[0]
    assert port[0]["resilience/replica_deaths"] == 1
    assert port[0]["resilience/failovers"] >= 1
    assert port[1] == ref[1]
    assert {"replica_death", "revival", "failover",
            "health_transition"} <= set(port[1])
    assert port[2] == ref[2]
    assert [o is None for o in port[3]] == [o is None for o in ref[3]]
    for a, b in zip(port[3], ref[3]):
        if a is not None:
            assert float(np.abs(a - b).max()) <= 1e-6
    # the post-mortem tool reads the port's stream as the reference's
    r = subprocess.run(
        [sys.executable, "-m", "tools.obs_report",
         str(tmp_path / "port.jsonl"), "--json"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    report = json.loads(r.stdout)
    assert report["n_failed_over"] >= 1
    victims = [q for q in report["requests"] if q["failed_over"]]
    assert victims and all("failover" in q["events"] for q in victims)


def test_deadline_config_field_and_engine_default():
    from bigdl_tpu.utils import config as jconfig
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.utils import config
    fields = ["serving_deadline_ms", "frontend_port", "frontend_auth_token",
              "frontend_core", "frontend_shards",
              "frontend_max_connections", "frontend_idle_timeout_s",
              "frontend_pin_cpus"]
    for f in fields:
        assert getattr(config.Config(), f) == getattr(jconfig.Config(), f), f
    os.environ["BIGDL_TPU_SERVING_DEADLINE_MS"] = "33"
    try:
        reset_config()
        assert Engine.serving_defaults()["deadline_ms"] == 33.0
    finally:
        del os.environ["BIGDL_TPU_SERVING_DEADLINE_MS"]
        reset_config()
    configure(frontend_core="threaded")
    assert config.get_config().source("frontend_core") == "explicit"


def test_registry_deploy_takes_params_in_the_reference_layout():
    """``deploy(params=, state=)`` serves those weights from a copy of the
    model, as the reference's ``deploy`` serves the params it is given;
    the caller's module keeps its own."""
    model = make_model()
    params, state = to_jax_params(model)
    params["2"]["bias"] = params["2"]["bias"] + np.arange(4, dtype=np.float32)
    x = rows(np.random.default_rng(4), 2)
    with torch.no_grad():
        before = model(torch.from_numpy(x)).numpy()
    reg = ModelRegistry(device="cpu")
    try:
        svc = reg.deploy("m", model, params=params, state=state,
                         input_spec=SPEC16, max_batch_size=4)
        got = reg.predict("m", x, timeout=30)
        np.testing.assert_array_equal(svc.model[2].bias.numpy(),
                                      params["2"]["bias"])
    finally:
        reg.stop_all()
    with torch.no_grad():
        assert np.array_equal(model(torch.from_numpy(x)).numpy(), before)
    assert not np.allclose(got, before)

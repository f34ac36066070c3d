"""The port's fault injection (``bigdl_tpu_torch/resilience/faults.py``)
and its driver and serving fault sites, against the reference.

- Parsing: a table of plans (every kind and key, and the reference's
  malformed ones) gives the same clauses and the same errors in both
  packages; probabilistic clauses fire at the same indices over 1,000
  events.
- Training: a small MLP through ``LocalOptimizer`` from the reference's
  weights, under ``corrupt_batch``, ``nonfinite_grads`` and driver
  ``dispatch_error``/``dispatch_delay`` clauses and each numeric-guard
  policy, skips the same steps with the same counters and flight events
  as the reference, and ends within 1e-5 of each array's largest value
  of the reference's parameters (f32, another summation order, 8 SGD
  steps); ``LocalOptimizer`` refuses membership kinds with the
  reference's message.
- Serving: an injected dispatch error fails that dispatch's request, a
  replica death kills the batcher until ``revive()``, the rest answer
  bitwise as a fault-free service; ``release()`` frees a stopped one.
- Inertness: no injector object, bitwise-equal losses without a plan.
"""

import os
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.resilience import faults as jfaults  # noqa: E402
from bigdl_tpu.resilience.numeric import \
    NonFiniteStepError as JNonFiniteStepError  # noqa: E402
from bigdl_tpu.telemetry import flight as jflight  # noqa: E402
from bigdl_tpu.utils import config as jconfig  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset.prefetch import DeviceBlockStager  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.resilience import (FaultInjector, InjectedFault,  # noqa: E402
                                        NonFiniteStepError,
                                        ReplicaDeathFault,
                                        parse_fault_plan)
from bigdl_tpu_torch.serving import InferenceService  # noqa: E402
from bigdl_tpu_torch.telemetry import Tracer, flight  # noqa: E402
from bigdl_tpu_torch.utils import config  # noqa: E402

PARAM_TOL = 1e-5  # of each array's largest value


@pytest.fixture(autouse=True)
def _clean():
    yield
    for mod in (flight, jflight):
        mod.reset()
    for cfg in (config, jconfig):
        cfg.reset_config()


# ---------------------------------------------------------------- grammar
PLANS = [
    "", "  ;  ; ",
    "dispatch_error@at=3,target=1;dispatch_delay@ms=5.0,every=2,"
    "where=driver;replica_death@after=10,count=1;corrupt_batch@at=7;"
    "nonfinite_grads@p=0.5,until=20",
    "resize@at=2,to=2;resize@at=5,to=4", "host_loss@at=1",
    "device_loss@at=4,to=1,count=2", "dispatch_delay@ms=0.5,p=1.0",
    "corrupt_batch@at=3,where=serving",
    # the reference's malformed plans and a few more
    "exploding_gradient_storm", "dispatch_error@frequency=3",
    "dispatch_error@at", "dispatch_error@p=1.5",
    "dispatch_error@where=everywhere", "dispatch_delay@every=0",
    "resize@at=2", "corrupt_batch@to=2", "dispatch_error@at=x",
]

_KEYS = ("kind", "at", "after", "until", "every", "count", "target", "p",
         "ms", "to", "where")


def _parsed(parse, plan):
    try:
        return [tuple(getattr(c, k) for k in _KEYS) + (c.describe(),)
                for c in parse(plan)]
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("plan", PLANS)
def test_plans_parse_as_the_reference(plan):
    assert _parsed(parse_fault_plan, plan) == \
        _parsed(jfaults.parse_fault_plan, plan)


def _fired(cls, plan, seed, site):
    inj = cls(plan, seed=seed)
    out = []
    for i in range(1000):
        if site == "batch":
            if inj.batch_kinds(i):
                out.append(i)
            continue
        try:
            (inj.driver_dispatch(i) if site == "driver"
             else inj.serving_dispatch(i, replica=i % 3))
        except (Exception, BaseException) as e:
            out.append((i, type(e).__name__))
    return out


@pytest.mark.parametrize("plan,site", [
    ("dispatch_error@p=0.3,where=driver", "driver"),
    ("dispatch_error@p=0.2,target=1;replica_death@p=0.05,after=100",
     "serving"),
    ("corrupt_batch@p=0.1;nonfinite_grads@p=0.25,every=3,count=40",
     "batch")])
@pytest.mark.parametrize("seed", [0, 7])
def test_probabilistic_clauses_fire_at_the_reference_indices(plan, site,
                                                             seed):
    mine = _fired(FaultInjector, plan, seed, site)
    assert mine == _fired(jfaults.FaultInjector, plan, seed, site)
    assert 10 < len(mine) < 900


def test_corrupt_staged_poisons_floating_leaves_only():
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    batches = iter([MiniBatch((np.ones((2, 3), np.float32),
                               np.arange(2, dtype=np.int64)),
                              np.zeros(2, np.int64)) for _ in range(3)])
    staged = DeviceBlockStager(batches, "cpu").take(3, 100)
    inj = FaultInjector("corrupt_batch@at=11;nonfinite_grads@at=12")
    xs = inj.corrupt_staged(staged.xs, 10, 3)
    x, ids = xs
    assert torch.isfinite(x[0]).all() and torch.isnan(x[1]).all()
    assert torch.isinf(x[2]).all()
    assert (ids == torch.arange(2)).all() and ids.dtype == torch.int64


# --------------------------------------------------------------- training
def _samples(S):
    rng = np.random.default_rng(0)
    return [S(rng.normal(0, 1, (16,)).astype(np.float32),
              np.int32(rng.integers(0, 4))) for _ in range(64)]


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _run(pkg, start, tmp, plan, guard, k=2, iters=8):
    """One run of the MLP in ``pkg`` ("port" or "ref") from the weights
    ``start``: (losses, optimizer, final parameters in the reference's
    layout), or the NonFiniteStepError it raised."""
    port = pkg == "port"
    cfg, fl = (config, flight) if port else (jconfig, jflight)
    cfg.configure(fault_plan=plan, failure_retry_times=2,
                  flight_recorder_path=os.path.join(tmp, pkg + ".jsonl"))
    fl.reset()
    if port:
        model = nn.Sequential(nn.Linear(16, 16), nn.ReLU(),
                              nn.Linear(16, 4), nn.LogSoftMax())
        from bigdl_tpu_torch.interop import load_jax_params
        load_jax_params(model, *start)
        opt = _recording(optim.LocalOptimizer)(
            model, DataSet.array(_samples(Sample)) >> SampleToMiniBatch(16),
            nn.ClassNLLCriterion(), device="cpu")
        o = optim
    else:
        model = jnn.Sequential(jnn.Linear(16, 16), jnn.ReLU(),
                               jnn.Linear(16, 4), jnn.LogSoftMax())
        model._params = jax.tree_util.tree_map(jnp.asarray, start[0])
        model._state = start[1]
        opt = _recording(joptim.LocalOptimizer)(
            model, JDataSet.array(_samples(JSample))
            >> JSampleToMiniBatch(16), jnn.ClassNLLCriterion())
        o = joptim
    opt = (opt.set_optim_method(o.SGD(learning_rate=0.1))
           .set_steps_per_dispatch(k).set_numeric_guard(guard)
           .set_end_when(o.max_iteration(iters)))
    if guard == "rollback":
        opt.set_checkpoint(os.path.join(tmp, pkg + "_ck"),
                           o.several_iteration(2))
    try:
        opt.optimize()
    except (NonFiniteStepError, JNonFiniteStepError) as e:
        return e, opt, None
    params = to_jax_params(model)[0] if port else model._params
    return np.asarray(opt.losses), opt, params


def _flight_events(tmp, pkg):
    """The driver's events in order, and apart from them the steps of the
    checkpoint commits, sorted: those fire on the snapshot writer's
    thread, so their place among the driver's events depends on how fast
    the disk answers."""
    events = [(e["event"], e.get("step"), e.get("policy"))
              for e in flight.load_dump(os.path.join(tmp, pkg + ".jsonl"))
              ["events"]]
    return ([e for e in events if e[0] != "checkpoint_commit"],
            sorted(e[1] for e in events if e[0] == "checkpoint_commit"))


@pytest.mark.parametrize("plan,guard", [
    ("corrupt_batch@at=5;nonfinite_grads@at=2", "skip"),
    ("nonfinite_grads@at=4,count=1", "rollback"),
    ("corrupt_batch@at=3", "abort"),
    ("dispatch_error@where=driver,at=1,count=2;"
     "dispatch_delay@where=driver,ms=1,every=2;corrupt_batch@at=6",
     "skip")])
def test_driver_faults_as_the_reference(tmp_path, plan, guard):
    model = nn.Sequential(nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
                          nn.LogSoftMax()).initialize(3)
    start = to_jax_params(model)
    tmp = str(tmp_path)
    mine, opt, params = _run("port", start, tmp, plan, guard)
    ref, jopt, jparams = _run("ref", start, tmp, plan, guard)
    if guard == "abort":
        assert (mine.step, mine.policy) == (ref.step, ref.policy) == (3,
                                                                       "abort")
    else:
        np.testing.assert_allclose(mine, ref, rtol=1e-5)
        bad = [j for j, v in enumerate(mine) if not np.isfinite(v)]
        assert bad == [j for j, v in enumerate(ref) if not np.isfinite(v)]
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(params)[0],
                jax.tree_util.tree_leaves(jparams)):
            a, b = np.asarray(a), np.asarray(b)
            assert np.abs(a - b).max() <= PARAM_TOL * np.abs(b).max(), path
    counters = lambda o: {k: v for k, v in  # noqa: E731
                          o.metrics.registry.snapshot()["counters"].items()
                          if k.startswith("resilience/")}
    assert counters(opt) == counters(jopt)
    assert _flight_events(tmp, "port") == _flight_events(tmp, "ref")


def test_unbudgeted_dispatch_error_spends_the_retries(tmp_path):
    # at=1 with no count= fires on every retry of dispatch 1: both
    # packages give up after failure_retry_times (2 here) retries
    model = nn.Sequential(nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
                          nn.LogSoftMax()).initialize(3)
    start = to_jax_params(model)
    for pkg, exc in (("port", InjectedFault), ("ref", jfaults.InjectedFault)):
        with pytest.raises(exc, match="dispatch=1"):
            _run(pkg, start, str(tmp_path), "dispatch_error@where=driver,at=1",
                 "off")
    assert _flight_events(str(tmp_path), "port")[0][-1][0] == "run_crash"
    assert _flight_events(str(tmp_path), "port") == \
        _flight_events(str(tmp_path), "ref")


def test_local_optimizer_refuses_membership_kinds():
    msgs = []
    for cfg, o, n_, S, DS, B in (
            (config, optim, nn, Sample, DataSet, SampleToMiniBatch),
            (jconfig, joptim, jnn, JSample, JDataSet, JSampleToMiniBatch)):
        cfg.configure(fault_plan="resize@at=2,to=2")
        kw = {"device": "cpu"} if o is optim else {}
        opt = o.LocalOptimizer(
            n_.Sequential(n_.Linear(16, 4), n_.LogSoftMax()),
            DS.array(_samples(S)) >> B(16), n_.ClassNLLCriterion(), **kw) \
            .set_end_when(o.max_iteration(2))
        with pytest.raises(ValueError, match="LocalOptimizer") as ei:
            opt.optimize()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("k", [1, 4])
def test_no_plan_is_inert(tmp_path, k):
    assert FaultInjector.from_config() is None
    model = nn.Sequential(nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
                          nn.LogSoftMax()).initialize(3)
    start = to_jax_params(model)
    a, a_opt, _ = _run("port", start, str(tmp_path), "", "off", k=k)
    config.reset_config()
    opt = _recording(optim.LocalOptimizer)(
        nn.Sequential(nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
                      nn.LogSoftMax()).initialize(3),
        DataSet.array(_samples(Sample)) >> SampleToMiniBatch(16),
        nn.ClassNLLCriterion(), device="cpu") \
        .set_optim_method(optim.SGD(learning_rate=0.1)) \
        .set_steps_per_dispatch(k).set_end_when(optim.max_iteration(8))
    opt.optimize()
    assert a_opt._fault_injector is None and opt._fault_injector is None
    assert opt._membership is None and opt._telemetry is None
    np.testing.assert_array_equal(a, opt.losses)
    assert a_opt._dispatch_count == opt._dispatch_count


# ---------------------------------------------------------------- serving
def _service(**kw):
    torch.manual_seed(0)
    model = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4),
                          nn.SoftMax()).initialize(0)
    return InferenceService(model, input_spec=((16,), np.float32),
                            max_batch_size=8, batch_timeout_ms=0,
                            device="cpu", **kw)


def test_serving_faults_revive_and_release():
    rng = np.random.default_rng(0)
    reqs = [rng.normal(0, 1, (2, 16)).astype(np.float32) for _ in range(7)]
    clean = _service()
    want = [clean.predict(r, timeout=30) for r in reqs]
    clean.stop()
    tracer = Tracer()
    svc = _service(fault_injector=FaultInjector(
        "dispatch_error@at=2;replica_death@at=4"), tracer=tracer,
        request_tracing=True)
    got, stranded = {}, None
    try:
        for i, r in enumerate(reqs):
            fut = svc.submit(r)
            if i == 2:
                with pytest.raises(InjectedFault):
                    fut.result(timeout=30)
                continue
            if i == 4:
                stranded = fut
                deadline = time.monotonic() + 30
                while svc.alive and time.monotonic() < deadline:
                    time.sleep(0.005)
                assert not svc.alive and not fut.done()
                assert svc.revive() is True and svc.alive
                assert svc.revive() is False  # healthy: a no-op
                continue
            got[i] = fut.result(timeout=30)
    finally:
        svc.stop()
    for i, out in got.items():
        np.testing.assert_array_equal(out, want[i])
    assert stranded is not None and not stranded.done()
    starts = [e for e in tracer.events() if e[0] == "s"]
    ends = [e for e in tracer.events() if e[0] == "f"]
    # one flow a request, closed in its dispatch span (the dead one's
    # too: the span opens before the fault site)
    assert len(starts) == len(reqs)
    assert sorted(e[7] for e in ends) == sorted(e[7] for e in starts)
    with pytest.raises(RuntimeError, match="stop"):
        _service().release()
    svc.release()
    assert svc.model is None


def test_replica_death_escapes_exception_handlers():
    assert not issubclass(ReplicaDeathFault, Exception)

"""The port's telemetry plane (``bigdl_tpu_torch/telemetry``,
``utils/metrics.py``, ``utils/profiling.py``) against the reference's.

- The tracer's Chrome trace of one span sequence (fixed endpoints) equals
  the reference's, apart from the process name; the Prometheus text of the
  same registry snapshots is byte-equal; a flight dump written by either
  package loads in the other, and ``tools.obs_report`` and
  ``tools.trace_report`` summarise the port's dumps.
- The admin endpoints answer over loopback (``/profile`` on the CPU
  profiler); every server started here is stopped in its teardown.
- ``Metrics`` and ``get_times`` behave as the reference's.
- On a small LSTM and a small MLP, telemetry and the flight recorder on
  against off give bitwise-equal losses, and the run's spans carry the
  reference driver's span names and phase categories for the same model.
"""

import json
import math
import os
import threading
import urllib.request

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
from bigdl_tpu.models.rnn import ptb_model as jax_ptb_model  # noqa: E402
from bigdl_tpu.telemetry import admin as jadmin  # noqa: E402
from bigdl_tpu.telemetry import flight as jflight  # noqa: E402
from bigdl_tpu.telemetry import registry as jregistry  # noqa: E402
from bigdl_tpu.telemetry import tracer as jtracer  # noqa: E402
from bigdl_tpu.telemetry import watchdog as jwatchdog  # noqa: E402
from bigdl_tpu.utils import metrics as jmetrics  # noqa: E402
from bigdl_tpu.utils import profiling as jprofiling  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import ptb_model  # noqa: E402
from bigdl_tpu_torch.ops import lstm_cell  # noqa: E402
from bigdl_tpu_torch.telemetry import (PHASE_CATS, AdminServer,  # noqa: E402
                                       FlightRecorder, MemoryWatermark,
                                       MetricRegistry, StallDetector, Tracer,
                                       admin, flight, jit_cache_size,
                                       render_prometheus)
from bigdl_tpu_torch.utils import config  # noqa: E402
from bigdl_tpu_torch.utils import profiling  # noqa: E402
from bigdl_tpu_torch.utils.metrics import Metrics  # noqa: E402
from bigdl_tpu_torch.utils.profiling import (TRACE_FILE, format_times,  # noqa: E402
                                             get_times, profile_step,
                                             profile_window)
from tools import obs_report, trace_report  # noqa: E402


@pytest.fixture(autouse=True)
def _clean():
    """No admin server, flight recorder or config override outlives a
    test (the tier-1 run shares its workers)."""
    yield
    admin.reset()
    flight.reset()
    config.reset_config()


# ----------------------------------------------------------------- tracer
SPANS = [("host_stack", "stage", 1_000, 4_000, None),
         ("h2d_stage", "stage", 4_000, 6_500, None),
         ("dispatch", "dispatch", 7_000, 19_000, None),
         ("block_inflight", "pipeline", 7_000, 30_000, "device"),
         ("device_wait", "device_wait", 20_000, 30_000, None),
         ("replay", "replay", 30_500, 31_000, None),
         ("checkpoint", "trigger", 30_600, 30_900, None)]


def _record(tracer_cls):
    t = tracer_cls()
    for name, cat, t0, t1, track in SPANS:
        t.record(name, t0, t1, cat=cat, track=track, steps=2)
    return t


def test_chrome_trace_equals_reference_but_the_process_name():
    mine = _record(Tracer).to_chrome_trace()
    ref = _record(jtracer.Tracer).to_chrome_trace()
    assert mine["traceEvents"][0]["args"]["name"] == "bigdl_tpu_torch"
    assert ref["traceEvents"][0]["args"]["name"] == "bigdl_tpu"
    mine["traceEvents"][0]["args"]["name"] = "bigdl_tpu"
    assert mine == ref
    assert PHASE_CATS == jtracer.PHASE_CATS


def test_trace_report_reads_the_ports_dump(tmp_path):
    path = _record(Tracer).dump(str(tmp_path / "t.json"))
    report = trace_report.summarize(trace_report.load_trace(path))
    ref = trace_report.summarize(_record(jtracer.Tracer).to_chrome_trace())
    assert report == ref and report["span_count"] == len(SPANS)
    assert set(report["phase_seconds"]) >= {"stage", "dispatch",
                                             "device_wait", "replay"}


# -------------------------------------------------------------- registry
def _fill(reg):
    reg.counter("resilience/dispatch_retries").inc(3)
    reg.gauge("driver/device_wait_fraction").set(0.25)
    h = reg.histogram("serving/latency_s")
    for v in (0.5, 0.25, 2.0, 1.0):
        h.observe(v)
    return reg.snapshot()


def test_prometheus_text_is_byte_equal():
    snaps = {"driver": _fill(MetricRegistry())}
    jsnaps = {"driver": _fill(jregistry.MetricRegistry())}
    assert snaps == jsnaps
    assert render_prometheus(snaps) == jadmin.render_prometheus(jsnaps)
    assert "bigdl_tpu_resilience_dispatch_retries" in \
        render_prometheus(snaps)


# ---------------------------------------------------------------- flight
def _events(rec):
    rec.record("run_start", cat="driver", trace_id="00ab00cd00000001")
    rec.record("nonfinite_step", cat="driver", step=5, policy="skip")
    rec.record("checkpoint_commit", cat="driver", step=8, path="m.8")
    return rec


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_flight_dumps_load_in_either_package(tmp_path, writer):
    cls = FlightRecorder if writer == "port" else jflight.FlightRecorder
    stream = str(tmp_path / "f.jsonl")
    rec = _events(cls(stream))
    rec.close()
    blob = str(tmp_path / "f.json")
    rec.dump(blob)
    for path in (stream, blob):
        mine, ref = flight.load_dump(path), jflight.load_dump(path)
        assert mine == ref
        assert [e["event"] for e in mine["events"]] == [
            "run_start", "nonfinite_step", "checkpoint_commit"]
    report = obs_report.summarize(
        flight.load_dump(stream),
        trace=_record(Tracer).to_chrome_trace())
    assert report["event_counts"]["nonfinite_step"] == 1
    assert report["meta"]["trace_joined"] and report["n_requests"] == 1


# ----------------------------------------------------------------- admin
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_admin_endpoints_answer_over_loopback(tmp_path):
    reg, tr, rec = MetricRegistry(), _record(Tracer), FlightRecorder()
    _fill(reg)
    _events(rec)
    srv = AdminServer(port=0, profile_dir=str(tmp_path / "prof"))
    try:
        port = srv.start()
        assert port > 0 and srv.host == "127.0.0.1"
        name = srv.unique_source_name("driver")
        srv.add_registry(name, reg).add_tracer(name, tr).set_flight(rec)
        srv.add_health(name, lambda: {"ok": True})
        code, body = _get(srv.url("/metrics"))
        assert code == 200 and body.decode() == render_prometheus(
            {name: reg.snapshot()})
        code, body = _get(srv.url("/healthz"))
        assert code == 200 and json.loads(body)["ok"] is True
        srv.add_health("sick", lambda: {"ok": False})
        assert _get(srv.url("/healthz"))[0] == 503
        code, body = _get(srv.url("/trace"))
        spans = [e for e in json.loads(body)["traceEvents"]
                 if e["ph"] == "X"]
        assert code == 200 and len(spans) == len(SPANS)
        code, body = _get(srv.url("/flight"))
        assert code == 200 and len(json.loads(body)["events"]) == 3
        code, body = _get(srv.url("/profile?seconds=0.1"))
        answer = json.loads(body)
        assert code == 200 and os.path.exists(
            os.path.join(answer["log_dir"], TRACE_FILE))
        assert (answer["device_events"], answer["launches"],
                answer["retakes"]) == (0, 0, 0)
        assert _get(srv.url("/nope"))[0] == 404
    finally:
        srv.stop()
    assert not srv.running


def test_admin_off_by_default_builds_nothing():
    threads = {t.ident for t in threading.enumerate()}
    assert admin.maybe_start() is None and admin.current() is None
    assert flight.from_config() is None
    assert {t.ident for t in threading.enumerate()} <= threads


# ------------------------------------------------ metrics, profiling, dogs
def test_metrics_behave_as_the_reference():
    mine, ref = Metrics(), jmetrics.Metrics()
    for m in (mine, ref):
        m.add("data", 0.5)
        m.add("data", 0.25)
        m.add("computing", 1.0)
    assert mine.summary() == ref.summary()
    assert mine.value("data") == ref.value("data") == 0.75
    assert mine.mean("computing") == ref.mean("computing") == 1.0
    shared = MetricRegistry()
    owned = Metrics(shared)
    owned.add("x", 1.0)
    shared.counter("keep").inc()
    owned.reset()
    assert shared.names() == ["keep"]


def test_get_times_rows_match_the_reference():
    mine = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4),
                         nn.LogSoftMax()).initialize(0)
    ref = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(), jnn.Linear(32, 4),
                         jnn.LogSoftMax())
    ref.initialize()
    times = get_times(mine, torch.ones(8, 16), repeats=2)
    jtimes = jprofiling.get_times(ref, jnp.ones((8, 16)), repeats=2)
    assert [t.name for t in times] == [t.name for t in jtimes]
    assert all(t.forward_s >= 0 and t.backward_s >= 0 for t in times)
    assert mine.training  # the walk restores the mode
    assert "fwd(ms)" in format_times(times)


def test_profile_capture_writes_a_chrome_trace(tmp_path):
    out = profile_step(lambda x: (x @ x).sum(), torch.ones(32, 32),
                       log_dir=str(tmp_path / "step"), steps=2)
    assert float(out) == 32.0 ** 3
    trace = json.load(open(tmp_path / "step" / TRACE_FILE))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    tr = Tracer()
    log_dir = profile_window(0.05, log_dir=str(tmp_path / "w"), tracer=tr)
    assert os.path.exists(os.path.join(log_dir, TRACE_FILE))
    assert [e[1] for e in tr.events()] == ["torch_profiler_window"]


@pytest.mark.parametrize("counts, retakes", [
    ([(0, 0)], 0),                      # the CPU: nothing launched
    ([(0, 12), (40, 41)], 1),           # the profiler lost the card once
    ([(0, 12)] * 8, profiling.WINDOW_RETAKES),  # bounded, then kept
])
def test_profile_window_retakes_a_window_without_device_activity(
        tmp_path, monkeypatch, counts, retakes):
    """A window whose trace records launches but no device activity is
    the profiler's fault: taken again, at most WINDOW_RETAKES times, each
    take a span; the kept window's counts go to ``stats``."""
    seen = iter(counts)
    monkeypatch.setattr(profiling, "_device_counts", lambda prof: next(seen))
    tr, stats = Tracer(), {}
    log_dir = profile_window(0.01, log_dir=str(tmp_path), tracer=tr,
                             stats=stats)
    device, launches = counts[min(retakes, len(counts) - 1)]
    assert stats == {"device_events": device, "launches": launches,
                     "retakes": retakes}
    assert [e[1] for e in tr.events()] == \
        ["torch_profiler_window"] * (retakes + 1)
    assert os.path.exists(os.path.join(log_dir, TRACE_FILE))


def test_watchdogs_on_the_cpu():
    assert jit_cache_size(lambda: 0) is None
    reg = MetricRegistry()
    mem = MemoryWatermark(reg, "cpu")
    assert mem.observe() is None and mem.available is False
    assert reg.gauges() == {}
    stalls = StallDetector(reg)
    jstalls = jwatchdog.StallDetector(jregistry.MetricRegistry())
    for s in (stalls, jstalls):
        s.record_block(0.010, 0.001, 0.030, 0.002)
        s.record_block(0.001, 0.080, 0.010, 0.001)
    assert stalls.fractions() == jstalls.fractions()
    assert stalls.sync_stall_count == jstalls.sync_stall_count == 1


# -------------------------------------------------------------- the driver
VOCAB, HIDDEN, T, BATCH, STEPS = 50, 32, 6, 4, 10


def _windows(S):
    ids = np.minimum(np.random.default_rng(0).zipf(1.4, 20 * T + 1),
                     VOCAB - 1).astype(np.int32)
    return [S(x, y) for x, y in zip(ids[:-1].reshape(-1, T),
                                    ids[1:].reshape(-1, T))]


def _mlp_samples(S):
    rng = np.random.default_rng(1)
    return [S(rng.normal(size=12).astype(np.float32),
              np.int32(rng.integers(0, 3))) for _ in range(24)]


def _models(kind):
    """(port model, reference model with the port's weights, samples
    maker, criterion pair)."""
    if kind == "lstm":
        model = ptb_model(VOCAB, 16, HIDDEN, 2).initialize(0)
        ref = jax_ptb_model(VOCAB, 16, HIDDEN, 2)
        crit = (nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()))
        return model, ref, _windows, crit
    model = nn.Sequential(nn.Linear(12, 16), nn.ReLU(), nn.Linear(16, 3),
                          nn.LogSoftMax()).initialize(0)
    ref = jnn.Sequential(jnn.Linear(12, 16), jnn.ReLU(), jnn.Linear(16, 3),
                         jnn.LogSoftMax())
    return model, ref, _mlp_samples, (nn.ClassNLLCriterion(),
                                      jnn.ClassNLLCriterion())


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _port_run(kind, tmp, telemetry):
    model, _, samples, (crit, _) = _models(kind)
    if telemetry:
        config.configure(flight_recorder_path=os.path.join(tmp, "f.jsonl"))
    opt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(samples(Sample), seed=3)
        >> SampleToMiniBatch(BATCH), crit, device="cpu")
        .set_optim_method(optim.SGD(learning_rate=0.5))
        .set_steps_per_dispatch(3)
        .set_checkpoint(os.path.join(tmp, f"ck{int(telemetry)}"),
                        optim.several_iteration(4))
        .set_end_when(optim.max_iteration(STEPS)))
    if telemetry:
        opt.set_telemetry(True, trace_path=os.path.join(tmp, "t.json"))
    launches = lstm_cell.fwd_launches
    opt.optimize()
    assert lstm_cell.fwd_launches == launches == 0  # plain on the CPU
    return opt


def _ref_run(kind, tmp):
    model, ref, samples, (_, crit) = _models(kind)
    params, state = to_jax_params(model)
    ref._params = jax.tree_util.tree_map(jnp.asarray, params)
    ref._state = state
    opt = (joptim.LocalOptimizer(
        ref, JDataSet.array(samples(JSample), seed=3)
        >> JSampleToMiniBatch(BATCH), crit)
        .set_optim_method(joptim.SGD(learning_rate=0.5))
        .set_steps_per_dispatch(3)
        .set_checkpoint(os.path.join(tmp, "jck"), joptim.several_iteration(4))
        .set_telemetry(True, trace_path=os.path.join(tmp, "jt.json"))
        .set_end_when(joptim.max_iteration(STEPS)))
    opt.optimize()
    return opt


def _span_kinds(tracer):
    return {(e[1], e[2]) for e in tracer.events() if e[0] == "X"}


@pytest.mark.parametrize("kind", ["lstm", "mlp"])
def test_telemetry_is_inert_and_traces_the_reference_phases(tmp_path, kind):
    off = _port_run(kind, str(tmp_path), telemetry=False)
    assert off._telemetry is None and off._flight is None
    assert off.telemetry_snapshot() is None
    on = _port_run(kind, str(tmp_path), telemetry=True)
    assert on.losses == off.losses  # bitwise: the spans only read clocks
    assert on._dispatch_count == off._dispatch_count
    snap = on.telemetry_snapshot()
    dogs = snap["watchdogs"]
    assert dogs["recompile_events"] == [] and dogs["blocks_observed"] > 0
    assert math.isclose(sum(dogs["phase_fractions"].values()), 1.0)
    assert dogs["memory_stats_available"] is False  # no gauges on the CPU
    ref = _ref_run(kind, str(tmp_path))
    assert _span_kinds(on._telemetry.tracer) == _span_kinds(
        ref._telemetry.tracer)
    report = trace_report.summarize(
        trace_report.load_trace(str(tmp_path / "t.json")))
    for cat in PHASE_CATS:
        assert cat in report["phase_seconds"], report["phase_seconds"]
    events = flight.load_dump(str(tmp_path / "f.jsonl"))["events"]
    commits = [e for e in events if e["event"] == "checkpoint_commit"]
    assert [e["step"] for e in commits] == [4, 8]
    assert {e["trace_id"] for e in commits} == {snap["trace_id"]}

"""``bigdl_tpu_torch.frontend`` — the wire front end — against the
reference's ``FrontendServer``.

The same HTTP exchanges go to the reference's server over a JAX MLP (and
a JAX ``DecodeService``) and to the port's over its twin with the same
numpy weights, on both connection cores: status codes, ``Retry-After``
headers, body schema, outputs within 1e-6 (the same f32 MLP in another
order; sound readings ~1e-7), streaming order and trailer, version
pinning, auth and tenant admission.  The port's hot cutover runs under
wire predict and generate load with zero drops.  The reference's
stdlib-level contract classes (token buckets, QoS admission and
preemption, the autoscaler, inertness, the chunked decoder and request
parser, CPU pinning) run against the port's modules through
``reference_classes``.

Wire tests use bounded client timeouts and ``Future.result(timeout=)``,
order events without sleeps, and share one server per core per module.
"""

import functools
import http.client
import json
import os
import socket  # noqa: F401  (the reference classes use it)
import threading
import time
from io import BytesIO

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu import frontend as jfe  # noqa: E402
from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import serving as jserving  # noqa: E402
from bigdl_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.frontend import (BATCH, LATENCY,  # noqa: E402,F401
                                      CutoverDrainTimeout, FrontendServer,
                                      HotCutover, QosAdmission,
                                      ReplicaAutoscaler, TenantRateLimited,
                                      TenantSpec, TokenBucket,
                                      UnknownTenantError)
from bigdl_tpu_torch.frontend.http1 import (ChunkedDecoder,  # noqa: E402,F401
                                            ProtocolError, RequestParser,
                                            read_chunked_body)
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models.transformer import transformer_lm  # noqa: E402
from bigdl_tpu_torch.resilience import replica_set as _rs  # noqa: E402
from bigdl_tpu_torch.serving import DecodeService  # noqa: E402
from bigdl_tpu_torch.serving import registry as _registry  # noqa: E402
from bigdl_tpu_torch.serving import service as _service  # noqa: E402
from bigdl_tpu_torch.telemetry.context import RequestContext  # noqa: E402,F401
from bigdl_tpu_torch.telemetry.registry import MetricRegistry  # noqa: E402,F401
from torch_reference_cases import reference_classes  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
TOL = 1e-6
CORES = ["eventloop", "threaded"]

ReplicaSet = functools.partial(_rs.ReplicaSet, devices=[CPU])
InferenceService = functools.partial(_service.InferenceService, device="cpu")
ModelRegistry = functools.partial(_registry.ModelRegistry, device="cpu")


def make_model(din=16, dout=4):
    return nn.Sequential(nn.Linear(din, 32), nn.ReLU(),
                         nn.Linear(32, dout), nn.SoftMax()).initialize(0)


make_mlp = make_model
SPEC16 = ((16,), np.float32)


def rows(rng, n, din=16):
    return rng.normal(0, 1, (n, din)).astype(np.float32)


def post(port, path, body, headers=None, timeout=60):
    """One POST → (status, headers dict, raw body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def get(port, path, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def parse_stream(body: bytes):
    return [json.loads(ln) for ln in body.decode().splitlines() if ln]


# -------------------------------------------- the reference's contracts
exec(reference_classes(  # noqa: S102
    "test_frontend.py",
    ["TestTokenBucket", "TestQosAdmission", "TestQosPreemption",
     "_FakeReplica", "_FakeRS", "TestAutoscaler", "TestFrontendInertness"],
    drop=["test_training_bitwise_and_thread_free"],
    subs=[("        from bigdl_tpu.utils.config import Config\n",
           "        from bigdl_tpu_torch.utils.config import Config\n")]))
exec(reference_classes(  # noqa: S102
    "test_decode_serving.py",
    ["chunk_body", "chunked_req", "TestChunkedDecoder",
     "TestChunkedRequestParser", "TestPinCpus"],
    subs=[("        from bigdl_tpu.utils.config import Config\n",
           "        from bigdl_tpu_torch.utils.config import Config\n")]))


def test_inert_until_a_server_is_built():
    """Importing the package and building QoS objects starts no thread
    and opens no socket; a constructed server binds only at start()."""
    before = {t.name for t in threading.enumerate()}
    QosAdmission([TenantSpec("t", rate_rps=5.0)]).admit("t")
    fe = FrontendServer(backends={}, port=0)
    assert {t.name for t in threading.enumerate()} == before
    assert not fe.running
    fe.start()
    fe.stop()


# ----------------------------------------------------- the two stacks
VOCAB = 64


def _stack(pkg, core):
    """A front end of ``pkg`` ("ref" or "port") on ``core`` over: a
    registry with the MLP ``clf`` (v1, and v2 with the same weights) and
    the decode LM ``lm``; a 2-replica set ``rs``; a parked service
    ``parked`` (nothing dispatches: deadlines expire in its queue); a
    parked service ``full`` whose one-request queue is full."""
    mlp = make_model()
    params, state = to_jax_params(mlp)
    lm = transformer_lm(VOCAB, 32, 4, 2, max_len=64).initialize(0).eval()
    lp, ls = to_jax_params(lm)
    if pkg == "ref":
        jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(),
                            jnn.Linear(32, 4), jnn.SoftMax())
        P = jax.tree_util.tree_map(jnp.asarray, params)
        S = jax.tree_util.tree_map(jnp.asarray, state)
        reg = jserving.ModelRegistry()
        for _ in range(2):
            reg.deploy("clf", jm, params=P, state=S, input_spec=SPEC16,
                       max_batch_size=8)
        jlm = jax_lm(VOCAB, 32, 4, 2, max_len=64)
        reg.deploy("lm", service=jserving.DecodeService(
            jlm, jax.tree_util.tree_map(jnp.asarray, lp),
            jax.tree_util.tree_map(jnp.asarray, ls), slots=2,
            max_seq_len=32, max_prompt_len=8, prefill_buckets="top"))
        from bigdl_tpu.resilience import ReplicaSet as jRS
        backends = {
            "rs": jRS(jm, P, S, n_replicas=2, devices=jax.local_devices(),
                      input_spec=SPEC16, max_batch_size=8),
            "parked": jserving.InferenceService(
                jm, P, S, input_spec=SPEC16, max_batch_size=8,
                start=False, name="parked"),
            "full": jserving.InferenceService(
                jm, P, S, input_spec=SPEC16, max_batch_size=8,
                queue_capacity=1, start=False, name="full")}
        server = jfe.FrontendServer
    else:
        reg = ModelRegistry()
        for _ in range(2):
            reg.deploy("clf", mlp, input_spec=SPEC16, max_batch_size=8)
        reg.deploy("lm", service=DecodeService(
            lm, slots=2, max_seq_len=32, max_prompt_len=8,
            prefill_buckets="top", device="cpu"))
        backends = {
            "rs": ReplicaSet(mlp, n_replicas=2, input_spec=SPEC16,
                             max_batch_size=8),
            "parked": InferenceService(mlp, input_spec=SPEC16,
                                       max_batch_size=8, start=False,
                                       name="parked"),
            "full": InferenceService(mlp, input_spec=SPEC16,
                                     max_batch_size=8, queue_capacity=1,
                                     start=False, name="full")}
        server = FrontendServer
    backends["full"].submit(np.zeros((1, 16), np.float32))
    fe = server(reg, backends=backends, port=0, core=core)
    fe.start()
    return fe, reg, backends


@pytest.fixture(scope="module", params=CORES)
def stacks(request):
    pair = {pkg: _stack(pkg, request.param) for pkg in ("ref", "port")}
    yield {pkg: s[0].port for pkg, s in pair.items()}
    for fe, reg, backends in pair.values():
        fe.stop()
        for b in backends.values():
            b.stop(drain=False)
        reg.stop_all(drain=False)


X3 = np.random.default_rng(5).normal(0, 1, (3, 16)).astype(np.float32)
X20 = np.random.default_rng(6).normal(0, 1, (20, 16)).astype(np.float32)


def _npy(a):
    buf = BytesIO()
    np.save(buf, a)
    return buf.getvalue()


JSON = {"Content-Type": "application/json"}
NPY = {"Content-Type": "application/x-npy"}
# name -> (method, path, body, headers)
EXCHANGES = {
    "predict_json": ("POST", "/v1/models/clf/predict",
                     json.dumps({"inputs": X3.tolist()}), JSON),
    "predict_pinned_v1": ("POST", "/v1/models/clf:1/predict",
                          json.dumps({"inputs": X3.tolist()}), JSON),
    "predict_unknown_version": ("POST", "/v1/models/clf:9/predict",
                                json.dumps({"inputs": X3.tolist()}), JSON),
    "predict_npy_in_npy_out": ("POST", "/v1/models/clf/predict", _npy(X3),
                               {**NPY, "Accept": "application/x-npy"}),
    "predict_streaming": ("POST", "/v1/models/clf/predict",
                          json.dumps({"inputs": X20.tolist()}), JSON),
    "predict_replica_set": ("POST", "/v1/models/rs/predict",
                            json.dumps({"inputs": X3.tolist()}), JSON),
    "predict_trace_echo": ("POST", "/v1/models/clf/predict",
                           json.dumps({"inputs": X3[:1].tolist()}),
                           {**JSON, "X-Trace-Id": "00000000deadbeef"}),
    "unknown_model_404": ("POST", "/v1/models/nope/predict",
                          json.dumps({"inputs": X3.tolist()}), JSON),
    "bad_json_400": ("POST", "/v1/models/clf/predict", "{not json", JSON),
    "wrong_shape_400": ("POST", "/v1/models/clf/predict",
                        json.dumps({"inputs": [[1.0, 2.0]]}), JSON),
    "no_inputs_400": ("POST", "/v1/models/clf/predict",
                      json.dumps({"x": 1}), JSON),
    "zip_npy_400": ("POST", "/v1/models/clf/predict", b"PK\x03\x04junk",
                    NPY),
    "bad_deadline_400": ("POST", "/v1/models/clf/predict",
                         json.dumps({"inputs": X3.tolist()}),
                         {**JSON, "X-Deadline-Ms": "soon"}),
    "deadline_504": ("POST", "/v1/models/parked/predict",
                     json.dumps({"inputs": X3[:1].tolist()}),
                     {**JSON, "X-Deadline-Ms": "50"}),
    "full_queue_429": ("POST", "/v1/models/full/predict",
                       json.dumps({"inputs": X3[:1].tolist()}), JSON),
    "generate_stream": ("POST", "/v1/models/lm/generate",
                        json.dumps({"prompt": [5, 9, 3],
                                    "max_new_tokens": 6}), JSON),
    "generate_on_predict_backend_400": (
        "POST", "/v1/models/clf/generate",
        json.dumps({"prompt": [1, 2]}), JSON),
    "predict_on_decode_backend_400": (
        "POST", "/v1/models/lm/predict",
        json.dumps({"inputs": X3.tolist()}), JSON),
    "generate_bad_body_400": ("POST", "/v1/models/lm/generate",
                              json.dumps({"prompt": [[1], [2]]}), JSON),
    "generate_bad_max_new_400": ("POST", "/v1/models/lm/generate",
                                 json.dumps({"prompt": [1],
                                             "max_new_tokens": 0}), JSON),
    "models_listing": ("GET", "/v1/models", None, {}),
    "unknown_route_404": ("GET", "/v1/nothing", None, {}),
}


def _send(port, method, path, body, headers):
    if method == "GET":
        return get(port, path, headers)
    return post(port, path, body, headers)


def _body(status, headers, raw):
    ctype = headers.get("Content-Type", "")
    if "x-npy" in ctype:
        return np.load(BytesIO(raw))
    if "ndjson" in ctype:
        return parse_stream(raw)
    return json.loads(raw) if raw else None


def _same(a, b, where="body"):
    """Equal JSON schema and values; arrays within TOL; trace ids and
    the ephemeral fields of error messages aside."""
    if isinstance(a, np.ndarray):
        assert a.shape == np.asarray(b).shape, where
        assert float(np.abs(a - np.asarray(b)).max()) <= TOL, where
        return
    if isinstance(a, dict):
        assert set(a) == set(b), (where, sorted(a), sorted(b))
        for k in a:
            if k in ("trace_id", "error", "queue_depth", "capacity",
                     "retry_after_ms"):
                continue
            _same(a[k], b[k], f"{where}.{k}")
        return
    if isinstance(a, list) and a and isinstance(a[0], (float, list)):
        _same(np.asarray(a, np.float64), np.asarray(b, np.float64), where)
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    assert a == b, (where, a, b)


@pytest.mark.parametrize("name", sorted(EXCHANGES))
def test_exchange_matches_reference(stacks, name):
    method, path, body, headers = EXCHANGES[name]
    got = {pkg: _send(port, method, path, body, headers)
           for pkg, port in stacks.items()}
    (rs, rh, rb), (ps, ph, pb) = got["ref"], got["port"]
    assert ps == rs, (name, rs, ps, rb[:300], pb[:300])
    for h in ("Content-Type", "Retry-After", "X-Model-Version",
              "Transfer-Encoding"):
        assert (h in ph) == (h in rh), (name, h, rh, ph)
        if h != "X-Retry-After-Ms" and h in ph and h != "Retry-After":
            assert ph[h] == rh[h], (name, h)
    _same(_body(rs, rh, rb), _body(ps, ph, pb), name)
    if name == "predict_trace_echo":
        assert ph["X-Trace-Id"] == rh["X-Trace-Id"] == "00000000deadbeef"
    if name == "predict_streaming":
        lines = _body(ps, ph, pb)
        assert lines[-1]["done"] is True and lines[-1]["rows"] == 20
    if name == "generate_stream":
        lines = _body(ps, ph, pb)
        assert [ln["index"] for ln in lines[:-1]] == list(range(6))
        assert lines[-1]["done"] is True
        assert [ln["token"] for ln in lines[:-1]] == lines[-1]["tokens"]
    if name in ("full_queue_429", "deadline_504", "unknown_model_404"):
        assert ps == int(name[-3:])


# --------------------------------------------------- auth and tenants
@pytest.fixture(scope="module", params=CORES)
def guarded(request):
    """Bearer auth and strict tenant admission, in both packages."""
    out, owned = {}, []
    for pkg in ("ref", "port"):
        mlp = make_model()
        if pkg == "ref":
            params, state = to_jax_params(mlp)
            jm = jnn.Sequential(jnn.Linear(16, 32), jnn.ReLU(),
                                jnn.Linear(32, 4), jnn.SoftMax())
            svc = jserving.InferenceService(
                jm, jax.tree_util.tree_map(jnp.asarray, params),
                jax.tree_util.tree_map(jnp.asarray, state),
                input_spec=SPEC16, max_batch_size=8, name="authed")
            qos = jfe.QosAdmission([jfe.TenantSpec("acme", rate_rps=0.001,
                                                   burst=1)], strict=True)
            fe = jfe.FrontendServer(backends={"clf": svc}, qos=qos, port=0,
                                    auth_token="s3cret", core=request.param)
        else:
            svc = InferenceService(mlp, input_spec=SPEC16, max_batch_size=8,
                                   name="authed")
            qos = QosAdmission([TenantSpec("acme", rate_rps=0.001,
                                           burst=1)], strict=True)
            fe = FrontendServer(backends={"clf": svc}, qos=qos, port=0,
                                auth_token="s3cret", core=request.param)
        fe.start()
        out[pkg] = fe.port
        owned.append((fe, svc))
    yield out
    for fe, svc in owned:
        fe.stop()
        svc.stop()


GUARDED = [  # in order: the tenant's one-token bucket is spent by #3
    ("no_token_401", {}),
    ("wrong_token_401", {"Authorization": "Bearer nope"}),
    ("malformed_token_401", {"Authorization": "s3cret"}),
    ("no_tenant_403", {"Authorization": "Bearer s3cret"}),
    ("unknown_tenant_403", {"Authorization": "Bearer s3cret",
                            "X-Tenant": "rando"}),
    ("tenant_200", {"Authorization": "Bearer s3cret", "X-Tenant": "acme"}),
    ("tenant_rate_limited_429", {"Authorization": "Bearer s3cret",
                                 "X-Tenant": "acme"}),
]


def test_auth_and_tenants_match_reference(guarded):
    body = json.dumps({"inputs": X3.tolist()})
    for name, hdrs in GUARDED:
        got = {pkg: post(port, "/v1/models/clf/predict", body,
                         {**JSON, **hdrs}) for pkg, port in guarded.items()}
        (rs, rh, rb), (ps, ph, pb) = got["ref"], got["port"]
        assert ps == rs == int(name[-3:]), (name, rs, ps, pb[:200])
        assert ("Retry-After" in ph) == ("Retry-After" in rh), name
        _same(json.loads(rb), json.loads(pb), name)
    st, _, _ = get(guarded["port"], "/v1/models")
    assert st == 401


def test_non_loopback_bind_needs_a_token():
    with pytest.raises(ValueError, match="auth token"):
        FrontendServer(backends={}, host="0.0.0.0", port=0)
    FrontendServer(backends={}, host="0.0.0.0", port=0, auth_token="t")


# ------------------------------------------------------- the port alone
@pytest.mark.parametrize("core", CORES)
def test_hot_cutover_under_predict_and_generate_load(core):
    """Two hot deploys of the MLP and one of the decode backend under
    concurrent wire load: every request answers 200 with a correct body
    (each MLP version has the same weights), versions only move forward
    within a client, and every generate stream closes with its trailer."""
    mlp = make_model()
    lm = transformer_lm(VOCAB, 32, 4, 2, max_len=64).initialize(0).eval()
    reg = ModelRegistry()
    reg.deploy("clf", mlp, input_spec=SPEC16, max_batch_size=8)
    reg.deploy("lm", service=DecodeService(
        lm, slots=2, max_seq_len=32, max_prompt_len=8,
        prefill_buckets="top", device="cpu"))
    fe = FrontendServer(reg, port=0, core=core)
    port = fe.start()
    with torch.no_grad():
        want = mlp(torch.from_numpy(X3)).numpy()
    stop, errors, seen = threading.Event(), [], []

    def predictor():
        last = 0
        while not stop.is_set():
            st, h, b = post(port, "/v1/models/clf/predict",
                            json.dumps({"inputs": X3.tolist()}), timeout=30)
            if st != 200:
                errors.append((st, b[:200]))
                continue
            v = int(h["X-Model-Version"])
            if v < last:
                errors.append(("version went back", last, v))
            last = v
            y = np.asarray(json.loads(b)["outputs"], np.float32)
            if float(np.abs(y - want).max()) > TOL:
                errors.append("wrong rows")
            seen.append(v)

    def generator():
        while not stop.is_set():
            st, h, b = post(port, "/v1/models/lm/generate",
                            json.dumps({"prompt": [5, 9, 3],
                                        "max_new_tokens": 4}), timeout=30)
            lines = parse_stream(b) if st == 200 else []
            if st != 200 or not lines[-1].get("done") \
                    or len(lines) != 5:
                errors.append(("generate", st, b[:200]))

    threads = [threading.Thread(target=predictor) for _ in range(3)] + \
        [threading.Thread(target=generator) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        cut = HotCutover(reg, fe, drain_timeout_s=30)
        wait_until(lambda: len(seen) >= 3, 30, "load on v1")
        cut.deploy("clf", mlp, max_batch_size=8)
        cut.deploy("lm", service=DecodeService(
            lm, slots=2, max_seq_len=32, max_prompt_len=8,
            prefill_buckets="top", device="cpu"))
        n = len(seen)
        wait_until(lambda: len(seen) >= n + 3, 30, "load on v2")
        cut.deploy("clf", mlp, max_batch_size=8)
        n = len(seen)
        wait_until(lambda: len(seen) >= n + 3, 30, "load on v3")
        assert reg.list_models() == {"clf": [3], "lm": [2]}
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        fe.stop()
        reg.stop_all()
    assert errors == []
    assert max(seen) == 3


def test_replica_death_over_the_wire_settles_every_request():
    """A replica dies under concurrent wire load: every request answers
    200 with the right rows, and the counters tell death, failover and
    revival."""
    from bigdl_tpu_torch.resilience import FaultInjector
    mlp = make_model()
    rs = ReplicaSet(mlp, n_replicas=2, input_spec=SPEC16, max_batch_size=8,
                    fault_injector=FaultInjector(
                        "replica_death@target=0,after=3,count=1"))
    fe = FrontendServer(backends={"rs": rs}, port=0)
    port = fe.start()
    with torch.no_grad():
        want = mlp(torch.from_numpy(X3)).numpy()
    results = []

    def client():
        for _ in range(6):
            st, _, b = post(port, "/v1/models/rs/predict",
                            json.dumps({"inputs": X3.tolist()}), timeout=30)
            results.append((st, np.asarray(json.loads(b)["outputs"])
                            if st == 200 else b))

    threads = [threading.Thread(target=client) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        snap = rs.stats()["resilience"]
    finally:
        fe.stop()
        rs.stop()
    assert len(results) == 24
    assert all(st == 200 for st, _ in results), results
    assert all(float(np.abs(y - want).max()) <= TOL for _, y in results)
    assert snap["resilience/replica_deaths"] == 1
    assert snap["resilience/revivals"] == 1
    assert snap["resilience/failovers"] >= 1

"""The port's serving slice: a quantized ResNet served through
``ModelRegistry`` on the CPU (through the plain versions) against the JAX
quantized model, plus the service's coalescing, stats, backpressure and
lifecycle contract.  The same slice on the card is in ``test_torch_gpu.py``.

Model-level tolerances against JAX (``resnet_cifar(depth=8)``):
- weight_only ``rtol=1e-5, atol=1e-5*max|y|``: f32 sums in another order
  (float64 in the port's plain GEMM), and BatchNorm's ``x*scale + shift``
  rounds twice here where XLA contracts it into an FMA;
- dynamic ``rtol=1e-3, atol=1e-3*max|y|``: the same one-ulp differences
  upstream can flip an activation's int8 rounding at the next quantized
  layer, which moves that layer's output by up to one quantization step.
Bitwise checks stay within the port on identical shapes: the
reference's cross-bucket bitwise claims are not a valid oracle here.
"""

import math
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.resnet import resnet_cifar as jax_resnet_cifar
from bigdl_tpu.nn.quantized import quantize as jax_quantize
from bigdl_tpu.serving import InferenceService as JaxInferenceService
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.serving import (InferenceService, ModelRegistry,
                                     ServiceClosed, ServiceOverloaded)
from bigdl_tpu_torch.serving.batcher import RequestSpecError
from bigdl_tpu_torch.utils.config import reset_config

SPEC = ((3, 32, 32), np.float32)
TOL = {"weight_only": 1e-5, "dynamic": 1e-3}


@pytest.fixture(scope="module")
def cifar():
    """(JAX model holding params/state, factory of port models with the
    same weights); BatchNorm running statistics are made non-trivial."""
    src = resnet_cifar(8).initialize(0)
    rng = np.random.default_rng(0)
    for m in src.modules():
        if isinstance(m, nn.SpatialBatchNormalization):
            m.running_mean.copy_(torch.from_numpy(
                rng.normal(0, 0.2, m.n_output).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 2.0, m.n_output).astype(np.float32)))
    params, state = to_jax_params(src)
    jm = jax_resnet_cifar(8)
    jm._params, jm._state = params, state
    return jm, lambda: load_jax_params(resnet_cifar(8), params, state)


def _rows(n, seed=1, shape=(3, 32, 32)):
    return np.random.default_rng(seed).normal(0, 1, (n,) + shape).astype(
        np.float32)


def _small_model():
    return (nn.Sequential().add(nn.Reshape((12,))).add(nn.Linear(12, 4))
            .initialize(0))


@pytest.mark.parametrize("quantize", [True, "dynamic"],
                         ids=["weight_only", "dynamic"])
def test_quantized_resnet_served_matches_jax(cifar, quantize):
    jm, make_port = cifar
    mode = "dynamic" if quantize == "dynamic" else "weight_only"
    jq = jax_quantize(jm, mode=mode)
    x = _rows(5)
    want = np.asarray(jax.jit(lambda p, s, x: jq.apply(p, s, x)[0])(
        jq._params, jq._state, x))
    with ModelRegistry(device="cpu") as reg:
        svc = reg.deploy("r", make_port(), input_spec=SPEC,
                         quantize=quantize, max_batch_size=8)
        got = reg.predict("r", x, timeout=120)
        assert svc.weights_dtype == "int8"
        assert svc.stats()["weights_dtype"] == "int8"
        assert all(m.mode == mode for m in svc.model.modules()
                   if isinstance(m, nn.QuantizedSpatialConvolution))
    assert got.shape == want.shape == (5, 10)
    tol = TOL[mode]
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_staged_coalescing_and_frozen_warmup():
    model = nn.quantize(_small_model())
    svc = InferenceService(model, input_spec=((3, 4), np.float32),
                           max_batch_size=8, batch_timeout_ms=50,
                           start=False, device="cpu")
    assert svc.buckets == (1, 2, 4, 8)
    assert svc.compile_count == len(svc.buckets)
    rng = np.random.default_rng(2)
    reqs = [rng.normal(0, 1, (int(rng.integers(1, 4)), 3, 4)).astype(
        np.float32) for _ in range(10)]
    futs = [svc.submit(r) for r in reqs]
    svc.start()
    outs = [f.result(timeout=60) for f in futs]
    stats = svc.stats()
    assert stats["requests_completed"] == sum(len(r) for r in reqs)
    assert stats["dispatch_count"] <= math.ceil(10 / 8) + len(svc.buckets)
    assert stats["compile_count"] == len(svc.buckets)
    with torch.no_grad():
        for r, o in zip(reqs, outs):
            direct = model(torch.from_numpy(r)).numpy()
            np.testing.assert_allclose(o, direct, rtol=1e-6, atol=1e-7)
    svc.stop()


def test_stats_schema_matches_reference():
    jax_svc = JaxInferenceService(
        jnn.Sequential().add(jnn.Reshape((12,))).add(jnn.Linear(12, 4)),
        input_spec=((3, 4), np.float32), max_batch_size=4)
    svc = InferenceService(_small_model(), input_spec=((3, 4), np.float32),
                           max_batch_size=4, device="cpu")
    try:
        x = _rows(3, shape=(3, 4))
        jax_svc.predict(x, timeout=60)
        svc.predict(x, timeout=60)
        js, ps = jax_svc.stats(), svc.stats()
        assert set(ps) == set(js)
        assert set(ps["latency_ms"]) == set(js["latency_ms"])
        assert ps["buckets"] == js["buckets"] == [1, 2, 4]
        assert ps["weights_dtype"] == js["weights_dtype"] == "f32"
        assert ps["compile_count"] == 3
    finally:
        jax_svc.stop()
        svc.stop()


def test_overload_then_drain_resolves_every_future():
    svc = InferenceService(_small_model(), input_spec=((3, 4), np.float32),
                           max_batch_size=4, queue_capacity=2, start=False,
                           device="cpu")
    x = _rows(1, shape=(3, 4))
    futs = [svc.submit(x), svc.submit(x)]
    with pytest.raises(ServiceOverloaded):
        svc.submit(x)
    assert svc.stats()["requests_rejected"] == 1
    svc.stop(drain=True)
    assert all(f.done() and f.result().shape == (1, 4) for f in futs)
    with pytest.raises(ServiceClosed):
        svc.submit(x)


def test_threaded_load_and_drain():
    svc = InferenceService(nn.quantize(_small_model(), mode="dynamic"),
                           input_spec=((3, 4), np.float32), max_batch_size=8,
                           batch_timeout_ms=2, device="cpu")
    results, errors = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(10):
                n = int(rng.integers(1, 5))
                results.append((n, svc.predict(rng.normal(
                    0, 1, (n, 3, 4)).astype(np.float32), timeout=60)))
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(out.shape == (n, 4) for n, out in results)
    stats = svc.stats()
    assert stats["requests_completed"] == sum(n for n, _ in results)
    assert 1 <= stats["dispatch_count"] <= len(results)
    assert 0 < stats["mean_batch_occupancy"] <= 1
    assert stats["compile_count"] == len(svc.buckets)
    svc.stop(drain=True)
    assert not svc.alive


def test_registry_breaker_falls_back_to_previous_version():
    reg = ModelRegistry(device="cpu", breaker_trip_after=2,
                        breaker_cooldown_s=60)
    spec = ((3, 4), np.float32)
    reg.deploy("m", _small_model(), input_spec=spec, max_batch_size=4)
    reg.deploy("m", _small_model(), input_spec=spec, max_batch_size=4,
               quantize=True)
    assert reg.list_models() == {"m": [1, 2]}
    assert reg.stats()["m:v2"]["weights_dtype"] == "int8"
    for _ in range(2):
        with pytest.raises(RequestSpecError):
            reg.predict("m", np.zeros((1, 5, 4), np.float32))
    assert reg.breaker_state("m", 2)["open"]
    assert reg.route("m")[0] == 1
    assert reg.predict("m", _rows(2, shape=(3, 4))).shape == (2, 4)
    reg.undeploy("m", 1)
    assert reg.route("m")[0] == 2  # every breaker open: newest anyway
    reg.stop_all()
    assert reg.list_models() == {}


def test_deploy_refusals():
    reg = ModelRegistry(device="cpu")
    # files load through the interop layer: a missing one is an OSError,
    # a Keras JSON definition too
    with pytest.raises(FileNotFoundError):
        reg.deploy("m", path="missing.bigdl", format="bigdl")
    with pytest.raises(FileNotFoundError):
        reg.deploy("m", path="model.json", format="keras")
    with pytest.raises(ValueError, match="not servable"):
        reg.deploy("bad", nn.Sequential().add(nn.Reshape((12,),
                                                         batch_mode=False)),
                   input_spec=((3, 4), np.float32))
    assert reg.list_models() == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ModelRegistry()


def test_serving_defaults_from_env(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_SERVING_MAX_BATCH_SIZE", "16")
    monkeypatch.setenv("BIGDL_TPU_SERVING_ROW_BUCKETS", "4,16")
    reset_config()
    try:
        svc = InferenceService(_small_model(), device="cpu", start=False)
        assert (svc.max_batch_size, svc.buckets) == (16, (4, 16))
        svc.stop()
    finally:
        monkeypatch.delenv("BIGDL_TPU_SERVING_MAX_BATCH_SIZE")
        monkeypatch.delenv("BIGDL_TPU_SERVING_ROW_BUCKETS")
        reset_config()


def test_tuple_inputs_and_deferred_warmup():
    model = nn.Sequential().add(nn.CAddTable())
    svc = InferenceService(model, max_batch_size=4, device="cpu")
    a, b = _rows(3, shape=(2,)), _rows(3, seed=2, shape=(2,))
    out = svc.predict((a, b), timeout=60)
    np.testing.assert_array_equal(out, a + b)
    assert svc.compile_count == len(svc.buckets)
    assert svc.predict((a[:0], b[:0])).shape == (0, 2)
    with pytest.raises(RequestSpecError):
        svc.submit((a,))
    svc.stop()

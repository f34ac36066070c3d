"""ModelRegistry — named/versioned deployment of InferenceServices.

Port of ``bigdl_tpu/serving/registry.py``.  One registry hosts many
models, each behind its own :class:`InferenceService` (own queue, own
buckets, own stats), deployable from an in-memory module or straight
from a BigDL, Caffe, Torch7 or TensorFlow file (the loaders
``interop.convert_model`` uses), optionally int8-quantized by
``nn.quantized.quantize`` on the way in.

Every deployed version carries a :class:`CircuitBreaker`.  Latest-wins
routing consults it: ``breaker_trip_after`` consecutive request failures
on the newest version open its breaker, and un-versioned
``get``/``predict``/``submit`` calls fall back to the newest version
whose breaker still admits traffic.  Overload/closed rejections are never
counted.  Pinned ``version=`` requests bypass the breaker.  Breaker trips
and fallbacks land in the flight recorder (``Config.flight_recorder_path``
or ``flight=``), and the breakers are a ``/healthz`` source of the admin
plane (``Config.admin_port``).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.resilience.health import CircuitBreaker
from bigdl_tpu_torch.serving.batcher import ServiceClosed, ServiceOverloaded
from bigdl_tpu_torch.serving.service import InferenceService, resolve_device

logger = logging.getLogger("bigdl_tpu_torch.serving")


class ModelRegistry:
    """Thread-safe name → version → service map.

    ``deploy`` auto-increments the version per name (or takes an explicit
    one); ``get``/``predict`` default to the newest version.
    ``undeploy`` drains the service before dropping it.  Every service
    runs on ``device`` ("cuda" by default; "cpu" only when asked).
    """

    def __init__(self, *, breaker_trip_after: int = 5,
                 breaker_cooldown_s: float = 30.0, registry=None,
                 flight=None, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._services: Dict[Tuple[str, int], InferenceService] = {}
        self._latest: Dict[str, int] = {}  # guarded-by: _lock
        # keys mid-deploy (reserved before the slow warmup)
        self._pending: set[Tuple[str, int]] = set()  # guarded-by: _lock
        self._breaker_trip_after = int(breaker_trip_after)
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        # optional MetricRegistry for resilience/breaker_* counters
        self._metrics = registry
        # guarded-by: _lock
        self._breakers: Dict[Tuple[str, int], CircuitBreaker] = {}
        # flight recorder: None (inert) unless configured or passed
        from bigdl_tpu_torch.telemetry import flight as _flight_mod
        self._flight = flight if flight is not None \
            else _flight_mod.from_config()
        # admin plane: the breakers as a /healthz source (ok = none open)
        from bigdl_tpu_torch.telemetry import admin as _admin
        self._admin_name: Optional[str] = None
        srv = _admin.maybe_start()
        if srv is not None:
            self._admin_name = srv.unique_source_name("model_registry")
            srv.add_health(self._admin_name, self.breaker_health)

    # -- deployment --------------------------------------------------------
    def deploy(self, name: str, model=None, *, path: Optional[str] = None,
               format: Optional[str] = None, version: Optional[int] = None,
               params=None, state=None, quantize=False,
               prototxt: Optional[str] = None, weights=None,
               tf_inputs: Optional[List[str]] = None,
               tf_outputs: Optional[List[str]] = None,
               service=None, **service_kw) -> InferenceService:
        """Deploy ``model`` (or one loaded from ``path`` in ``format``:
        ``bigdl``, ``caffe`` with ``prototxt=``, ``torch``, ``tensorflow``
        with ``tf_inputs=``/``tf_outputs=``, ``keras`` (a Keras-1.2 JSON
        definition) with ``weights=``, a Keras HDF5 file or the arrays in
        Keras order) as ``name``:``version``, on the registry's device.
        ``service_kw`` flows to :class:`InferenceService` (``input_spec``
        for deploy-time warmup, batching/backpressure knobs,
        ``start=False``...).

        ``params=``/``state=``: weights in the reference's tree layout
        (nested dicts of arrays, ``interop.load_jax_params``), loaded into
        a copy of ``model`` so the caller's module is left as it was.

        ``service=``: register an already-built ``submit()``-shaped
        backend (a :class:`~bigdl_tpu_torch.serving.DecodeService`)
        under latest-wins and breaker routing instead of building an
        :class:`InferenceService`; hot cutover and undeploy work
        unchanged (they only need ``stop(drain=)``).  It excludes
        ``model``/``path``/``service_kw``.

        ``quantize``: False (default) deploys as-is; True int8-quantizes
        on the way in with the ``Config.int8_activation_mode`` default; a
        mode string (``"weight_only"`` / ``"dynamic"``) pins the mode.
        The quantized deploy is a distinct version with its own breaker
        and a ``weights_dtype`` stats tag."""
        if service is not None:
            if model is not None or path is not None or service_kw:
                raise ValueError(
                    "deploy(service=) takes a prebuilt backend — "
                    "model/path/service_kw don't apply")
        elif model is None:
            if path is None or format is None:
                raise ValueError("deploy() needs model= or path=+format=")
            from bigdl_tpu_torch.interop.convert_model import load_model
            # loaded on the CPU; the service moves it to self.device once
            model = load_model(format, path, prototxt=prototxt,
                               tf_inputs=tf_inputs, tf_outputs=tf_outputs,
                               weights=weights)
        if service is None and (params is not None or state is not None):
            import copy

            from bigdl_tpu_torch.interop.jax_weights import (load_jax_params,
                                                          to_jax_params)
            model = load_jax_params(copy.deepcopy(model).cpu(),
                                    params if params is not None
                                    else to_jax_params(model)[0], state)
        if service is None and quantize:
            from bigdl_tpu_torch.nn.quantized import quantize as _quantize
            model = _quantize(
                model, mode=quantize if isinstance(quantize, str) else None)
        # reserve the (name, version) key BEFORE the slow lock-free warmup:
        # two concurrent deploys must not pick the same auto-version
        with self._lock:
            if version is None:
                pending = [v for (n, v) in self._pending if n == name]
                version = max([self._latest.get(name, 0), *pending]) + 1
            key = (name, int(version))
            if key in self._services or key in self._pending:
                raise ValueError(
                    f"model {name!r} version {version} already deployed; "
                    "undeploy it first or bump the version")
            self._pending.add(key)  # acquires: deploy_reservation
        if service is None:
            try:
                service = InferenceService(
                    model, name=f"{name}:v{version}", device=self.device,
                    **service_kw)
            except BaseException:
                with self._lock:
                    self._pending.discard(key)  # releases: deploy_reservation
                raise
        with self._lock:
            self._pending.discard(key)  # releases: deploy_reservation
            self._services[key] = service
            self._breakers[key] = CircuitBreaker(
                trip_after=self._breaker_trip_after,
                cooldown_s=self._breaker_cooldown_s,
                registry=self._metrics, name=f"{name}:v{version}",
                recorder=self._flight)
            self._latest[name] = max(self._latest.get(name, 0),
                                     int(version))
        return service

    # -- lookup ------------------------------------------------------------
    # guarded-by: _lock
    def _resolve(self, name: str, version: Optional[int]) -> Tuple[str, int]:
        """Caller must hold ``self._lock``.  Latest-wins routing
        (``version=None``) takes the newest version whose breaker admits
        traffic; when every breaker is open, the newest anyway."""
        if version is None:
            if name not in self._latest:
                raise KeyError(f"no model {name!r} deployed; have "
                               f"{sorted(self._latest)}")
            newest = self._latest[name]
            version = newest
            for v in sorted((v for (n, v) in self._services if n == name),
                            reverse=True):
                brk = self._breakers.get((name, v))
                if brk is None or brk.allow():
                    version = v
                    break
            if version != newest:
                if self._metrics is not None:
                    self._metrics.counter(
                        "resilience/breaker_fallbacks").inc()
                if self._flight is not None:
                    self._flight.record(
                        "breaker_fallback", cat="resilience",
                        model=name, from_version=newest,
                        to_version=version)
                logger.warning(
                    "model %r v%d breaker open — routing to v%d",
                    name, newest, version)
        key = (name, int(version))
        if key not in self._services:
            have = sorted(v for (n, v) in self._services if n == name)
            raise KeyError(f"model {name!r} has no version {version}; "
                           f"deployed: {have}")
        return key

    def route(self, name: str, version: Optional[int] = None
              ) -> Tuple[int, InferenceService, Optional[CircuitBreaker]]:
        """``(resolved_version, service, breaker)`` for one request."""
        with self._lock:
            key = self._resolve(name, version)
            return key[1], self._services[key], self._breakers.get(key)

    @staticmethod
    def record_outcome(brk: Optional[CircuitBreaker],
                       exc: Optional[BaseException]) -> None:
        """Feed one request outcome to the served version's breaker;
        overload/closed rejections are not recorded."""
        if brk is None:
            return
        if exc is None:
            brk.record_success()
        elif not isinstance(exc, (ServiceOverloaded, ServiceClosed)):
            brk.record_failure()

    def latest_version(self, name: str) -> Optional[int]:
        """Newest deployed version of ``name`` (no breaker consult), or
        None when the name has no deployments: what a hot cutover reads
        before deploying, to know which version it must drain."""
        with self._lock:
            return self._latest.get(name)

    def get(self, name: str,
            version: Optional[int] = None) -> InferenceService:
        with self._lock:
            return self._services[self._resolve(name, version)]

    def predict(self, name: str, x, version: Optional[int] = None,
                timeout: Optional[float] = None):
        _v, svc, brk = self.route(name, version)
        try:
            out = svc.predict(x, timeout=timeout)
        except BaseException as e:
            self.record_outcome(brk, e)
            raise
        self.record_outcome(brk, None)
        return out

    def submit(self, name: str, x, version: Optional[int] = None):
        _v, svc, brk = self.route(name, version)
        fut = svc.submit(x)  # an overload raises here — never recorded
        # a cancelled future is no outcome at all
        fut.add_done_callback(
            lambda f, _b=brk: None if f.cancelled()
            else self.record_outcome(_b, f.exception()))
        return fut

    def breaker_state(self, name: str, version: int) -> dict:
        """Snapshot of one version's circuit breaker."""
        with self._lock:
            return self._breakers[(name, int(version))].snapshot()

    def breaker_health(self) -> dict:
        """The ``/healthz`` provider: every deployed version's breaker
        snapshot; ``ok`` = no breaker currently open."""
        with self._lock:
            breakers = dict(self._breakers)
        snaps = {f"{n}:v{v}": brk.snapshot()
                 for (n, v), brk in sorted(breakers.items())}
        return {"ok": not any(s["open"] for s in snaps.values()),
                "breakers": snaps}

    def list_models(self) -> Dict[str, List[int]]:
        with self._lock:
            out: Dict[str, List[int]] = {}
            for (n, v) in self._services:
                out.setdefault(n, []).append(v)
            return {n: sorted(vs) for n, vs in out.items()}

    # -- teardown ----------------------------------------------------------
    def undeploy(self, name: str, version: Optional[int] = None,
                 drain: bool = True) -> None:
        """Stop (drain by default) and drop one version — or every version
        of ``name`` when ``version`` is None."""
        with self._lock:
            if version is None:
                keys = [k for k in self._services if k[0] == name]
                if not keys:
                    raise KeyError(f"no model {name!r} deployed")
            else:
                keys = [self._resolve(name, version)]
            doomed = [self._services.pop(k) for k in keys]
            for k in keys:
                self._breakers.pop(k, None)
            remaining = [v for (n, v) in self._services if n == name]
            if remaining:
                self._latest[name] = max(remaining)
            else:
                self._latest.pop(name, None)
        for svc in doomed:
            svc.stop(drain=drain)

    def stats(self) -> Dict[str, dict]:
        """``{"name:vN": service-stats + breaker}`` across deployments."""
        with self._lock:
            services = dict(self._services)
            breakers = dict(self._breakers)
        return {f"{n}:v{v}": {**svc.stats(),
                              "breaker": breakers[(n, v)].snapshot()
                              if (n, v) in breakers else None}
                for (n, v), svc in sorted(services.items())}

    def stop_all(self, drain: bool = True) -> None:
        with self._lock:
            services = list(self._services.values())
            self._services.clear()
            self._breakers.clear()
            self._latest.clear()
        for svc in services:
            svc.stop(drain=drain)
        if self._admin_name is not None:
            from bigdl_tpu_torch.telemetry import admin as _admin
            srv = _admin.current()
            if srv is not None:
                srv.remove_source(self._admin_name)

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all(drain=True)

"""Per-tenant QoS admission: classes, token buckets, preemption ranks.

Reference: BigDL 2.0 Cluster Serving shares one cluster across tenants
through Redis queues (arXiv:2204.01715 §3.1) but has no admission
control; the TensorFlow-Serving lineage (arXiv:1605.08695 §4) treats
per-caller isolation as table stakes.  Here the wire frontend admits
every request through ONE :class:`QosAdmission`:

- **Tenants declare a QoS class** — ``"latency"`` (interactive SLO
  traffic) or ``"batch"`` (throughput backfill).  The class feeds the
  batcher's ``priority_fn`` (:meth:`QosAdmission.priority_fn`): under
  queue pressure (more rows queued than one dispatch carries — the
  existing queue-depth signal) latency-class requests preempt batch
  backlog in the coalescing order; under light load the hook is inert
  and order stays FIFO (``serving/batcher.RequestBatcher``).
- **Token-bucket rate limits** per tenant (``rate_rps`` requests/sec
  sustained, ``burst`` bucket depth).  An over-budget request is shed
  at ADMISSION — before it can occupy queue capacity — with
  :class:`TenantRateLimited` carrying ``retry_after_ms`` (when the
  bucket refills enough for one request), which the wire maps to HTTP
  429 + ``Retry-After`` exactly like a queue overload.
- **Per-tenant metrics** land in the shared
  :class:`~bigdl_tpu_torch.telemetry.registry.MetricRegistry` under
  ``serving/tenant=<t>/{requests,shed,failed}`` counters and a
  ``serving/tenant=<t>/latency_s`` histogram, so a ``/metrics`` scrape
  renders per-tenant quantiles with zero extra bookkeeping.  Tenant
  names are declared up front; undeclared tenants fold into the
  ``_other`` bucket (bounded metric cardinality — a caller cannot mint
  unbounded counter names by spamming ``X-Tenant`` headers).

Everything here is host-side bookkeeping — no device
work (the telemetry-package discipline).  Clocks are injectable so the
bucket math unit-tests without sleeping.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Iterable, Optional

from bigdl_tpu_torch.serving.batcher import ServiceOverloaded
from bigdl_tpu_torch.telemetry.registry import MetricRegistry

#: QoS classes, in preemption order (lower rank dispatches first)
LATENCY = "latency"
BATCH = "batch"
_RANKS = {LATENCY: 0, BATCH: 1}

#: metric-name bucket for tenants nobody declared (cardinality bound)
OTHER_TENANT = "_other"


class TenantRateLimited(ServiceOverloaded):
    """A tenant exceeded its declared token-bucket budget.  Subclasses
    :class:`~bigdl_tpu_torch.serving.ServiceOverloaded` so every existing
    shed path (HTTP 429 + ``Retry-After``, client backoff loops,
    breaker exemption — overloads are never poison evidence) applies
    unchanged; ``queue_depth``/``capacity`` report the bucket fill."""

    def __init__(self, tenant: str, retry_after_ms: Optional[float]):
        super().__init__(0, 0, model=f"tenant:{tenant}",
                         retry_after_ms=retry_after_ms)
        self.tenant = tenant


class UnknownTenantError(PermissionError):
    """Strict-mode admission refused an undeclared tenant (HTTP 403)."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One declared tenant: QoS class + rate budget.

    ``rate_rps <= 0`` means unlimited (no bucket is even consulted);
    ``burst`` is the bucket depth — how far above the sustained rate a
    tenant may spike before shedding (default: one second's worth of
    budget, at least 1 request).
    """

    name: str
    qos_class: str = LATENCY
    rate_rps: float = 0.0
    burst: Optional[float] = None

    def __post_init__(self):
        if self.qos_class not in _RANKS:
            raise ValueError(
                f"tenant {self.name!r}: qos_class must be "
                f"'{LATENCY}' or '{BATCH}', got {self.qos_class!r}")
        if self.burst is not None and self.burst < 1:
            raise ValueError(
                f"tenant {self.name!r}: burst must be >= 1")

    @property
    def rank(self) -> int:
        return _RANKS[self.qos_class]

    @property
    def bucket_depth(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        return max(1.0, float(self.rate_rps))


class TokenBucket:
    """Classic token bucket: ``depth`` tokens max, refilled at ``rate``
    tokens/sec.  ``try_take`` returns None on success or the
    milliseconds until one token is available (the retry-after hint).
    Thread-safe; ``clock`` injectable for deterministic tests."""

    def __init__(self, rate: float, depth: float, clock=time.monotonic):
        self.rate = float(rate)
        self.depth = float(depth)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.depth          # guarded-by: _lock
        self._t_last = self._clock()       # guarded-by: _lock

    def try_take(self, n: float = 1.0,
                 now: Optional[float] = None) -> Optional[float]:
        with self._lock:
            # clock read INSIDE the lock, and _t_last only moves
            # forward: two concurrent admits reading the clock outside
            # could commit their refills out of order, rewinding
            # _t_last and re-crediting already-spent refill time (a
            # tenant could sustainably exceed its declared rate)
            if now is None:
                now = self._clock()
            if now > self._t_last:
                self._tokens = min(
                    self.depth,
                    self._tokens + (now - self._t_last) * self.rate)
                self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return None
            deficit = n - self._tokens
            return round(deficit / self.rate * 1e3, 1)

    def tokens(self, now: Optional[float] = None) -> float:
        """Current fill (refilled to ``now``) — tests/dashboards."""
        with self._lock:
            if now is None:
                now = self._clock()
            elapsed = max(0.0, now - self._t_last)
            return min(self.depth, self._tokens + elapsed * self.rate)


class QosAdmission:
    """The frontend's per-tenant admission gate + metrics ledger.

    Parameters
    ----------
    tenants:
        Iterable of :class:`TenantSpec` (or plain dicts with the same
        fields).  Undeclared tenants are admitted with ``default``'s
    class/budget and metered under the ``_other`` bucket — unless
        ``strict=True``, where they are refused
        (:class:`UnknownTenantError` → HTTP 403 at the wire).  Strict
        refuses TENANTLESS requests (no ``X-Tenant`` header) too:
        omitting the header is not a way around the gate.
    default:
        The :class:`TenantSpec` applied to undeclared tenants and to
        tenantless requests (no ``X-Tenant`` header) when ``strict``
        is off.  Defaults to an unlimited latency-class spec.
    registry:
        The :class:`MetricRegistry` per-tenant counters land in (the
        frontend shares its own, so one ``/metrics`` page carries wire
        + tenant series).  A fresh registry is minted when omitted.
    clock:
        Injectable monotonic clock shared by every bucket.
    """

    def __init__(self, tenants: Iterable = (), *,
                 default: Optional[TenantSpec] = None,
                 strict: bool = False,
                 registry: Optional[MetricRegistry] = None,
                 clock=time.monotonic):
        self.registry = (registry if registry is not None
                         else MetricRegistry())
        self.strict = bool(strict)
        self.default = default if default is not None \
            else TenantSpec("default")
        self._clock = clock
        self._specs: Dict[str, TenantSpec] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        for t in tenants:
            if isinstance(t, dict):
                t = TenantSpec(**t)
            if t.name in self._specs:
                raise ValueError(f"tenant {t.name!r} declared twice")
            self._specs[t.name] = t
            if t.rate_rps > 0:
                self._buckets[t.name] = TokenBucket(
                    t.rate_rps, t.bucket_depth, clock=clock)
        # one SHARED bucket meters all undeclared/tenantless traffic
        # when the default spec carries a budget (per-unknown-name
        # buckets would let a caller dodge the limit by rotating names)
        self._default_bucket = (
            TokenBucket(self.default.rate_rps,
                        self.default.bucket_depth, clock=clock)
            if self.default.rate_rps > 0 else None)
        # counters pre-created for every DECLARED tenant plus _other so
        # a zero-traffic scrape still shows the full tenant schema
        for name in (*self._specs, OTHER_TENANT):
            for c in ("requests", "shed", "failed"):
                self.registry.counter(f"serving/tenant={name}/{c}")

    # -- lookup ------------------------------------------------------------
    def spec(self, tenant: Optional[str]) -> TenantSpec:
        if tenant is None:
            return self.default
        return self._specs.get(tenant, self.default)

    def _metric_tenant(self, tenant: Optional[str]) -> str:
        """Metric-name bucket: declared tenants keep their name,
        everything else (incl. tenantless) folds into ``_other`` so
        arbitrary ``X-Tenant`` headers cannot mint unbounded series."""
        if tenant is not None and tenant in self._specs:
            return tenant
        return OTHER_TENANT

    # -- admission ---------------------------------------------------------
    def admit(self, tenant: Optional[str],
              now: Optional[float] = None) -> TenantSpec:
        """Admission verdict for one wire request.  Returns the
        tenant's spec on success; raises :class:`TenantRateLimited`
        (shed — counted) or, under ``strict``,
        :class:`UnknownTenantError` for undeclared AND tenantless
        requests."""
        mt = self._metric_tenant(tenant)
        if self.strict and tenant not in self._specs:
            # tenantless requests are refused too: omitting X-Tenant
            # must not be a cheaper path through a strict gate than
            # sending an undeclared one.  The message never enumerates
            # declared tenant names — X-Tenant is a tag, not a
            # credential, so listing valid tags on a 403 would hand an
            # unauthenticated caller the exact bypass for the gate
            if tenant is None:
                raise UnknownTenantError(
                    "request carries no tenant and admission is "
                    "strict — send X-Tenant with a declared tenant")
            raise UnknownTenantError(
                f"tenant {tenant!r} is not declared and admission is "
                f"strict")
        spec = self.spec(tenant)
        if tenant is not None and tenant in self._specs:
            # declared: its own bucket, or None when unlimited
            bucket = self._buckets.get(tenant)
        else:
            bucket = self._default_bucket
        if bucket is not None:
            wait_ms = bucket.try_take(1.0, now=now)
            if wait_ms is not None:
                self.registry.counter(
                    f"serving/tenant={mt}/shed").inc()
                raise TenantRateLimited(tenant, wait_ms)
        self.registry.counter(f"serving/tenant={mt}/requests").inc()
        return spec

    def record_result(self, tenant: Optional[str], latency_s: float,
                      ok: bool) -> None:
        """Per-tenant completion bookkeeping (the wire calls this once
        per request, shed requests excluded — those counted at
        admission)."""
        mt = self._metric_tenant(tenant)
        if not ok:
            self.registry.counter(f"serving/tenant={mt}/failed").inc()
        self.registry.histogram(
            f"serving/tenant={mt}/latency_s").observe(latency_s)

    # -- batcher hook ------------------------------------------------------
    def priority_fn(self, req) -> int:
        """The ``RequestBatcher`` preemption hook: rank of one queued
        ``_Request`` from its context's tenant tag (no context / no
        tenant → the default spec's class).  Wiring is the deploy
        owner's job: pass ``priority_fn=qos.priority_fn`` when
        constructing the ``InferenceService`` / ``ReplicaSet`` (or via
        ``ModelRegistry.deploy(..., priority_fn=...)``) — the
        ``FrontendServer`` does not own deploys and cannot inject it."""
        ctx = getattr(req, "ctx", None)
        tenant = getattr(ctx, "tenant", None) if ctx is not None \
            else None
        return self.spec(tenant).rank

    def snapshot(self) -> dict:
        """JSON-able view for dashboards/tests."""
        now = self._clock()
        return {
            "strict": self.strict,
            "tenants": {
                name: {"qos_class": s.qos_class,
                       "rate_rps": s.rate_rps,
                       "tokens": (round(self._buckets[name].tokens(now), 3)
                                  if name in self._buckets else None)}
                for name, s in sorted(self._specs.items())},
            "default": {"qos_class": self.default.qos_class,
                        "rate_rps": self.default.rate_rps},
        }

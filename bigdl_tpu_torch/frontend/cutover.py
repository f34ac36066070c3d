"""Drain-free hot version cutover: deploy under load, drop nothing.

Port of ``bigdl_tpu/frontend/cutover.py`` (an owned copy).
Latest-wins routing consults per-version circuit breakers, and
``ModelRegistry.undeploy(drain=True)`` drains a service's own queue —
but nothing coordinated the WIRE: a wire request that resolved version
N (and pinned it for a multi-chunk stream) could lose its service to an
undeploy racing the exchange.  :class:`HotCutover` sequences a deploy
so that never happens:

1. **Warm before flip.**  ``registry.deploy`` runs every row bucket's
   warmup forward inside the service constructor and only then inserts
   the new version into latest-wins routing — version N keeps serving
   the whole time.  When the
   caller passes no ``input_spec``, the incumbent's warmed row spec is
   reused so the new version never warms on live traffic.
2. **Flip.**  The instant the deploy lands, new wire requests resolve
   N+1 (``FrontendServer`` pins the resolved version per exchange).
3. **Drain the wire.**  ``frontend.drain_version(name, N)`` blocks
   until zero wire requests are still pinned to N — including
   mid-stream chunked predicts.
4. **Drain the queue, then drop.**  ``registry.undeploy(name, N,
   drain=True)`` lets version N's batcher finish every accepted
   in-process request before the service stops.

The zero-dropped-requests guarantee is gated in
``tests/test_torch_frontend.py`` (hot deploys under sustained wire load,
every accepted request resolves correctly).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger("bigdl_tpu_torch.frontend")


class CutoverDrainTimeout(RuntimeError):
    """Wire connections to the outgoing version did not drain inside
    the budget; the old version was NOT undeployed (it keeps serving
    its stragglers — retry or undeploy manually)."""


class HotCutover:
    """Deploy coordinator over a :class:`~bigdl_tpu_torch.serving.
    ModelRegistry` and (optionally) the :class:`~bigdl_tpu_torch.frontend.
    FrontendServer` in front of it.

    Without a frontend the wire-drain step is skipped (there is no
    wire) and the cutover degrades to warm-deploy + queue-drain — the
    in-process contract the registry already keeps.
    """

    def __init__(self, registry, frontend=None, *,
                 drain_timeout_s: float = 30.0):
        self.registry = registry
        self.frontend = frontend
        self.drain_timeout_s = float(drain_timeout_s)

    def deploy(self, name: str, model=None, *,
               undeploy_old: bool = True,
               drain_timeout_s: Optional[float] = None,
               **deploy_kw) -> dict:
        """Hot-deploy ``model`` as the next version of ``name`` (all
        ``ModelRegistry.deploy`` kwargs pass through) and retire the
        incumbent without dropping a request.  Returns a report dict
        (old/new versions, warmup + drain seconds, whether the old
        version was undeployed)."""
        timeout = (self.drain_timeout_s if drain_timeout_s is None
                   else float(drain_timeout_s))
        old = self.registry.latest_version(name)
        if old is not None and "input_spec" not in deploy_kw \
                and "service" not in deploy_kw:
            # (a prebuilt `service=` deploy owns its own warmup — an
            # inherited input_spec doesn't apply to it)
            # reuse the incumbent's warmed row spec so the new version
            # warms at deploy instead of on live traffic
            spec = self.registry.get(name, old).row_spec
            if spec is not None:
                deploy_kw["input_spec"] = spec
        t0 = time.monotonic()
        self.registry.deploy(name, model, **deploy_kw)
        warmup_s = time.monotonic() - t0
        new = self.registry.latest_version(name)
        report = {"model": name, "old_version": old,
                  "new_version": new,
                  "warmup_s": round(warmup_s, 4),
                  "wire_drained": None, "wire_drain_s": None,
                  "old_undeployed": False}
        if old is None:
            return report  # first deploy: nothing to drain
        t1 = time.monotonic()
        if self.frontend is not None:
            drained = self.frontend.drain_version(name, old,
                                                  timeout=timeout)
            report["wire_drained"] = drained
            report["wire_drain_s"] = round(time.monotonic() - t1, 4)
            if not drained:
                # the old version still carries live wire exchanges —
                # dropping it now would break the zero-drop guarantee,
                # so it stays deployed (new traffic already routes to
                # the new version)
                raise CutoverDrainTimeout(
                    f"{name}:v{old} still has "
                    f"{self.frontend.inflight.count((name, old))} wire "
                    f"request(s) in flight after {timeout:.1f}s; old "
                    f"version left deployed")
        if undeploy_old:
            # queue-drain inside: every accepted in-process request on
            # the old version resolves before its batcher stops
            self.registry.undeploy(name, old, drain=True)
            report["old_undeployed"] = True
        logger.info("hot cutover %s: v%s -> v%s (warmup %.3fs, wire "
                    "drain %s)", name, old, new,
                    warmup_s, report["wire_drain_s"])
        return report

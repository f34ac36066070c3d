"""Request-scoped trace context — the wire-level observability unit.

Port of ``bigdl_tpu/telemetry/context.py`` (stdlib only, an owned copy).

PR 6 made the *process* observable (step timeline, one metric
registry); nothing was *request*-scoped: when the ReplicaSet fails a
request over or a breaker reroutes a deploy, there is no way to answer
"what happened to request X".  A :class:`RequestContext` is minted at
``submit()`` (or supplied by the caller — the future RPC front end of
ROADMAP item 1 will mint it from wire headers) and travels WITH the
request through the batcher queue, the coalesced dispatch, and every
ReplicaSet failover hop:

- ``trace_id`` correlates the request across the tracer (span args +
  Chrome flow events fanning N coalesced request spans into their one
  dispatch span), the flight recorder (failover/quarantine events carry
  it), and whatever the caller logs;
- ``hops`` is the request's routing history — one entry per replica
  attempt, outcome stamped at completion — so a failed-over request
  carries its full story ("r0: ReplicaDeadError → r2: ok");
- ``tenant`` tags the submitting principal (admission control / QoS
  classes build on this — ROADMAP item 1c);
- ``deadline`` mirrors the request deadline already propagated by the
  serving queue (monotonic seconds; the context never *enforces* it —
  the batcher does — it only records it for the post-mortem).

Inertness contract (house discipline): with ``Config.request_tracing``
off and no explicit context passed, NO context object is ever
allocated — every call site guards on ``ctx is not None``, so the off
path is byte-identical to the pre-context engine (gated in
``tests/test_torch_resilience.py``).  Everything here is host-side
bookkeeping: no device work, no syncs.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Dict, List, Optional

# process-unique trace-id prefix + a monotone counter: unique across
# processes (pid + start-time entropy from the clock) without touching
# any RNG — ids must be mintable from any thread at request rate.  The
# counter keeps 32 bits (4.3e9 mints per process before wrapping — far
# beyond any process lifetime at request rate; a 16-bit counter would
# recycle ids within minutes under bench-level load and silently merge
# two requests' stories in obs_report)
_PREFIX = f"{os.getpid() & 0xffff:04x}{(time.time_ns() >> 10) & 0xffff:04x}"
_LOCK = threading.Lock()
_SEQ = itertools.count(1)  # guarded-by: _LOCK


def new_trace_id() -> str:
    """16-hex-char id — pid(4) + start-time(4) + counter(8) hex —
    unique within a process for 2**32 mints and (practically) across
    processes; cheap enough to mint per request."""
    with _LOCK:
        n = next(_SEQ)
    return f"{_PREFIX}{n & 0xffffffff:08x}"


def flow_id(trace_id: str) -> int:
    """Chrome-trace flow-event id for a trace id (positive int63 —
    Perfetto binds ``s``/``f`` events sharing this id into one arrow)."""
    return int(trace_id, 16) & 0x7FFFFFFFFFFFFFFF


class RequestContext:
    """Per-request trace context (see module docstring).

    Mutable by design: the router appends ``hops`` as it retries, and
    the dispatch path stamps the coalesced bucket — the caller that
    kept a reference reads the full story after the future resolves.
    """

    __slots__ = ("trace_id", "tenant", "deadline", "parent", "hops",
                 "t_minted")

    def __init__(self, trace_id: Optional[str] = None,
                 tenant: Optional[str] = None,
                 deadline: Optional[float] = None,
                 parent: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.tenant = tenant
        self.deadline = deadline
        self.parent = parent  # parent span/trace id (RPC propagation)
        self.hops: List[Dict] = []
        self.t_minted = time.monotonic()

    @property
    def flow_id(self) -> int:
        return flow_id(self.trace_id)

    def add_hop(self, replica: int, probe: bool = False) -> Dict:
        """Record one routing attempt; the returned dict is stamped
        with ``outcome`` at completion ("ok" / exception name)."""
        hop = {"replica": int(replica), "probe": bool(probe),
               "outcome": None}
        self.hops.append(hop)
        return hop

    def snapshot(self) -> dict:
        """JSON-able view (what the flight recorder / obs_report see)."""
        return {"trace_id": self.trace_id, "tenant": self.tenant,
                "parent": self.parent, "hops": [dict(h) for h in self.hops]}

    def __repr__(self) -> str:
        hops = ",".join(
            f"r{h['replica']}:{h['outcome'] or '?'}" for h in self.hops)
        return (f"RequestContext({self.trace_id}"
                + (f", tenant={self.tenant!r}" if self.tenant else "")
                + (f", hops=[{hops}]" if hops else "") + ")")

"""Deterministic, seeded fault injection.

Port of ``bigdl_tpu/resilience/faults.py``: the same grammar, clauses
and draws, so a plan fires at exactly the reference's event indices.

Reference: the TensorFlow system paper's position that failures are
*expected events with designed-in recovery*, not exceptions
(arXiv:1605.08695 §4.4), and BigDL 2.0 Cluster Serving's per-replica
failure isolation (arXiv:2204.01715 §3.3).  A recovery path that is only
exercised by real outages is an untested path — this module makes every
degradation scenario in the stack reproducible on demand, so the
self-healing serving layer and the driver's numeric guard are gated by
tests instead of hand-checked during incidents.

Design rules (house style — the telemetry/checkpoint inertness
discipline applied to chaos):

- **Provably inert when off.**  ``FaultInjector.from_config()`` returns
  ``None`` for an empty ``Config.fault_plan`` — every call site guards
  on ``injector is not None``, so the disabled path executes byte-
  identical code (bitwise loss sequences, unchanged dispatch counts,
  serving outputs bitwise-equal to direct ``model.apply``; gated in
  ``tests/test_torch_resilience.py``).
- **Deterministic given (plan, seed).**  Probabilistic clauses draw from
  ``np.random.default_rng((seed, clause_ix, index))`` — a pure function
  of the event index, never of wall clock or arrival order, so a flaky
  repro can be replayed exactly.
- **Scoped.**  Every clause can be pinned to an event index window
  (``at``/``after``/``until``/``every``), a firing budget (``count``), a
  replica (``target``) and a probability (``p``).

Plan grammar (``Config.fault_plan`` / ``BIGDL_TPU_FAULT_PLAN``)::

    plan   := clause (";" clause)*
    clause := kind ["@" key "=" val ("," key "=" val)*]
    kind   := dispatch_error    -- raise InjectedFault at a dispatch
            | dispatch_delay    -- sleep ms= before a dispatch (straggler)
            | replica_death     -- kill the serving replica's batcher
                                   thread (a BaseException escapes the
                                   dispatch error handler, exactly like
                                   a real thread crash)
            | corrupt_batch     -- NaN-poison the staged training batch
            | nonfinite_grads   -- Inf-poison the staged training batch
                                   (overflows forward/backward)
            | resize            -- open a graceful membership epoch
                                   shrinking/regrowing the world to to=
            | host_loss         -- preemption warning: graceful shrink
                                   (default to= half the world)
            | device_loss       -- abrupt device loss: shrink with the
                                   in-flight block abandoned
                                   (default to= world - 1)
    keys   := at | after | until | every | count | target | p | ms | to
            | where (serving|driver — dispatch_* kinds only;
                     default serving)

Event indices: serving clauses fire on a replica's own dispatch counter;
driver ``dispatch_*@where=driver`` clauses fire on the driver's dispatch
counter; batch kinds AND membership kinds fire on the global iteration
number (so ``corrupt_batch@at=7`` poisons exactly iteration 7's
microbatch, and ``resize@at=7,to=2`` opens the shrink epoch the moment
step 7 is replayed).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised on purpose by the injector (transient by
    construction — retry/failover paths treat it like any dispatch
    error)."""


class ReplicaDeathFault(BaseException):
    """Kills the batcher thread it is raised on.  Deliberately NOT an
    ``Exception``: the serving dispatch wrapper resolves futures for any
    ``Exception``, and a replica death must instead strand them exactly
    the way a real thread crash does (the failure mode ``ReplicaSet``'s
    supervisor exists to detect)."""


_SERVING_KINDS = ("dispatch_error", "dispatch_delay", "replica_death")
_BATCH_KINDS = ("corrupt_batch", "nonfinite_grads")
_MEMBERSHIP_KINDS = ("resize", "host_loss", "device_loss")
KINDS = _SERVING_KINDS + _BATCH_KINDS + _MEMBERSHIP_KINDS

_INT_KEYS = ("at", "after", "until", "every", "count", "target", "to")
_FLOAT_KEYS = ("p", "ms")
_STR_KEYS = ("where",)


class FaultClause:
    """One parsed clause.  ``fired`` is the mutable firing budget
    counter — host-side state, serialized by the injector lock."""

    __slots__ = ("kind", "at", "after", "until", "every", "count",
                 "target", "p", "ms", "to", "where", "fired")

    def __init__(self, kind: str, **keys):
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; kinds: {KINDS}")
        self.kind = kind
        self.at = keys.pop("at", None)
        self.after = keys.pop("after", None)
        self.until = keys.pop("until", None)
        self.every = keys.pop("every", None)
        self.count = keys.pop("count", None)
        self.target = keys.pop("target", None)
        self.p = float(keys.pop("p", 1.0))
        self.ms = float(keys.pop("ms", 10.0))
        self.to = keys.pop("to", None)
        self.where = keys.pop("where", "serving")
        self.fired = 0
        if keys:
            raise ValueError(
                f"unknown fault key(s) {sorted(keys)} for {kind!r}; "
                f"keys: {_INT_KEYS + _FLOAT_KEYS + _STR_KEYS}")
        if self.where not in ("serving", "driver"):
            raise ValueError(
                f"where= must be serving|driver, got {self.where!r}")
        if kind in _BATCH_KINDS + _MEMBERSHIP_KINDS \
                and self.where == "serving":
            # batch and membership kinds only exist in the driver
            self.where = "driver"
        if self.to is not None and kind not in _MEMBERSHIP_KINDS:
            raise ValueError(
                f"to= only applies to membership kinds "
                f"{_MEMBERSHIP_KINDS}, not {kind!r}")
        if kind == "resize" and (self.to is None or self.to < 1):
            raise ValueError(
                "resize needs an explicit target world: to=<n> >= 1")
        if kind in _MEMBERSHIP_KINDS and self.count is None:
            # one membership event per clause unless asked otherwise:
            # an elastic restore REWINDS the step counter, and a
            # budget-less at= clause would re-fire on every replay
            # crossing (a default-to device_loss would then shrink the
            # roster again each pass — a runaway)
            self.count = 1
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p= must be in [0, 1], got {self.p}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every= must be >= 1, got {self.every}")

    def matches(self, index: int, replica: Optional[int]) -> bool:
        """Window/target predicate — pure function of (index, replica),
        no side effects (the firing-budget check lives in the injector
        under its lock)."""
        if self.target is not None and replica != self.target:
            return False
        if self.at is not None and index != self.at:
            return False
        if self.after is not None and index < self.after:
            return False
        if self.until is not None and index >= self.until:
            return False
        if self.every is not None and index % self.every != 0:
            return False
        return True

    def describe(self) -> str:
        keys = []
        for k in _INT_KEYS + _FLOAT_KEYS + _STR_KEYS:
            v = getattr(self, k)
            if v is not None and not (k == "p" and v == 1.0) \
                    and not (k == "ms" and v == 10.0) \
                    and not (k == "where" and v == "serving"):
                keys.append(f"{k}={v}")
        return self.kind + ("@" + ",".join(keys) if keys else "")


def parse_fault_plan(plan: str) -> List[FaultClause]:
    """Parse the plan grammar (module docstring).  Loud on anything
    unknown — a typo'd chaos plan that silently injects nothing would
    report a recovery path as tested when it never ran."""
    clauses: List[FaultClause] = []
    for raw in (plan or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        kind, _, argstr = raw.partition("@")
        kind = kind.strip()
        keys = {}
        if argstr:
            for tok in argstr.split(","):
                k, eq, v = tok.partition("=")
                k = k.strip()
                if not eq:
                    raise ValueError(
                        f"fault clause {raw!r}: expected key=value, "
                        f"got {tok!r}")
                if k in _INT_KEYS:
                    keys[k] = int(v)
                elif k in _FLOAT_KEYS:
                    keys[k] = float(v)
                elif k in _STR_KEYS:
                    keys[k] = v.strip()
                else:
                    raise ValueError(
                        f"fault clause {raw!r}: unknown key {k!r}; "
                        f"keys: {_INT_KEYS + _FLOAT_KEYS + _STR_KEYS}")
        clauses.append(FaultClause(kind, **keys))
    return clauses


class FaultInjector:
    """Evaluates a parsed fault plan at instrumented sites.

    One injector may be shared by many threads (every serving replica's
    batcher polls it); the firing-budget bookkeeping is behind one lock.
    Injected events are counted into the attached
    :class:`~bigdl_tpu_torch.telemetry.registry.MetricRegistry` as
    ``resilience/fault_<kind>`` counters so a chaos run's injected load
    is auditable next to the recovery metrics it provoked.
    """

    def __init__(self, plan: str, seed: int = 0, registry=None):
        self.plan = plan
        self.seed = int(seed)
        self.clauses = parse_fault_plan(plan)
        self._lock = threading.Lock()
        self._registry = registry

    @classmethod
    def from_config(cls, registry=None) -> Optional["FaultInjector"]:
        """``None`` (the provably-inert state) unless ``Config.
        fault_plan`` / ``BIGDL_TPU_FAULT_PLAN`` names a plan."""
        from bigdl_tpu_torch.utils.config import get_config
        cfg = get_config()
        if not cfg.fault_plan:
            return None
        return cls(cfg.fault_plan, seed=cfg.fault_seed, registry=registry)

    def attach_registry(self, registry) -> None:
        self._registry = registry

    # ----------------------------------------------------------- firing
    def _fires(self, clause_ix: int, clause: FaultClause, index: int,
               replica: Optional[int]) -> bool:
        if not clause.matches(index, replica):
            return False
        if clause.p < 1.0:
            # deterministic: a pure function of (seed, clause, index) —
            # replayable regardless of thread interleaving
            r = np.random.default_rng(
                (self.seed, clause_ix, index)).random()
            if r >= clause.p:
                return False
        with self._lock:
            if clause.count is not None and clause.fired >= clause.count:
                return False
            clause.fired += 1
        if self._registry is not None:
            self._registry.counter(
                f"resilience/fault_{clause.kind}").inc()
        return True

    def _firing(self, kinds: Sequence[str], where: str, index: int,
                replica: Optional[int] = None) -> List[FaultClause]:
        return [c for ix, c in enumerate(self.clauses)
                if c.kind in kinds and c.where == where
                and self._fires(ix, c, index, replica)]

    # ------------------------------------------------------------ sites
    def serving_dispatch(self, index: int,
                         replica: Optional[int] = None) -> None:
        """Site: a serving replica's dispatch, keyed by that replica's
        own dispatch counter.  Delays apply first (a straggler can also
        die), then errors, then death."""
        fired = self._firing(_SERVING_KINDS, "serving", index, replica)
        for c in fired:
            if c.kind == "dispatch_delay":
                time.sleep(c.ms / 1e3)
        for c in fired:
            if c.kind == "dispatch_error":
                raise InjectedFault(
                    f"injected serving dispatch error "
                    f"(replica={replica}, dispatch={index})")
        for c in fired:
            if c.kind == "replica_death":
                raise ReplicaDeathFault(
                    f"injected replica death (replica={replica}, "
                    f"dispatch={index})")

    def driver_dispatch(self, index: int) -> None:
        """Site: the training driver's jit dispatch, keyed by the
        driver's dispatch counter (``dispatch_*@where=driver``)."""
        fired = self._firing(("dispatch_error", "dispatch_delay"),
                             "driver", index)
        for c in fired:
            if c.kind == "dispatch_delay":
                time.sleep(c.ms / 1e3)
        for c in fired:
            if c.kind == "dispatch_error":
                raise InjectedFault(
                    f"injected driver dispatch error (dispatch={index})")

    def batch_kinds(self, step: int) -> List[str]:
        """Site: one staged training microbatch, keyed by its global
        iteration number.  Returns the poison kinds firing at ``step``."""
        return [c.kind
                for c in self._firing(_BATCH_KINDS, "driver", step)]

    def has_membership_kinds(self) -> bool:
        """Whether the plan contains any ``resize``/``host_loss``/
        ``device_loss`` clause — the driver arms a
        :class:`~bigdl_tpu_torch.resilience.membership.ClusterMembership`
        only then (plan without them stays membership-free)."""
        return any(c.kind in _MEMBERSHIP_KINDS for c in self.clauses)

    def membership_events(self, step: int) -> List[FaultClause]:
        """Site: the driver's replayed iteration, keyed by the global
        iteration number.  Returns the membership clauses firing at
        ``step`` (the driver translates them into
        ``ClusterMembership`` signals — this module stays free of any
        roster knowledge)."""
        return self._firing(_MEMBERSHIP_KINDS, "driver", step)

    def corrupt_staged(self, xs, first_step: int, k: int):
        """Poison the floating leaves of a staged K-step block for every
        step whose batch-kind clause fires (``corrupt_batch`` → NaN,
        ``nonfinite_grads`` → Inf): step ``j``'s slice of each floating
        leaf is filled in place, on the block's own device, with no host
        copy.  Integer leaves (token ids) are left alone.  The caller
        makes its stream wait for the block's copy first.  Only ever
        reached when a plan is live, so the off path stays
        byte-identical.  Returns ``xs``."""
        from bigdl_tpu_torch.dataset.prefetch import tree_map
        for j in range(k):
            kinds = self.batch_kinds(first_step + j)
            if not kinds:
                continue
            bad = float("nan") if "corrupt_batch" in kinds else float("inf")

            def poison(a, _j=j, _bad=bad):
                if a.is_floating_point():
                    a[_j].fill_(_bad)
                return a

            tree_map(poison, xs)
        return xs

    def describe(self) -> str:
        return "; ".join(c.describe() for c in self.clauses)

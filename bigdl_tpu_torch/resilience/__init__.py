"""bigdl_tpu_torch.resilience — designed-in failure handling (port of
``bigdl_tpu/resilience``).

- :mod:`~bigdl_tpu_torch.resilience.faults` — seeded, scoped, inert-when-
  off fault injection (``Config.fault_plan`` / ``BIGDL_TPU_FAULT_PLAN``);
- :mod:`~bigdl_tpu_torch.resilience.replica_set` — self-healing
  replica-per-device serving: least-queue-depth routing, per-replica
  health quarantine and probation (``health.py``), deadlines, bounded
  failover retry, load shedding with retry-after; imported lazily, so
  training-only processes never pay the serving import;
- :mod:`~bigdl_tpu_torch.resilience.health` — the per-replica state
  machine and the model-version ``CircuitBreaker`` of the registry's
  routing;
- :mod:`~bigdl_tpu_torch.resilience.numeric` — the training driver's
  non-finite loss/gradient policies (``skip`` | ``rollback`` |
  ``abort``) riding the one-block-behind fetch;
- :mod:`~bigdl_tpu_torch.resilience.membership` — monotonic membership
  epochs under elastic training, imported lazily (it only exists on
  elastic runs).
"""

from bigdl_tpu_torch.resilience.faults import (FaultClause, FaultInjector,
                                               InjectedFault,
                                               ReplicaDeathFault,
                                               parse_fault_plan)
from bigdl_tpu_torch.resilience.health import (CircuitBreaker, HealthPolicy,
                                               ReplicaHealth)
from bigdl_tpu_torch.resilience.numeric import (NUMERIC_POLICIES,
                                                NonFiniteStepError)

__all__ = [
    "FaultClause", "FaultInjector", "InjectedFault", "ReplicaDeathFault",
    "parse_fault_plan", "CircuitBreaker", "HealthPolicy", "ReplicaHealth",
    "NUMERIC_POLICIES", "NonFiniteStepError", "ReplicaSet",
    "ReplicaDeadError", "ClusterMembership", "MembershipChanged",
    "MembershipEpoch",
]

_LAZY = {"ReplicaSet", "ReplicaDeadError"}
_LAZY_MEMBERSHIP = {"ClusterMembership", "MembershipChanged",
                    "MembershipEpoch"}


def __getattr__(name):
    if name in _LAZY:
        from bigdl_tpu_torch.resilience import replica_set
        return getattr(replica_set, name)
    if name in _LAZY_MEMBERSHIP:
        from bigdl_tpu_torch.resilience import membership
        return getattr(membership, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

"""bigdl_tpu_torch.resilience — designed-in failure handling (port of
``bigdl_tpu/resilience``).

- :mod:`~bigdl_tpu_torch.resilience.faults` — seeded, scoped, inert-when-
  off fault injection (``Config.fault_plan`` / ``BIGDL_TPU_FAULT_PLAN``);
- :mod:`~bigdl_tpu_torch.resilience.health` — the model-version
  ``CircuitBreaker`` of the registry's routing;
- :mod:`~bigdl_tpu_torch.resilience.numeric` — the training driver's
  non-finite loss/gradient policies (``skip`` | ``rollback`` |
  ``abort``) riding the one-block-behind fetch;
- :mod:`~bigdl_tpu_torch.resilience.membership` — monotonic membership
  epochs under elastic training, imported lazily (it only exists on
  elastic runs).

The replica set (``ReplicaSet``, ``HealthPolicy``, ``ReplicaHealth``)
comes with the rest of serving.
"""

from bigdl_tpu_torch.resilience.faults import (FaultClause, FaultInjector,
                                               InjectedFault,
                                               ReplicaDeathFault,
                                               parse_fault_plan)
from bigdl_tpu_torch.resilience.health import CircuitBreaker
from bigdl_tpu_torch.resilience.numeric import (NUMERIC_POLICIES,
                                                NonFiniteStepError)

__all__ = [
    "FaultClause", "FaultInjector", "InjectedFault", "ReplicaDeathFault",
    "parse_fault_plan", "CircuitBreaker", "NUMERIC_POLICIES",
    "NonFiniteStepError", "ClusterMembership", "MembershipChanged",
    "MembershipEpoch",
]

_LAZY_MEMBERSHIP = {"ClusterMembership", "MembershipChanged",
                    "MembershipEpoch"}


def __getattr__(name):
    if name in _LAZY_MEMBERSHIP:
        from bigdl_tpu_torch.resilience import membership
        return getattr(membership, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

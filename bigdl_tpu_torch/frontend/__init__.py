"""bigdl_tpu_torch.frontend — the wire-level serving front end.

Port of ``bigdl_tpu/frontend`` (owned copies).  The network face of the
serving plane (the Cluster-Serving shape of BigDL 2.0,
arXiv:2204.01715): a stdlib-only
HTTP/1.1 server over the existing :class:`~bigdl_tpu_torch.serving.
ModelRegistry` / :class:`~bigdl_tpu_torch.resilience.ReplicaSet` engines —
connections owned by a selectors-based event loop by default
(``frontend/eventloop.py`` + the ``frontend/http1.py`` incremental
parser; ``core="threaded"`` keeps the thread-per-connection core) — plus the three service-platform
behaviors large-scale serving treats as table stakes:

- :class:`FrontendServer` — ``POST /v1/models/<name>[:<v>]/predict``
  with JSON / raw-npy bodies, chunked ndjson streaming for multi-chunk
  predicts, ``X-Deadline-Ms`` propagated into the batcher's deadline
  path (504 on expiry), overloads as 429 + ``Retry-After``, trace ids
  minted/echoed so ``tools/obs_report.py`` stories span the wire hop;
- :class:`QosAdmission` / :class:`TenantSpec` — per-tenant admission:
  QoS classes (``latency`` | ``batch``) feeding the batcher's
  priority-preemption hook, token-bucket rate limits shed as 429, and
  ``serving/tenant=<t>/*`` metrics on the shared registry;
- :class:`HotCutover` — drain-free hot version cutover: warm → flip →
  drain wire connections → drain queue → undeploy (a deploy under load
  drops zero requests);
- :class:`ReplicaAutoscaler` — hysteresis + cooldown replica-count
  controller over the queue-depth/drain-EWMA load signal, actuating
  ``ReplicaSet.set_replica_count``.

Inertness contract (house discipline): importing this package — or
merely having it on the path — constructs nothing: no socket, no
thread, no config read.  Every component is explicit opt-in (gated in
``tests/test_torch_frontend.py``).
"""

from bigdl_tpu_torch.frontend.autoscale import ReplicaAutoscaler
from bigdl_tpu_torch.frontend.cutover import CutoverDrainTimeout, HotCutover
from bigdl_tpu_torch.frontend.qos import (BATCH, LATENCY, QosAdmission,
                                          TenantRateLimited, TenantSpec,
                                          TokenBucket, UnknownTenantError)
from bigdl_tpu_torch.frontend.server import FrontendServer

__all__ = [
    "BATCH", "CutoverDrainTimeout", "FrontendServer", "HotCutover",
    "LATENCY", "QosAdmission", "ReplicaAutoscaler", "TenantRateLimited",
    "TenantSpec", "TokenBucket", "UnknownTenantError",
]

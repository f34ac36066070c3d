"""ShardedReplicaSet — a ReplicaSet whose replica spans a model device
group (port of ``bigdl_tpu/serving/sharded.py``).

A replica that is one device cannot serve a model that does not fit one
device.  Here a replica slot owns ``devices_per_replica`` devices
arranged as a mesh (``parallel/mesh.py``), and the replica's copy of the
model is placed on them with the splits its layers declare
(``parallel.shard_module``: ``Linear(shard="column"|"row")``,
``MultiHeadAttention(shard=True)``; every other parameter on the group's
first device, the home device, where the service's batches arrive).

Everything else is inherited from
:class:`~bigdl_tpu_torch.resilience.ReplicaSet`: least-queue-depth
routing, health, quarantine and failover, the elastic
``set_replica_count`` (a grown slot is placed and warmed off the routing
path), ``stats()`` and the ``submit()`` contract, so the front end's
``isinstance(backend, ReplicaSet)`` dispatch, the hot cutover, the
autoscaler and ``/metrics`` work at group granularity unchanged.

Device partitioning: the device list is cut into consecutive groups of
``devices_per_replica``; slot ``ix`` takes group ``ix % n_groups``, so,
as in the base class, more replicas than groups is legal (emulated
replicas share a group round-robin).  A group may name one card more than
once (``[cuda:0] * 4`` cut in twos gives two groups of ``[cuda:0,
cuda:0]``): the shards then share the card and their copies are no-ops.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

from bigdl_tpu_torch.resilience.health import ReplicaHealth
from bigdl_tpu_torch.resilience.replica_set import (ReplicaSet,
                                                    default_devices)
from bigdl_tpu_torch.serving.service import InferenceService

AXES = ("data", "model", "seq", "pipe")


class ShardedReplicaSet(ReplicaSet):
    """:class:`ReplicaSet` whose replicas are model device groups.

    Parameters beyond the base class:

    - ``devices_per_replica``: devices a slot (the group's size).
      ``devices`` (default: every CUDA device, raising without one) must
      supply at least one full group.
    - ``mesh_axes``: axis name -> size of each slot's mesh (default
      ``{"model": devices_per_replica}``, pure tensor parallelism).  The
      sizes must multiply to ``devices_per_replica``; unnamed axes are 1.
      A slot's mesh is built by ``parallel.create_mesh``, which runs the
      ``model`` axis and raises for a ``seq`` or ``pipe`` axis above 1;
      a replica is one process, so its ``data`` axis must be 1.

    ``n_replicas`` defaults to the number of COMPLETE device groups
    (``len(devices) // devices_per_replica``), not the device count.
    """

    def __init__(self, model, params=None, state=None, *,
                 devices_per_replica: int = 2,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 n_replicas: Optional[int] = None,
                 devices: Optional[Sequence] = None, **kw):
        from bigdl_tpu_torch.engine import resolve_device
        if devices is None:
            devices = default_devices()
        devices = [resolve_device(d) for d in devices]
        dpr = int(devices_per_replica)
        if dpr < 1:
            raise ValueError(f"devices_per_replica must be >= 1: {dpr}")
        n_groups = len(devices) // dpr
        if n_groups < 1:
            raise ValueError(
                f"need at least {dpr} devices for one mesh-slice "
                f"replica, have {len(devices)}")
        axes = dict(mesh_axes) if mesh_axes else {"model": dpr}
        bad = set(axes) - set(AXES)
        if bad:
            raise ValueError(f"unknown mesh axes {sorted(bad)}")
        size = 1
        for v in axes.values():
            size *= int(v)
        if size != dpr:
            raise ValueError(
                f"mesh axes {axes} multiply to {size}, need "
                f"devices_per_replica={dpr}")
        if axes.get("data", 1) != 1:
            raise ValueError(f"a replica is one process: its mesh's data "
                             f"axis must be 1, not {axes['data']}")
        # set BEFORE super().__init__: the base constructor calls
        # _build_replica (overridden below) for every initial slot
        self.devices_per_replica = dpr
        self._mesh_axes = axes
        self._groups = [devices[g * dpr:(g + 1) * dpr]
                        for g in range(n_groups)]
        if n_replicas is None:
            n_replicas = n_groups
        super().__init__(model, params, state, n_replicas=n_replicas,
                         devices=devices, **kw)

    # ---------------------------------------------------- replica build
    def group_index(self, ix: int) -> int:
        """The device group slot ``ix`` takes."""
        return ix % len(self._groups)

    def replica_mesh(self, ix: int):
        """The mesh of slot ``ix``'s service (built or not yet built)."""
        svc = self._replicas[ix] if ix < len(self._replicas) else None
        mesh = getattr(svc, "_mesh", None)
        return mesh if mesh is not None else self._slot_mesh(ix)

    def _slot_mesh(self, ix: int):
        from bigdl_tpu_torch.parallel.mesh import create_mesh
        ax = self._mesh_axes
        return create_mesh(data=1, model=ax.get("model", 1),
                           seq=ax.get("seq", 1), pipe=ax.get("pipe", 1),
                           devices=self._groups[self.group_index(ix)])

    def _build_replica(self, ix: int, input_spec):
        """The group twin of the base builder: a copy of the model (the
        set's ``params``/``state`` loaded into it) placed on slot
        ``ix``'s group by the splits its layers declare, behind a fresh
        :class:`InferenceService` on the group's home device; the bucket
        warmup runs here, off the routing path."""
        from bigdl_tpu_torch.parallel.tensor_parallel import shard_module
        mesh = self._slot_mesh(ix)
        model_i = copy.deepcopy(self._model).cpu()
        if self._base_params is not None or self._base_state is not None:
            from bigdl_tpu_torch.interop.jax_weights import (load_jax_params,
                                                             to_jax_params)
            load_jax_params(model_i, self._base_params
                            if self._base_params is not None
                            else to_jax_params(self._model)[0],
                            self._base_state)
        shard_module(model_i, mesh)
        svc = InferenceService(
            model_i, input_spec=input_spec, name=f"{self.name}/r{ix}",
            start=self._started, fault_injector=self._faults,
            tracer=self.tracer, request_tracing=self._request_tracing,
            priority_fn=self._priority_fn, device=mesh.home,
            **self._service_kw)
        svc._fault_replica = ix
        svc._mesh = mesh  # introspection (replica_mesh, tests)
        health = ReplicaHealth(ix, policy=self._policy,
                               registry=self.registry,
                               recorder=self._flight)
        return svc, health


__all__ = ["ShardedReplicaSet"]

"""Distributed substrate of the port (``bigdl_tpu.parallel`` twins): the
mesh over the ``torch.distributed`` process group and the bucketed ZeRO-1
gradient sync (the reference's ``AllReduceParameter``).  Tensor, sequence
and pipeline parallelism are not ported yet (ROADMAP queue A, slice
10)."""

from bigdl_tpu_torch.parallel import grad_sync
from bigdl_tpu_torch.parallel.grad_sync import (BucketPlan, build_plan,
                                                resolve_wire_dtype)
from bigdl_tpu_torch.parallel.mesh import (Mesh, create_mesh, data_sharding,
                                           init_process_group, mesh_shape,
                                           replicated)

__all__ = ["BucketPlan", "Mesh", "build_plan", "create_mesh",
           "data_sharding", "grad_sync", "init_process_group", "mesh_shape",
           "replicated", "resolve_wire_dtype"]

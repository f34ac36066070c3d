"""Distributed substrate of the port (``bigdl_tpu.parallel`` twins): the
mesh over the ``torch.distributed`` process group and this process's model
device group, the bucketed ZeRO-1 gradient sync (the reference's
``AllReduceParameter``), tensor parallelism over the ``model`` axis, ring
attention over the ``seq`` axis and GPipe over the ``pipe`` axis."""

from bigdl_tpu_torch.parallel import grad_sync
from bigdl_tpu_torch.parallel.grad_sync import (BucketPlan, build_plan,
                                                resolve_wire_dtype)
from bigdl_tpu_torch.parallel.mesh import (Mesh, create_mesh, data_sharding,
                                           init_process_group, mesh_shape,
                                           replicated)
from bigdl_tpu_torch.parallel.pipeline import (GPipe, MicrobatchedSequential,
                                               partition_sequential)
from bigdl_tpu_torch.parallel.ring_attention import ring_attention
from bigdl_tpu_torch.parallel.tensor_parallel import (
    REPLICATED, Shards, Spec, build_param_specs, column_parallel_linear_specs,
    row_parallel_linear_specs, shard_module)

__all__ = ["BucketPlan", "GPipe", "Mesh", "MicrobatchedSequential",
           "REPLICATED", "Shards", "Spec", "build_param_specs", "build_plan",
           "column_parallel_linear_specs", "create_mesh", "data_sharding",
           "grad_sync", "init_process_group", "mesh_shape",
           "partition_sequential", "replicated", "resolve_wire_dtype",
           "ring_attention", "row_parallel_linear_specs", "shard_module"]

"""Serving of the port: dynamic-batching inference
(:class:`InferenceService`, :class:`ModelRegistry`) and continuous-batching
autoregressive decode (:class:`DecodeService`), and replicas that span a
model device group (:class:`ShardedReplicaSet`)."""

from bigdl_tpu_torch.serving.batcher import (DeadlineExceeded, RequestBatcher,
                                             RequestSpecError, ServiceClosed,
                                             ServiceOverloaded)
from bigdl_tpu_torch.serving.decode import DecodeResult, DecodeService
from bigdl_tpu_torch.serving.metrics import LatencyReservoir, ServingMetrics
from bigdl_tpu_torch.serving.registry import ModelRegistry
from bigdl_tpu_torch.serving.service import (InferenceService, pad_rows,
                                             parse_row_buckets, row_buckets)
from bigdl_tpu_torch.serving.sharded import ShardedReplicaSet

__all__ = ["DeadlineExceeded", "DecodeResult", "DecodeService",
           "InferenceService", "LatencyReservoir", "ModelRegistry",
           "RequestBatcher", "RequestSpecError", "ServiceClosed",
           "ServiceOverloaded", "ServingMetrics", "ShardedReplicaSet",
           "pad_rows",
           "parse_row_buckets", "row_buckets"]

"""Dynamic-batching inference serving of the port."""

from bigdl_tpu_torch.serving.batcher import (RequestSpecError, ServiceClosed,
                                             ServiceOverloaded)
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.registry import ModelRegistry
from bigdl_tpu_torch.serving.service import (InferenceService,
                                             parse_row_buckets, row_buckets)

__all__ = ["InferenceService", "ModelRegistry",
           "RequestSpecError", "ServiceClosed", "ServiceOverloaded",
           "ServingMetrics", "parse_row_buckets", "row_buckets"]

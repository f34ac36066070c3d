"""Layers of the port (``bigdl_tpu.nn`` twins)."""

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.layers import (Linear, SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, SpatialMaxPooling)
from bigdl_tpu_torch.nn.module import (ConcatTable, Container, Identity,
                                       Module, Sequential)
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.nn.shape_ops import CAddTable, Reshape

__all__ = ["CAddTable", "ConcatTable", "Container", "Identity", "Linear",
           "LogSoftMax", "Module", "QuantizedLinear",
           "QuantizedSpatialConvolution", "ReLU", "Reshape", "Sequential",
           "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "quantize"]

"""Layers of the port (``bigdl_tpu.nn`` twins)."""

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.criterion import (ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.layers import (BatchNormalization, Dropout, Linear, LookupTable,
                                       SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution, SpatialMaxPooling)
from bigdl_tpu_torch.nn.module import (ConcatTable, Container, Identity,
                                       Module, Sequential)
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution,
                                          quantize)
from bigdl_tpu_torch.nn.recurrent import (LSTM, Cell, MultiRNNCell,
                                          Recurrent, RnnCell, TimeDistributed)
from bigdl_tpu_torch.nn.shape_ops import CAddTable, Reshape

__all__ = ["BatchNormalization", "CAddTable", "Cell", "ClassNLLCriterion", "ConcatTable",
           "Container", "Criterion", "CrossEntropyCriterion", "Dropout",
           "Identity", "LSTM", "Linear", "LogSoftMax", "LookupTable",
           "Module", "MultiRNNCell", "QuantizedLinear",
           "QuantizedSpatialConvolution", "ReLU", "Recurrent", "Reshape",
           "RnnCell", "Sequential", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SpatialMaxPooling", "TimeDistributed",
           "TimeDistributedCriterion", "quantize"]

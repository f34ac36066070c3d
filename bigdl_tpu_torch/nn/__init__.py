"""Layers of the port (``bigdl_tpu.nn`` twins)."""

from bigdl_tpu_torch.nn.activations import LogSoftMax, ReLU
from bigdl_tpu_torch.nn.criterion import (BCECriterion,
                                          BCEWithLogitsCriterion,
                                          ClassNLLCriterion, Criterion,
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
from bigdl_tpu_torch.nn.sparse import (COOBatch, DenseToSparse,
                                       LookupTableSparse, SparseJoinTable,
                                       SparseLinear)

__all__ = ["BCECriterion", "BCEWithLogitsCriterion", "BatchNormalization",
           "CAddTable", "COOBatch", "Cell", "ClassNLLCriterion", "ConcatTable",
           "Container", "Criterion", "CrossEntropyCriterion", "Dropout",
           "DenseToSparse", "Identity", "LSTM", "Linear", "LogSoftMax",
           "LookupTable", "LookupTableSparse",
           "Module", "MultiRNNCell", "QuantizedLinear",
           "QuantizedSpatialConvolution", "ReLU", "Recurrent", "Reshape",
           "RnnCell", "Sequential", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution",
           "SparseJoinTable", "SparseLinear", "SpatialMaxPooling",
           "TimeDistributed",
           "TimeDistributedCriterion", "quantize"]

"""Layers of the port (``bigdl_tpu.nn`` twins)."""

from bigdl_tpu_torch.nn.activations import (ELU, GELU, HardShrink,
                                            HardSigmoid, HardTanh, LeakyReLU,
                                            LogSigmoid, LogSoftMax, PReLU,
                                            ReLU, ReLU6, RReLU, Sigmoid, SiLU,
                                            SoftMax, SoftMin, SoftPlus,
                                            SoftShrink, SoftSign, SReLU, Tanh,
                                            TanhShrink, Threshold)
from bigdl_tpu_torch.nn.criterion import (BCECriterion,
                                          BCEWithLogitsCriterion,
                                          ClassNLLCriterion, Criterion,
                                          CrossEntropyCriterion,
                                          MSECriterion,
                                          TimeDistributedCriterion)
from bigdl_tpu_torch.nn.initialization import (BilinearFiller,
                                               ConstInitMethod,
                                               InitializationMethod,
                                               MsraFiller, Ones,
                                               RandomNormal, RandomUniform,
                                               Xavier, Zeros)
from bigdl_tpu_torch.nn.layers import (BatchNormalization, Dropout, Linear,
                                       LookupTable, SpatialAveragePooling,
                                       SpatialBatchNormalization,
                                       SpatialConvolution,
                                       SpatialCrossMapLRN, SpatialMaxPooling)
from bigdl_tpu_torch.nn.module import (Concat, ConcatTable, Container,
                                       Identity, Module, Sequential)
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
           "BilinearFiller", "CAddTable", "COOBatch", "Cell",
           "ClassNLLCriterion", "Concat", "ConcatTable", "ConstInitMethod",
           "Container", "Criterion", "CrossEntropyCriterion", "Dropout",
           "DenseToSparse", "ELU", "GELU", "HardShrink", "HardSigmoid",
           "HardTanh", "Identity", "InitializationMethod", "LSTM",
           "LeakyReLU", "Linear",
           "LogSigmoid", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "MSECriterion", "Module", "MsraFiller", "MultiRNNCell", "Ones",
           "PReLU",
           "QuantizedLinear", "QuantizedSpatialConvolution", "RReLU", "ReLU",
           "RandomNormal", "RandomUniform",
           "ReLU6", "Recurrent", "Reshape", "RnnCell", "SReLU", "Sequential",
           "SiLU", "Sigmoid", "SoftMax", "SoftMin", "SoftPlus", "SoftShrink",
           "SoftSign", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SparseJoinTable",
           "SparseLinear", "SpatialMaxPooling", "Tanh", "TanhShrink",
           "Threshold", "Xavier", "Zeros",
           "TimeDistributed", "TimeDistributedCriterion", "quantize"]

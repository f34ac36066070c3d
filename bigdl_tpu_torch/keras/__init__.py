"""Keras-1.2-style sugar over the port's module system (port of
``bigdl_tpu/keras``): ``KerasLayer`` wrappers with shape inference and a
``Sequential``/``Model`` topology with ``compile``/``fit``/``evaluate``/
``predict``."""

from bigdl_tpu_torch.keras.backend import KerasModelWrapper, load_model
from bigdl_tpu_torch.keras.layers import (
    GRU, LSTM, Activation, AveragePooling2D, BatchNormalization,
    Bidirectional, Convolution1D, Convolution2D, Cropping2D, Dense, Dropout,
    Embedding, Flatten, GlobalAveragePooling1D, GlobalAveragePooling2D,
    GlobalMaxPooling1D, GlobalMaxPooling2D, Highway, InputLayer, KerasLayer,
    MaxoutDense, MaxPooling1D, MaxPooling2D, Merge, Permute, RepeatVector,
    Reshape, SeparableConvolution2D, SimpleRNN, TimeDistributed,
    UpSampling2D, ZeroPadding1D, ZeroPadding2D)
from bigdl_tpu_torch.keras.topology import Model, Sequential

__all__ = [
    "KerasLayer", "Dense", "Activation", "Dropout", "Flatten", "Reshape",
    "Convolution1D", "Convolution2D", "MaxPooling2D", "AveragePooling2D",
    "GlobalAveragePooling2D", "GlobalMaxPooling2D", "ZeroPadding2D",
    "BatchNormalization", "Embedding", "SimpleRNN", "LSTM", "GRU",
    "Bidirectional", "TimeDistributed", "InputLayer",
    "RepeatVector", "Permute", "Cropping2D", "UpSampling2D",
    "ZeroPadding1D", "MaxPooling1D", "GlobalMaxPooling1D",
    "GlobalAveragePooling1D", "Highway", "MaxoutDense",
    "SeparableConvolution2D", "Merge",
    "Sequential", "Model",
    "KerasModelWrapper", "load_model",
]

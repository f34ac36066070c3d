"""Inception v1 (GoogLeNet) and BN-Inception v2 (port of
``bigdl_tpu/models/inception.py``).

Inception v1 is the no-auxiliary-classifier variant: a stem (7x7/2 conv,
3x3/2 ceil-mode max pool, LRN, 1x1 and 3x3 convs, LRN, pool), nine
inception modules 3a..5b of the canonical tower widths, each a ``Concat``
of four towers on the channel axis, a 7x7 average pool, dropout 0.4 and a
linear classifier; NCHW or, with ``format="NHWC"``, channels-last.
Inception v2 pairs every conv with BatchNorm (NCHW).  Convs and the
classifier draw Xavier weights.  The factories return placeholder
weights: call ``.initialize(generator)`` or load weights before use.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import Xavier


def _conv(in_c, out_c, k, stride=1, pad=0, name="", format="NCHW"):
    return (nn.Sequential(name=name)
            .add(nn.SpatialConvolution(in_c, out_c, k, k, stride, stride,
                                       pad, pad, weight_init=Xavier(),
                                       format=format,
                                       name=f"{name}_conv"))
            .add(nn.ReLU()))


def inception_module(in_c, c1, c3r, c3, c5r, c5, pool_proj, name,
                     format="NCHW"):
    """Four towers concatenated on the channel axis: 1x1; 1x1 then 3x3;
    1x1 then 5x5; a 3x3/1 pad 1 max pool then 1x1."""
    c_axis = 1 if format == "NCHW" else 3
    return (nn.Concat(c_axis, name=name)
            .add(_conv(in_c, c1, 1, name=f"{name}_1x1", format=format))
            .add(nn.Sequential()
                 .add(_conv(in_c, c3r, 1, name=f"{name}_3x3r",
                            format=format))
                 .add(_conv(c3r, c3, 3, pad=1, name=f"{name}_3x3",
                            format=format)))
            .add(nn.Sequential()
                 .add(_conv(in_c, c5r, 1, name=f"{name}_5x5r",
                            format=format))
                 .add(_conv(c5r, c5, 5, pad=2, name=f"{name}_5x5",
                            format=format)))
            .add(nn.Sequential()
                 .add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1, format=format))
                 .add(_conv(in_c, pool_proj, 1, name=f"{name}_pool",
                            format=format))))


def inception_v1(class_num: int = 1000,
                 format: str = "NCHW") -> nn.Sequential:
    """Inception v1 for 224x224 inputs: 13 max pools (four 3x3/2
    ceil-mode, nine 3x3/1 pad 1 in the towers)."""
    f = format
    m = (nn.Sequential(name="InceptionV1")
         .add(_conv(3, 64, 7, 2, 3, "conv1/7x7_s2", format=f))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True, format=f))
         .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75, format=f))
         .add(_conv(64, 64, 1, name="conv2/3x3_reduce", format=f))
         .add(_conv(64, 192, 3, pad=1, name="conv2/3x3", format=f))
         .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75, format=f))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True, format=f)))
    # (in, 1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool projection)
    m.add(inception_module(192, 64, 96, 128, 16, 32, 32, "3a", f))
    m.add(inception_module(256, 128, 128, 192, 32, 96, 64, "3b", f))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True, format=f))
    m.add(inception_module(480, 192, 96, 208, 16, 48, 64, "4a", f))
    m.add(inception_module(512, 160, 112, 224, 24, 64, 64, "4b", f))
    m.add(inception_module(512, 128, 128, 256, 24, 64, 64, "4c", f))
    m.add(inception_module(512, 112, 144, 288, 32, 64, 64, "4d", f))
    m.add(inception_module(528, 256, 160, 320, 32, 128, 128, "4e", f))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True, format=f))
    m.add(inception_module(832, 256, 160, 320, 32, 128, 128, "5a", f))
    m.add(inception_module(832, 384, 192, 384, 48, 128, 128, "5b", f))
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, format=f))
    m.add(nn.Dropout(0.4))
    m.add(nn.Reshape((1024,)))
    m.add(nn.Linear(1024, class_num, weight_init=Xavier()))
    m.add(nn.LogSoftMax())
    return m


# ---------------------------------------------------------- Inception v2
def _conv_bn(in_c, out_c, k, stride=1, pad=0, name=""):
    """conv (no bias) + BN(eps 1e-3) + ReLU, the v2 building block."""
    return (nn.Sequential(name=name)
            .add(nn.SpatialConvolution(in_c, out_c, k, k, stride, stride,
                                       pad, pad, with_bias=False,
                                       weight_init=Xavier(),
                                       name=f"{name}_conv"))
            .add(nn.SpatialBatchNormalization(out_c, eps=1e-3,
                                              name=f"{name}/bn"))
            .add(nn.ReLU()))


def inception_layer_v2(in_c, c1, c3, cd3, pool, name):
    """BN-Inception module.  ``c1``: the 1x1 tower's width (0: a stride-2
    reduction module without it); ``c3``: (reduce, out) of the 3x3 tower;
    ``cd3``: (reduce, out) of the double-3x3 tower; ``pool``: ("avg" or
    "max", projection width; 0 is a bare pool).  The stride-2 form strides
    the 3x3, the second double-3x3 and the pool."""
    stride = 1 if c1 > 0 else 2
    m = nn.Concat(1, name=name)
    if c1 > 0:
        m.add(_conv_bn(in_c, c1, 1, name=f"{name}1x1"))
    m.add(nn.Sequential()
          .add(_conv_bn(in_c, c3[0], 1, name=f"{name}3x3_reduce"))
          .add(_conv_bn(c3[0], c3[1], 3, stride, 1, name=f"{name}3x3")))
    m.add(nn.Sequential()
          .add(_conv_bn(in_c, cd3[0], 1, name=f"{name}double3x3_reduce"))
          .add(_conv_bn(cd3[0], cd3[1], 3, 1, 1, name=f"{name}double3x3a"))
          .add(_conv_bn(cd3[1], cd3[1], 3, stride, 1,
                        name=f"{name}double3x3b")))
    pool_type, proj = pool
    pool_mod = (nn.SpatialMaxPooling(3, 3, stride, stride,
                                     0 if stride == 2 else 1,
                                     0 if stride == 2 else 1,
                                     ceil_mode=True)
                if pool_type == "max"
                else nn.SpatialAveragePooling(3, 3, stride, stride, 1, 1,
                                              ceil_mode=True))
    tower = nn.Sequential().add(pool_mod)
    if proj > 0:
        tower.add(_conv_bn(in_c, proj, 1, name=f"{name}pool_proj"))
    m.add(tower)
    return m


def inception_v2(class_num: int = 1000) -> nn.Sequential:
    """BN-Inception (Inception v2), the no-auxiliary-classifier variant."""
    m = (nn.Sequential(name="InceptionV2")
         .add(_conv_bn(3, 64, 7, 2, 3, "conv1/7x7_s2"))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True))
         .add(_conv_bn(64, 64, 1, name="conv2/3x3_reduce"))
         .add(_conv_bn(64, 192, 3, 1, 1, "conv2/3x3"))
         .add(nn.SpatialMaxPooling(3, 3, 2, 2, ceil_mode=True)))
    m.add(inception_layer_v2(192, 64, (64, 64), (64, 96), ("avg", 32),
                             "3a/"))
    m.add(inception_layer_v2(256, 64, (64, 96), (64, 96), ("avg", 64),
                             "3b/"))
    m.add(inception_layer_v2(320, 0, (128, 160), (64, 96), ("max", 0),
                             "3c/"))
    m.add(inception_layer_v2(576, 224, (64, 96), (96, 128), ("avg", 128),
                             "4a/"))
    m.add(inception_layer_v2(576, 192, (96, 128), (96, 128), ("avg", 128),
                             "4b/"))
    m.add(inception_layer_v2(576, 160, (128, 160), (128, 160), ("avg", 96),
                             "4c/"))
    m.add(inception_layer_v2(576, 96, (128, 192), (160, 192), ("avg", 96),
                             "4d/"))
    m.add(inception_layer_v2(576, 0, (128, 192), (192, 256), ("max", 0),
                             "4e/"))
    m.add(inception_layer_v2(1024, 352, (192, 320), (160, 224),
                             ("avg", 128), "5a/"))
    m.add(inception_layer_v2(1024, 352, (192, 320), (192, 224),
                             ("max", 128), "5b/"))
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, ceil_mode=True))
    m.add(nn.Dropout(0.4))
    m.add(nn.Reshape((1024,)))
    m.add(nn.Linear(1024, class_num, weight_init=Xavier()))
    m.add(nn.LogSoftMax())
    return m

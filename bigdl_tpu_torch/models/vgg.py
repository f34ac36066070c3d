"""VGG (port of ``bigdl_tpu/models/vgg.py``): the CIFAR-10 VGG-16 with
BatchNorm, and the ImageNet VGG-16.

Both are NCHW.  The factories return placeholder weights: call
``.initialize(generator)`` or load weights before use.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M"]


def _conv_bn_relu(model, in_c, out_c):
    (model
     .add(nn.SpatialConvolution(in_c, out_c, 3, 3, 1, 1, 1, 1))
     .add(nn.SpatialBatchNormalization(out_c, eps=1e-3))
     .add(nn.ReLU()))
    return out_c


def vgg_for_cifar10(class_num: int = 10) -> nn.Sequential:
    """Conv stacks 64-128-256-512-512 of 3x3 conv, BN and ReLU, each
    closed by a 2x2/2 max pool; classifier 512 -> 512 -> ``class_num``
    with dropout."""
    model = nn.Sequential(name="VggForCifar10")
    in_c = 3
    for v in _CFG:
        if v == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            in_c = _conv_bn_relu(model, in_c, v)
    (model
     .add(nn.Reshape((512,)))
     .add(nn.Dropout(0.5))
     .add(nn.Linear(512, 512))
     .add(nn.BatchNormalization(512))
     .add(nn.ReLU())
     .add(nn.Dropout(0.5))
     .add(nn.Linear(512, class_num))
     .add(nn.LogSoftMax()))
    return model


def vgg16(class_num: int = 1000) -> nn.Sequential:
    """ImageNet VGG-16 (224x224 inputs): 13 3x3 convs with ReLU, five
    2x2/2 max pools, classifier 25088 -> 4096 -> 4096 -> ``class_num``."""
    model = nn.Sequential(name="Vgg16")
    in_c = 3
    for v in _CFG:
        if v == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(nn.SpatialConvolution(in_c, v, 3, 3, 1, 1, 1, 1))
            model.add(nn.ReLU())
            in_c = v
    (model
     .add(nn.Reshape((512 * 7 * 7,)))
     .add(nn.Linear(512 * 7 * 7, 4096)).add(nn.ReLU()).add(nn.Dropout(0.5))
     .add(nn.Linear(4096, 4096)).add(nn.ReLU()).add(nn.Dropout(0.5))
     .add(nn.Linear(4096, class_num))
     .add(nn.LogSoftMax()))
    return model

"""ResNet (port of ``bigdl_tpu/models/resnet.py``).

Both recipes of the reference: the CIFAR-10 basic-block ResNet and the
ImageNet bottleneck ResNet-50 (1000 classes, 224x224), in NCHW or, with
``format="NHWC"``, channels-last (every conv, BN and pool of the tree gets
the format; ``state_dict`` keys are the reference's pytree paths in both).
Convs carry MSRA init and no bias; BN starts at gamma 1, beta 0, running
mean 0 and variance 1.  The factories return placeholder weights: call
``.initialize(generator)`` or load weights before use.  ``resnet50(remat=)``
wraps each bottleneck in :class:`~bigdl_tpu_torch.nn.Remat`, which leaves
the ``state_dict`` keys as they are.
"""

from __future__ import annotations

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.initialization import MsraFiller


def _conv_bn(in_c, out_c, k, stride, pad, name, fmt="NCHW"):
    return (nn.Sequential(name=name)
            .add(nn.SpatialConvolution(
                in_c, out_c, k, k, stride, stride, pad, pad,
                with_bias=False, weight_init=MsraFiller(), format=fmt,
                name=f"{name}_conv"))
            .add(nn.SpatialBatchNormalization(out_c, format=fmt,
                                              name=f"{name}_bn")))


def _residual(main, shortcut):
    return (nn.Sequential()
            .add(nn.ConcatTable().add(main).add(shortcut))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def basic_block(in_c, out_c, stride, fmt="NCHW"):
    """3x3+3x3 residual block (reference basicBlock, shortcut type B)."""
    main = (nn.Sequential()
            .add(_conv_bn(in_c, out_c, 3, stride, 1, "a", fmt))
            .add(nn.ReLU())
            .add(_conv_bn(out_c, out_c, 3, 1, 1, "b", fmt)))
    if stride != 1 or in_c != out_c:
        shortcut = _conv_bn(in_c, out_c, 1, stride, 0, "sc", fmt)
    else:
        shortcut = nn.Identity()
    return _residual(main, shortcut)


def bottleneck(in_c, mid_c, stride, fmt="NCHW"):
    """1x1 -> 3x3 -> 1x1 bottleneck (reference bottleneck; expansion 4)."""
    out_c = mid_c * 4
    main = (nn.Sequential()
            .add(_conv_bn(in_c, mid_c, 1, 1, 0, "a", fmt))
            .add(nn.ReLU())
            .add(_conv_bn(mid_c, mid_c, 3, stride, 1, "b", fmt))
            .add(nn.ReLU())
            .add(_conv_bn(mid_c, out_c, 1, 1, 0, "c", fmt)))
    if stride != 1 or in_c != out_c:
        shortcut = _conv_bn(in_c, out_c, 1, stride, 0, "sc", fmt)
    else:
        shortcut = nn.Identity()
    return _residual(main, shortcut)


def resnet_cifar(depth: int = 20, class_num: int = 10,
                 format: str = "NCHW") -> nn.Sequential:
    """CIFAR-10 ResNet: 3 stages of n = (depth-2)/6 basic blocks at
    widths 16/32/64."""
    if (depth - 2) % 6 != 0:
        raise ValueError(f"depth must be 6n+2, got {depth}")
    fmt = format
    n = (depth - 2) // 6
    model = (nn.Sequential(name=f"ResNet{depth}")
             .add(_conv_bn(3, 16, 3, 1, 1, "stem", fmt))
             .add(nn.ReLU()))
    in_c = 16
    for si, w in enumerate([16, 32, 64]):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            model.add(basic_block(in_c, w, stride, fmt))
            in_c = w
    model.add(nn.SpatialAveragePooling(8, 8, 8, 8, format=fmt))
    model.add(nn.Reshape((64,)))
    model.add(nn.Linear(64, class_num))
    model.add(nn.LogSoftMax())
    return model


def resnet50(class_num: int = 1000, format: str = "NCHW",
             remat=False) -> nn.Sequential:
    """ImageNet ResNet-50: stem 7x7/2 + maxpool, stages [3,4,6,3]
    bottlenecks at 64/128/256/512 — 53 convolutions and one Linear.

    ``remat`` recomputes the bottlenecks' interiors in the backward:
    ``False`` keeps every activation; ``True`` recomputes each block whole,
    its convolutions too; ``"tails"`` keeps the convolutions' outputs and
    recomputes the BatchNorm and ReLU tails.  The stem, with its pool,
    stays outside."""
    if remat not in (False, True, "tails"):
        raise ValueError(f"unknown remat mode {remat!r}; "
                         "use False, True or 'tails'")
    policy = "tails" if remat == "tails" else None
    fmt = format
    model = (nn.Sequential(name="ResNet50")
             .add(_conv_bn(3, 64, 7, 2, 3, "stem", fmt))
             .add(nn.ReLU())
             .add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt)))
    in_c = 64
    for mid, blocks, first_stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2),
                                      (512, 3, 2)]:
        for bi in range(blocks):
            block = bottleneck(in_c, mid, first_stride if bi == 0 else 1,
                               fmt)
            model.add(nn.Remat(block, policy=policy) if remat else block)
            in_c = mid * 4
    model.add(nn.SpatialAveragePooling(7, 7, 7, 7, format=fmt))
    model.add(nn.Reshape((2048,)))
    model.add(nn.Linear(2048, class_num))
    model.add(nn.LogSoftMax())
    return model

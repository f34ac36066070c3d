"""LeNet-5 (port of ``bigdl_tpu/models/lenet.py``): conv5x5(6) -> tanh ->
maxpool 2x2/2 -> conv5x5(12) -> tanh -> maxpool 2x2/2 -> fc(100) -> tanh ->
fc(class_num) -> log-softmax, NCHW, with the reference's layer names.  Its
two pools' backward is kernel B1 on the card (``ops/maxpool.py``)."""

from __future__ import annotations

from bigdl_tpu_torch import nn


def lenet5(class_num: int = 10) -> nn.Sequential:
    return (nn.Sequential(name="LeNet5")
            .add(nn.Reshape((1, 28, 28)))
            .add(nn.SpatialConvolution(1, 6, 5, 5, name="conv1_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.SpatialConvolution(6, 12, 5, 5, name="conv2_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape((12 * 4 * 4,)))
            .add(nn.Linear(12 * 4 * 4, 100, name="fc1"))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num, name="fc2"))
            .add(nn.LogSoftMax()))

"""MNIST autoencoder (port of ``bigdl_tpu/models/autoencoder.py``):
784 -> ``class_num`` -> 784 with a ReLU bottleneck and a sigmoid output,
trained with MSE against its own input."""

from __future__ import annotations

from bigdl_tpu_torch import nn


def autoencoder(class_num: int = 32) -> nn.Sequential:
    return (nn.Sequential(name="Autoencoder")
            .add(nn.Reshape((784,)))
            .add(nn.Linear(784, class_num))
            .add(nn.ReLU())
            .add(nn.Linear(class_num, 784))
            .add(nn.Sigmoid()))

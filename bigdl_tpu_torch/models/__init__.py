"""Model factories of the port."""

from bigdl_tpu_torch.models.resnet import resnet50, resnet_cifar

__all__ = ["resnet50", "resnet_cifar"]

"""Model factories of the port."""

from bigdl_tpu_torch.models.inception import inception_v1
from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.recommender import WideAndDeep
from bigdl_tpu_torch.models.resnet import resnet50, resnet_cifar
from bigdl_tpu_torch.models.rnn import ptb_model, simple_rnn
from bigdl_tpu_torch.models.vgg import vgg16, vgg_for_cifar10

__all__ = ["WideAndDeep", "inception_v1", "lenet5", "ptb_model", "resnet50",
           "resnet_cifar", "simple_rnn", "vgg16", "vgg_for_cifar10"]

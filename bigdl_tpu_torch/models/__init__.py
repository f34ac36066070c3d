"""Model factories of the port."""

from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.recommender import WideAndDeep
from bigdl_tpu_torch.models.resnet import resnet50, resnet_cifar
from bigdl_tpu_torch.models.rnn import ptb_model, simple_rnn

__all__ = ["WideAndDeep", "lenet5", "ptb_model", "resnet50", "resnet_cifar",
           "simple_rnn"]

"""Model factories of the port."""

from bigdl_tpu_torch.models.autoencoder import autoencoder
from bigdl_tpu_torch.models.inception import inception_v1
from bigdl_tpu_torch.models.lenet import lenet5
from bigdl_tpu_torch.models.recommender import NeuralCF, WideAndDeep
from bigdl_tpu_torch.models.resnet import resnet50, resnet_cifar
from bigdl_tpu_torch.models.rnn import ptb_model, simple_rnn
from bigdl_tpu_torch.models.transformer import (LearnedPositionalEmbedding,
                                                transformer_block,
                                                transformer_lm)
from bigdl_tpu_torch.models.vgg import vgg16, vgg_for_cifar10

__all__ = ["LearnedPositionalEmbedding", "NeuralCF", "WideAndDeep", "autoencoder",
           "inception_v1", "lenet5", "ptb_model", "resnet50", "resnet_cifar",
           "simple_rnn", "transformer_block", "transformer_lm", "vgg16",
           "vgg_for_cifar10"]

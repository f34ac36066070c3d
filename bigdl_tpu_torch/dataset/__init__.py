"""Training data pipeline of the port (``bigdl_tpu.dataset`` twins)."""

from bigdl_tpu_torch.dataset import (cifar, image, mnist, news20, text,
                                     tfrecord)
from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet, DataSet,
                                             DistributedDataSet, LocalDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.prefetch import MTSampleToMiniBatch
from bigdl_tpu_torch.dataset.sample import (MiniBatch, PaddingParam, Sample,
                                            SparseMiniBatch, SparseSample,
                                            batch_samples,
                                            batch_sparse_samples)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 FnTransformer,
                                                 SampleToMiniBatch,
                                                 Transformer)

__all__ = ["AbstractDataSet", "ChainedTransformer", "DataSet",
           "DistributedDataSet", "FnTransformer",
           "LocalDataSet", "MTSampleToMiniBatch", "MiniBatch", "PaddingParam",
           "Sample", "SampleToMiniBatch", "SparseMiniBatch", "SparseSample",
           "TransformedDataSet", "Transformer", "batch_samples",
           "batch_sparse_samples", "cifar", "image", "mnist", "news20", "text",
           "tfrecord"]

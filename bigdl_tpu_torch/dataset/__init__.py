"""Training data pipeline of the port (``bigdl_tpu.dataset`` twins)."""

from bigdl_tpu_torch.dataset import (cifar, datamining, image, mnist,
                                     movielens, news20, seqfile, text,
                                     tfrecord)
from bigdl_tpu_torch.dataset.datamining import (
    BucketizedCol, CategoricalColHashBucket, CategoricalColVocaList,
    ColsToNumeric, ColToSchema, ColToTensor, CrossCol, IndicatorCol,
    Kv2Tensor, RowTransformer, RowTransformSchema)
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

__all__ = ["AbstractDataSet", "batch_samples", "batch_sparse_samples",
           "BucketizedCol", "CategoricalColHashBucket",
           "CategoricalColVocaList", "ChainedTransformer", "cifar",
           "ColsToNumeric", "ColToSchema", "ColToTensor", "CrossCol",
           "datamining", "DataSet", "DistributedDataSet", "FnTransformer",
           "image", "IndicatorCol", "Kv2Tensor", "LocalDataSet", "MiniBatch",
           "mnist", "movielens", "MTSampleToMiniBatch", "news20",
           "PaddingParam", "RowTransformer", "RowTransformSchema", "Sample",
           "SampleToMiniBatch", "seqfile", "SparseMiniBatch", "SparseSample",
           "text", "tfrecord", "TransformedDataSet", "Transformer"]

"""Image transforms of the port (``bigdl_tpu.transform`` twins)."""

from bigdl_tpu_torch.transform.vision import (CenterCrop, ChainedFeature,
                                              ChannelNormalize,
                                              FeatureTransformer, HFlip,
                                              ImageFeature,
                                              ImageFrameToSample,
                                              RandomAlterAspect, RandomCrop,
                                              Resize)

__all__ = ["CenterCrop", "ChainedFeature", "ChannelNormalize",
           "FeatureTransformer", "HFlip", "ImageFeature",
           "ImageFrameToSample", "RandomAlterAspect", "RandomCrop", "Resize"]

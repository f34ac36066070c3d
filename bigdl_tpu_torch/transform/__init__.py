"""Image transforms of the port (``bigdl_tpu.transform`` twins)."""

from bigdl_tpu_torch.transform.vision import (
    AspectScale, Brightness, CenterCrop, ChainedFeature, ChannelNormalize,
    ChannelOrder, ChannelScaledNormalizer, ColorJitter, Contrast, Expand,
    FeatureTransformer, Filler, FixedCrop, HFlip, Hue, ImageFeature,
    ImageFrame, ImageFrameToSample, Lighting, LocalImageFrame, MatToFloats,
    PixelNormalizer, RandomAlterAspect, RandomAspectScale, RandomCrop,
    RandomResize, RandomTransformer, Resize, Saturation)

__all__ = [
    "AspectScale", "Brightness", "CenterCrop", "ChainedFeature",
    "ChannelNormalize", "ChannelOrder", "ChannelScaledNormalizer",
    "ColorJitter", "Contrast", "Expand", "FeatureTransformer", "Filler",
    "FixedCrop", "HFlip", "Hue", "ImageFeature", "ImageFrame",
    "ImageFrameToSample", "Lighting", "LocalImageFrame", "MatToFloats",
    "PixelNormalizer", "RandomAlterAspect", "RandomAspectScale", "RandomCrop",
    "RandomResize", "RandomTransformer", "Resize", "Saturation"]

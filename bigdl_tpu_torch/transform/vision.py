"""Image pipeline: ImageFeature, FeatureTransformer and the augmentation
ops of the ImageNet recipe (port of ``bigdl_tpu/transform/vision.py``, that
part: ``ChannelNormalize``, ``HFlip``, ``RandomAlterAspect`` and
``ImageFrameToSample``, plus ``Resize``, ``CenterCrop`` and ``RandomCrop``).

The image payload is a float32 HWC numpy array and every op is the
reference's numpy code, so the same sample and seed give the same float
array bit for bit.  Augmentation runs on the host ahead of the copy to the
card.  ``ImageFrame`` and the other ops of the reference's file are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.utils.imgops import ThreadRng, resize_bilinear


class ImageFeature(dict):
    """Mutable record flowing through the pipeline.  Well-known keys:
    ``floats`` (the HWC float32 image), ``label``, ``originalSize``,
    ``uri``, plus anything a transformer stashes."""

    FLOATS = "floats"
    LABEL = "label"
    URI = "uri"
    ORIGINAL_SIZE = "originalSize"

    def __init__(self, image: Optional[np.ndarray] = None, label=None,
                 uri: Optional[str] = None, **kw):
        super().__init__(**kw)
        if image is not None:
            img = np.asarray(image, np.float32)
            self[self.FLOATS] = img
            self[self.ORIGINAL_SIZE] = img.shape
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    @property
    def image(self) -> np.ndarray:
        return self[self.FLOATS]

    @image.setter
    def image(self, v: np.ndarray):
        self[self.FLOATS] = v

    @property
    def label(self):
        return self.get(self.LABEL)


class FeatureTransformer:
    """Composable ImageFeature -> ImageFeature op; compose with ``>>``."""

    def transform(self, feature: ImageFeature) -> ImageFeature:
        raise NotImplementedError(type(self).__name__)

    def __call__(self, feature: ImageFeature) -> ImageFeature:
        return self.transform(feature)

    def __rshift__(self, other: "FeatureTransformer") -> "ChainedFeature":
        return ChainedFeature(self, other)


class ChainedFeature(FeatureTransformer):
    def __init__(self, a: FeatureTransformer, b: FeatureTransformer):
        self.a, self.b = a, b

    def transform(self, feature):
        return self.b(self.a(feature))


class ChannelNormalize(FeatureTransformer):
    """(x - mean) / std per channel."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform(self, f):
        f.image = (f.image - self.mean) / self.std
        return f


class Resize(FeatureTransformer):
    """Bilinear resize to (h, w)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def transform(self, f):
        f.image = resize_bilinear(f.image, self.h, self.w)
        return f


class CenterCrop(FeatureTransformer):
    def __init__(self, crop_h: int, crop_w: int):
        self.ch, self.cw = crop_h, crop_w

    def transform(self, f):
        h, w = f.image.shape[:2]
        y, x = (h - self.ch) // 2, (w - self.cw) // 2
        f.image = np.ascontiguousarray(
            f.image[y:y + self.ch, x:x + self.cw])
        return f


class RandomCrop(FeatureTransformer):
    """A random (crop_h, crop_w) window, after zero padding by ``pad``."""

    def __init__(self, crop_h: int, crop_w: int, pad: int = 0, seed: int = 0):
        self.ch, self.cw, self.pad = crop_h, crop_w, pad
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        img = f.image
        if self.pad:
            img = np.pad(img, ((self.pad, self.pad), (self.pad, self.pad))
                         + (((0, 0),) if img.ndim == 3 else ()))
        h, w = img.shape[:2]
        y = int(self._rng.integers(0, h - self.ch + 1))
        x = int(self._rng.integers(0, w - self.cw + 1))
        f.image = np.ascontiguousarray(img[y:y + self.ch, x:x + self.cw])
        return f


class HFlip(FeatureTransformer):
    """Horizontal flip with probability ``threshold``."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        if self._rng.random() < self.threshold:
            f.image = np.ascontiguousarray(f.image[:, ::-1])
        return f


class RandomAlterAspect(FeatureTransformer):
    """Random-area/aspect crop then resize to ``target_size`` square: the
    Inception training crop; after 10 misses, the whole image."""

    def __init__(self, min_area_ratio: float = 0.08,
                 max_area_ratio: float = 1.0,
                 min_aspect_ratio: float = 0.75, target_size: int = 224,
                 seed: int = 0):
        self.min_area, self.max_area = min_area_ratio, max_area_ratio
        self.min_aspect = min_aspect_ratio
        self.target = target_size
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        img = f.image
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = self._rng.uniform(self.min_area,
                                            self.max_area) * area
            aspect = self._rng.uniform(self.min_aspect, 1.0 / self.min_aspect)
            cw = int(round(math.sqrt(target_area * aspect)))
            ch = int(round(math.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                y = int(self._rng.integers(0, h - ch + 1))
                x = int(self._rng.integers(0, w - cw + 1))
                crop = img[y:y + ch, x:x + cw]
                f.image = resize_bilinear(crop, self.target, self.target)
                return f
        f.image = resize_bilinear(img, self.target, self.target)
        return f


class ImageFrameToSample(FeatureTransformer):
    """Attach ``f["sample"]``, a Sample of (image, label); ``to_chw``
    transposes HWC -> CHW (False for an NHWC model)."""

    def __init__(self, to_chw: bool = True):
        self.to_chw = to_chw

    def transform(self, f):
        img = f.image
        if self.to_chw and img.ndim == 3:
            img = np.ascontiguousarray(img.transpose(2, 0, 1))
        f["sample"] = Sample(img, f.label)
        return f

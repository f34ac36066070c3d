"""Image pipeline: ImageFeature, ImageFrame, FeatureTransformer and the
augmentation op set (port of ``bigdl_tpu/transform/vision.py``).

The image payload is a float32 HWC numpy array and every op is the
reference's numpy code over ``utils/imgops.py``, so the same image and
seed give the same float array bit for bit.  Augmentation runs on the host
ahead of the copy to the card.  ``ImageFrame.read`` reads a folder of
images through PIL into a :class:`LocalImageFrame`; a distributed frame is
a per-process shard of samples (``DistributedDataSet``), built after the
samples.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.utils.imgops import (ThreadRng, color_jitter, hsv_to_rgb,
                                          lighting_delta, resize_bilinear,
                                          rgb_to_hsv)

_rgb_to_hsv = rgb_to_hsv
_hsv_to_rgb = hsv_to_rgb
_resize_bilinear = resize_bilinear


class ImageFeature(dict):
    """Mutable record flowing through the pipeline (reference
    ``ImageFeature.scala:36``).  Well-known keys mirror the reference's:
    ``floats`` (the HWC float32 image), ``label``, ``original_size``,
    ``uri``, plus anything a transformer wants to stash."""

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
    """Composable ImageFeature→ImageFeature op (reference
    ``FeatureTransformer.scala``; compose with ``>>`` like dataset
    transformers)."""

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


class ImageFrame:
    """Collection of ImageFeatures (reference ``ImageFrame.scala``).
    ``ImageFrame.read``/``array`` build a Local frame; the Distributed
    variant's role (an RDD of features) is covered by per-host sharding in
    ``dataset.DistributedDataSet`` — build samples first, then shard."""

    @staticmethod
    def array(images: Sequence, labels: Optional[Sequence] = None
              ) -> "LocalImageFrame":
        feats = [ImageFeature(img,
                              None if labels is None else labels[i])
                 for i, img in enumerate(images)]
        return LocalImageFrame(feats)

    @staticmethod
    def read(path: str, with_label: bool = False) -> "LocalImageFrame":
        """Read a directory of images into a Local frame (reference
        ``ImageFrame.read`` / ``DLImageReader``).  ``with_label=True``
        uses the ImageNet folder convention — one subdirectory per
        class, labels assigned by sorted subdirectory order."""
        import os
        from PIL import Image

        exts = (".jpg", ".jpeg", ".png", ".bmp")

        def load(p):
            return np.asarray(Image.open(p).convert("RGB"), np.float32)

        feats: List[ImageFeature] = []
        if with_label:
            classes = sorted(d for d in os.listdir(path)
                             if os.path.isdir(os.path.join(path, d)))
            for label, cls in enumerate(classes):
                cdir = os.path.join(path, cls)
                for fn in sorted(os.listdir(cdir)):
                    if fn.lower().endswith(exts):
                        feats.append(ImageFeature(
                            load(os.path.join(cdir, fn)),
                            label=np.int32(label),
                            uri=os.path.join(cls, fn)))
        else:
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith(exts):
                    feats.append(ImageFeature(
                        load(os.path.join(path, fn)), uri=fn))
        return LocalImageFrame(feats)


class LocalImageFrame(ImageFrame):
    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    def transform(self, t: FeatureTransformer) -> "LocalImageFrame":
        self.features = [t(f) for f in self.features]
        return self

    def __rshift__(self, t: FeatureTransformer) -> "LocalImageFrame":
        return self.transform(t)

    def to_samples(self) -> List[Sample]:
        return [Sample(f.image, f.label) for f in self.features]

    def __len__(self):
        return len(self.features)


# ----------------------------------------------------------- pixel-level ops
class Brightness(FeatureTransformer):
    """Add a uniform delta (reference ``augmentation/Brightness.scala``)."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 0):
        self.low, self.high = delta_low, delta_high
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        f.image = f.image + self._rng.uniform(self.low, self.high)
        return f


class Contrast(FeatureTransformer):
    """Scale around zero (reference ``augmentation/Contrast.scala``)."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 0):
        self.low, self.high = delta_low, delta_high
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        f.image = f.image * self._rng.uniform(self.low, self.high)
        return f


class Saturation(FeatureTransformer):
    """Scale HSV saturation (reference ``augmentation/Saturation.scala``)."""

    def __init__(self, delta_low: float, delta_high: float, seed: int = 0):
        self.low, self.high = delta_low, delta_high
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        hsv = _rgb_to_hsv(np.clip(f.image, 0, 255))
        hsv[..., 1] = np.clip(hsv[..., 1]
                              * self._rng.uniform(self.low, self.high), 0, 1)
        f.image = _hsv_to_rgb(hsv).astype(np.float32)
        return f


class Hue(FeatureTransformer):
    """Rotate HSV hue by a random delta in degrees (reference
    ``augmentation/Hue.scala``)."""

    def __init__(self, delta_low: float = -18.0, delta_high: float = 18.0,
                 seed: int = 0):
        self.low, self.high = delta_low, delta_high
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        hsv = _rgb_to_hsv(np.clip(f.image, 0, 255))
        hsv[..., 0] = (hsv[..., 0]
                       + self._rng.uniform(self.low, self.high)) % 360.0
        f.image = _hsv_to_rgb(hsv).astype(np.float32)
        return f


class ChannelNormalize(FeatureTransformer):
    """(x - mean) / std per channel (reference ``ChannelNormalize.scala``)."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def transform(self, f):
        f.image = (f.image - self.mean) / self.std
        return f


class ChannelScaledNormalizer(FeatureTransformer):
    """(x - mean_c) * scale per channel (reference
    ``augmentation/ChannelScaledNormalizer.scala:42`` — integer
    per-channel means with one shared scale factor)."""

    def __init__(self, mean_r: int, mean_g: int, mean_b: int,
                 scale: float):
        self.mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self.scale = float(scale)

    def transform(self, f):
        f.image = ((f.image - self.mean) * self.scale).astype(np.float32)
        return f


class PixelNormalizer(FeatureTransformer):
    """Subtract a per-pixel mean image (reference ``PixelNormalizer.scala``)."""

    def __init__(self, means: np.ndarray):
        self.means = np.asarray(means, np.float32)

    def transform(self, f):
        f.image = f.image - self.means
        return f


class ChannelOrder(FeatureTransformer):
    """Swap RGB↔BGR (reference ``ChannelOrder.scala``)."""

    def transform(self, f):
        f.image = np.ascontiguousarray(f.image[..., ::-1])
        return f


# ------------------------------------------------------------ geometric ops
class Resize(FeatureTransformer):
    """Resize to (h, w) (reference ``augmentation/Resize.scala``)."""

    def __init__(self, resize_h: int, resize_w: int):
        self.h, self.w = resize_h, resize_w

    def transform(self, f):
        f.image = _resize_bilinear(f.image, self.h, self.w)
        return f


class AspectScale(FeatureTransformer):
    """Scale the short edge to ``min_size`` keeping aspect ratio, capped at
    ``max_size`` (reference ``AspectScale.scala`` — the Faster-RCNN
    convention)."""

    def __init__(self, min_size: int, max_size: int = 1000):
        self.min_size, self.max_size = min_size, max_size

    def transform(self, f):
        h, w = f.image.shape[:2]
        scale = self.min_size / min(h, w)
        if scale * max(h, w) > self.max_size:
            scale = self.max_size / max(h, w)
        f.image = _resize_bilinear(f.image, int(round(h * scale)),
                                   int(round(w * scale)))
        f["scale"] = scale
        return f


class RandomResize(FeatureTransformer):
    """Resize the SHORT edge to a uniform random size in
    ``[min_size, max_size]``, scaling the long edge to preserve aspect
    ratio (reference ``augmentation/RandomResize.scala:32``)."""

    def __init__(self, min_size: int, max_size: int, seed: int = 0):
        if max_size < min_size:
            raise ValueError("max_size must be >= min_size")
        self.min_size, self.max_size = min_size, max_size
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        h, w = f.image.shape[:2]
        short = self.min_size + int(self._rng.uniform(
            1e-2, self.max_size - self.min_size + 1))
        if h < w:
            w = int(w / h * short)
            h = short
        else:
            h = int(h / w * short)
            w = short
        f.image = _resize_bilinear(f.image, h, w)
        return f


class RandomAspectScale(AspectScale):
    """Pick the short-edge target randomly from ``scales`` (reference
    ``RandomAspectScale.scala``)."""

    def __init__(self, scales: Sequence[int], max_size: int = 1000,
                 seed: int = 0):
        super().__init__(scales[0], max_size)
        self.scales = list(scales)
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        # no shared-state write (``self.min_size``) — transforms run on
        # multiple prefetch worker threads
        min_size = int(self._rng.choice(self.scales))
        h, w = f.image.shape[:2]
        scale = min_size / min(h, w)
        if scale * max(h, w) > self.max_size:
            scale = self.max_size / max(h, w)
        f.image = _resize_bilinear(f.image, int(round(h * scale)),
                                   int(round(w * scale)))
        f["scale"] = scale
        return f


class CenterCrop(FeatureTransformer):
    """(reference ``augmentation/CenterCrop.scala``)."""

    def __init__(self, crop_h: int, crop_w: int):
        self.ch, self.cw = crop_h, crop_w

    def transform(self, f):
        h, w = f.image.shape[:2]
        y, x = (h - self.ch) // 2, (w - self.cw) // 2
        f.image = np.ascontiguousarray(
            f.image[y:y + self.ch, x:x + self.cw])
        return f


class RandomCrop(FeatureTransformer):
    """(reference ``augmentation/RandomCropper.scala``)."""

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


class FixedCrop(FeatureTransformer):
    """Crop a fixed normalized or absolute box (reference
    ``FixedCrop.scala``)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 normalized: bool = True):
        self.box = (x1, y1, x2, y2)
        self.normalized = normalized

    def transform(self, f):
        h, w = f.image.shape[:2]
        x1, y1, x2, y2 = self.box
        if self.normalized:
            x1, x2 = x1 * w, x2 * w
            y1, y2 = y1 * h, y2 * h
        f.image = np.ascontiguousarray(
            f.image[int(y1):int(y2), int(x1):int(x2)])
        return f


class Expand(FeatureTransformer):
    """Place the image on a larger mean-filled canvas (reference
    ``augmentation/Expand.scala`` — SSD zoom-out)."""

    def __init__(self, means: Sequence[float] = (123.0, 117.0, 104.0),
                 max_expand_ratio: float = 4.0, seed: int = 0):
        self.means = np.asarray(means, np.float32)
        self.max_ratio = max_expand_ratio
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        img = f.image
        h, w = img.shape[:2]
        ratio = self._rng.uniform(1.0, self.max_ratio)
        nh, nw = int(h * ratio), int(w * ratio)
        canvas = np.broadcast_to(self.means, (nh, nw, img.shape[2])).copy() \
            if img.ndim == 3 else np.full((nh, nw), self.means.mean(),
                                          np.float32)
        y = int(self._rng.integers(0, nh - h + 1))
        x = int(self._rng.integers(0, nw - w + 1))
        canvas[y:y + h, x:x + w] = img
        f.image = canvas.astype(np.float32)
        f["expand_offset"] = (x, y, ratio)
        return f


class Filler(FeatureTransformer):
    """Fill a sub-rectangle with a constant (reference
    ``augmentation/Filler.scala`` — random-erasing style)."""

    def __init__(self, x1: float, y1: float, x2: float, y2: float,
                 value: float = 255.0):
        self.box = (x1, y1, x2, y2)
        self.value = value

    def transform(self, f):
        h, w = f.image.shape[:2]
        x1, y1, x2, y2 = self.box
        f.image[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = self.value
        return f


class HFlip(FeatureTransformer):
    """(reference ``augmentation/HFlip.scala``)."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        if self._rng.random() < self.threshold:
            f.image = np.ascontiguousarray(f.image[:, ::-1])
        return f


class RandomAlterAspect(FeatureTransformer):
    """Random-area/aspect crop then resize — the Inception training crop
    (reference ``augmentation/RandomAlterAspect.scala``)."""

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
                f.image = _resize_bilinear(crop, self.target, self.target)
                return f
        f.image = _resize_bilinear(img, self.target, self.target)
        return f


class ColorJitter(FeatureTransformer):
    """Random brightness/contrast/saturation in random order (reference
    ``augmentation/ColorJitter.scala``)."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        self.b, self.c, self.s = brightness, contrast, saturation
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        f.image = color_jitter(f.image, self._rng, self.b, self.c, self.s)
        return f


class Lighting(FeatureTransformer):
    """AlexNet PCA lighting (reference ``augmentation/Lighting.scala``)."""

    def __init__(self, alphastd: float = 0.1, seed: int = 0):
        self.alphastd = alphastd
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        f.image = f.image + lighting_delta(self._rng, self.alphastd)
        return f


class RandomTransformer(FeatureTransformer):
    """Apply the inner transformer with probability p (reference
    ``RandomTransformer.scala``)."""

    def __init__(self, inner: FeatureTransformer, prob: float,
                 seed: int = 0):
        self.inner = inner
        self.prob = prob
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def transform(self, f):
        return self.inner(f) if self._rng.random() < self.prob else f


class MatToFloats(FeatureTransformer):
    """No-op layout hook kept for API parity (reference
    ``MatToFloats.scala`` converts OpenCV Mat → float array; images here
    are already float arrays)."""

    def transform(self, f):
        f.image = np.asarray(f.image, np.float32)
        return f


class ImageFrameToSample(FeatureTransformer):
    """Attach a Sample built from (image, label) (reference
    ``ImageFrameToSample.scala``); ``to_chw`` transposes HWC→CHW."""

    def __init__(self, to_chw: bool = True):
        self.to_chw = to_chw

    def transform(self, f):
        img = f.image
        if self.to_chw and img.ndim == 3:
            img = np.ascontiguousarray(img.transpose(2, 0, 1))
        f["sample"] = Sample(img, f.label)
        return f

"""Image transformers (port of ``bigdl_tpu/dataset/image.py``):
host-side numpy, Sample to Sample.  Greyscale images flow as float32
(H, W), colour images as float32 (H, W, C):
``dataset >> BGRImgNormalizer(mean, std) >> RandomCropper(32, 32, pad=4)
>> HFlip() >> ChannelOrder("CHW") >> SampleToMiniBatch(b)``.  The random
ops draw through ``ThreadRng`` with the reference's seeds and salts (the
class name), so a pipeline gives the reference's arrays bit for bit."""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.imgops import (ThreadRng, color_jitter,
                                          lighting_delta)


class _SampleMap(Transformer):
    def _map(self, s: Sample) -> Sample:
        raise NotImplementedError

    def __call__(self, it):
        return (self._map(s) for s in it)


class BytesToGreyImg(_SampleMap):
    """uint8 (H, W) -> float32."""

    def _map(self, s):
        return Sample(s.feature.astype(np.float32), s.label)


class GreyImgNormalizer(_SampleMap):
    """(x - mean) / std in float32."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def _map(self, s):
        f = (s.feature.astype(np.float32) - self.mean) / self.std
        return Sample(f, s.label)


class GreyImgToSample(_SampleMap):
    """Add the channel axis: (H, W) -> (1, H, W)."""

    def _map(self, s):
        return Sample(s.feature[None, :, :].astype(np.float32), s.label)


class BGRImgNormalizer(_SampleMap):
    """Per-channel (x - mean) / std on (H, W, C)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def _map(self, s):
        return Sample((s.feature - self.mean) / self.std, s.label)


class HFlip(_SampleMap):
    """Random horizontal flip of (H, W[, C])."""

    def __init__(self, threshold: float = 0.5, seed: int = 0):
        self.threshold = threshold
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def _map(self, s):
        if self._rng.random() < self.threshold:
            return Sample(np.ascontiguousarray(s.feature[:, ::-1]), s.label)
        return s


class RandomCropper(_SampleMap):
    """Random crop to (h, w), optionally after zero padding (the CIFAR
    recipe pads 4 then crops 32).  A 3-D feature with at most 4 leading
    entries is read as (C, H, W), else as (H, W[, C])."""

    def __init__(self, crop_h: int, crop_w: int, pad: int = 0, seed: int = 0):
        self.crop_h, self.crop_w, self.pad = crop_h, crop_w, pad
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def _map(self, s):
        f = s.feature
        chw = f.ndim == 3 and f.shape[0] <= 4
        if self.pad:
            if chw:
                f = np.pad(f, ((0, 0), (self.pad, self.pad),
                               (self.pad, self.pad)))
            elif f.ndim == 3:
                f = np.pad(f, ((self.pad, self.pad), (self.pad, self.pad),
                               (0, 0)))
            else:
                f = np.pad(f, self.pad)
        H, W = (f.shape[1], f.shape[2]) if chw else (f.shape[0], f.shape[1])
        y = self._rng.integers(0, H - self.crop_h + 1)
        x = self._rng.integers(0, W - self.crop_w + 1)
        if chw:
            out = f[:, y:y + self.crop_h, x:x + self.crop_w]
        else:
            out = f[y:y + self.crop_h, x:x + self.crop_w]
        return Sample(np.ascontiguousarray(out), s.label)


class CenterCropper(_SampleMap):
    """The centred (h, w) crop; the same layout rule as RandomCropper."""

    def __init__(self, crop_h: int, crop_w: int):
        self.crop_h, self.crop_w = crop_h, crop_w

    def _map(self, s):
        f = s.feature
        chw = f.ndim == 3 and f.shape[0] <= 4
        H, W = (f.shape[1], f.shape[2]) if chw else (f.shape[0], f.shape[1])
        y, x = (H - self.crop_h) // 2, (W - self.crop_w) // 2
        out = f[:, y:y + self.crop_h, x:x + self.crop_w] if chw \
            else f[y:y + self.crop_h, x:x + self.crop_w]
        return Sample(np.ascontiguousarray(out), s.label)


class ColorJitter(_SampleMap):
    """Random brightness, contrast and saturation on (H, W, C) float
    images, in a random order."""

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, seed: int = 0):
        self.b, self.c, self.s = brightness, contrast, saturation
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def _map(self, s):
        return Sample(color_jitter(s.feature.astype(np.float32), self._rng,
                                   self.b, self.c, self.s), s.label)


class Lighting(_SampleMap):
    """AlexNet-style PCA lighting noise (the ImageNet eigen constants live
    in ``utils/imgops``)."""

    def __init__(self, alphastd: float = 0.1, seed: int = 0):
        self.alphastd = alphastd
        self._rng = ThreadRng(seed, salt=type(self).__name__)

    def _map(self, s):
        return Sample(s.feature + lighting_delta(self._rng, self.alphastd),
                      s.label)


class ChannelOrder(_SampleMap):
    """(H, W, C) -> (C, H, W) with ``to="CHW"``, back with ``"HWC"``."""

    def __init__(self, to: str = "CHW"):
        self.to = to

    def _map(self, s):
        f = s.feature
        if self.to == "CHW" and f.ndim == 3:
            return Sample(np.ascontiguousarray(f.transpose(2, 0, 1)), s.label)
        if self.to == "HWC" and f.ndim == 3:
            return Sample(np.ascontiguousarray(f.transpose(1, 2, 0)), s.label)
        return s

"""Greyscale image transformers (port of ``bigdl_tpu/dataset/image.py``,
the MNIST recipe's part): host-side numpy, Sample to Sample.  Greyscale
images flow as float32 (H, W):
``dataset >> BytesToGreyImg() >> GreyImgNormalizer(mean, std) >>
SampleToMiniBatch(b)``.  The colour ops are not ported yet."""

from __future__ import annotations

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer


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

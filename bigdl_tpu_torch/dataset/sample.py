"""Sample and MiniBatch (port of ``bigdl_tpu/dataset/sample.py``, the dense
part).  Host-side data is numpy; the training driver stages it on the
device.  Padding of ragged samples (``PaddingParam``) and the sparse
samples are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Sample:
    """One training example: a feature array and an optional label."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label

    def __repr__(self):
        ls = None if self.label is None else np.shape(self.label)
        return f"Sample(feature={np.shape(self.feature)}, label={ls})"


class MiniBatch:
    """Batched input/target arrays with a leading batch axis."""

    __slots__ = ("input", "target")

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def size(self) -> int:
        return self.input.shape[0]

    def __repr__(self):
        return f"MiniBatch(size={self.size()})"


def batch_samples(samples: Sequence[Sample]) -> MiniBatch:
    """Stack samples of one shape into a MiniBatch."""
    feats = np.stack([np.asarray(s.feature) for s in samples])
    if samples[0].label is None:
        return MiniBatch(feats, None)
    return MiniBatch(feats, np.stack([np.asarray(s.label) for s in samples]))

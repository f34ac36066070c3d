"""CIFAR-10 loaders and their synthetic stand-in (port of
``bigdl_tpu/dataset/cifar.py``).

``load_cifar10`` reads either on-disk format: the ``cifar-10-batches-bin``
records (1 label byte + 3072 RGB bytes) or the ``cifar-10-batches-py``
pickles; nothing is downloaded.  ``synthetic_cifar`` makes a deterministic
CIFAR-shaped set in numpy, bitwise the reference's arrays for the same
arguments.  The recipes normalise with the per-channel train statistics
below and augment with a pad-4 random crop and a horizontal flip.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

# per-channel RGB statistics of the CIFAR-10 train split on the [0, 255]
# scale (trainMean = (0.4914, 0.4822, 0.4465), trainStd = (0.2470, 0.2435,
# 0.2616) on [0, 1])
TRAIN_MEAN = (125.31, 122.95, 113.87)
TRAIN_STD = (62.99, 62.09, 66.70)


def _load_bin_file(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    images = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return images, labels  # (N, 32, 32, 3) uint8 RGB, (N,)


def _load_py_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # the dataset's own pickle format; read only files the caller names
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d.get(b"labels", d.get(b"fine_labels")), np.int32)
    return images, labels


def load_cifar10(folder: str, train: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 32, 32, 3) uint8 RGB, labels int32) from ``folder``,
    which holds the binary batches (``data_batch_1.bin``...) or the python
    batches (``data_batch_1``...), directly or in their extracted
    directory."""
    bin_names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                 if train else ["test_batch.bin"])
    py_names = ([f"data_batch_{i}" for i in range(1, 6)]
                if train else ["test_batch"])
    for names, loader in ((bin_names, _load_bin_file),
                          (py_names, _load_py_batch)):
        paths = [os.path.join(folder, n) for n in names]
        for sub in ("cifar-10-batches-bin", "cifar-10-batches-py"):
            alt = [os.path.join(folder, sub, n) for n in names]
            if all(os.path.exists(p) for p in alt):
                paths = alt
        if all(os.path.exists(p) for p in paths):
            parts = [loader(p) for p in paths]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    raise FileNotFoundError(f"no CIFAR-10 batches under {folder}")


def synthetic_cifar(n: int = 2048, n_classes: int = 10, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` CIFAR-shaped images (uint8 HWC) and labels (int32): dim noise
    plus a bright square whose place and channel depend on the class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    images = rng.integers(0, 40, (n, 32, 32, 3)).astype(np.float32)
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 4)
        images[i, r * 8:(r + 1) * 8, c * 8:(c + 1) * 8, y % 3] += 180.0
    return images.astype(np.uint8), labels


def to_samples(images: np.ndarray, labels: np.ndarray) -> List[Sample]:
    """uint8 HWC images and int labels -> Samples of float32 features."""
    return [Sample(images[i].astype(np.float32), np.int32(labels[i]))
            for i in range(len(images))]

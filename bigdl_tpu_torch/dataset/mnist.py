"""MNIST idx-format loader and its synthetic stand-in (port of
``bigdl_tpu/dataset/mnist.py``).

``load_mnist`` reads local idx files (gzipped or not); nothing is
downloaded.  ``synthetic_mnist`` makes a deterministic MNIST-shaped
classification set in numpy, bitwise the reference's arrays for the same
arguments: each class a smoothed random template plus noise.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

TRAIN_MEAN = 0.13066047740239506 * 255
TRAIN_STD = 0.3081078 * 255
TEST_MEAN = 0.13251460696903547 * 255
TEST_STD = 0.31048024 * 255


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def read_idx_images(path: str) -> np.ndarray:
    """uint8 (N, rows, cols) from an idx3 file."""
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad image idx magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """int32 (N,) from an idx1 file."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad label idx magic {magic}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def load_mnist(folder: str, train: bool = True):
    """(images uint8 (N, 28, 28), labels int32 (N,)) from the standard
    file names under ``folder``, gzipped or not."""
    prefix = "train" if train else "t10k"
    img, lbl = None, None
    for suff in ("-images-idx3-ubyte", "-images.idx3-ubyte"):
        for ext in ("", ".gz"):
            p = os.path.join(folder, prefix + suff + ext)
            if os.path.exists(p):
                img = read_idx_images(p)
    for suff in ("-labels-idx1-ubyte", "-labels.idx1-ubyte"):
        for ext in ("", ".gz"):
            p = os.path.join(folder, prefix + suff + ext)
            if os.path.exists(p):
                lbl = read_idx_labels(p)
    if img is None or lbl is None:
        raise FileNotFoundError(f"no MNIST idx files under {folder}")
    return img, lbl


def synthetic_mnist(n: int = 2048, n_classes: int = 10, seed: int = 0,
                    size: int = 28, template_seed: int = 1234):
    """``n`` MNIST-shaped images (uint8) and labels (int32): class
    templates fixed by ``template_seed`` (so two ``seed`` s give train and
    validation splits of the same task), noise and labels by ``seed``."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(template_seed).normal(
        0, 1, (n_classes, size, size))
    # a 5x5 box filter over the edge-padded template, summed window by
    # window in the reference's order
    k = np.ones((5, 5)) / 25.0
    for c in range(n_classes):
        t = templates[c]
        padded = np.pad(t, 2, mode="edge")
        sm = np.zeros_like(t)
        for i in range(size):
            for j in range(size):
                sm[i, j] = np.sum(padded[i:i + 5, j:j + 5] * k)
        templates[c] = sm
    templates = (templates - templates.min()) / np.ptp(templates) * 200
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    images = templates[labels] + rng.normal(0, 20, (n, size, size))
    images = np.clip(images, 0, 255).astype(np.uint8)
    return images, labels


def to_samples(images: np.ndarray, labels: np.ndarray):
    return [Sample(images[i], labels[i]) for i in range(len(labels))]

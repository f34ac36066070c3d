"""Host-side image math and the per-sample RNG of the augmentation
pipeline (port of ``bigdl_tpu/utils/imgops.py``: the part the ImageNet
and CIFAR-10 recipes' transforms call).

A copy of the reference's numpy code, kept so the port does not import the
reference package: the same sample and seed give the same float array,
bit for bit.

``ThreadRng`` exists because the transforms run under the multi-worker
batch assembler (``dataset/prefetch.py``): numpy's ``Generator`` is not
thread-safe, so each worker thread gets its own.  Per-thread streams alone
are not run-to-run deterministic (which sample lands on which thread is up
to the scheduler), so the assembler brackets each transform call in
:func:`sample_key`, and ``ThreadRng`` then derives every draw from ``(seed,
instance salt, sample key)``: a pure function of the data stream.
"""

from __future__ import annotations

import contextlib
import threading
import zlib

import numpy as np

_sample_key = threading.local()


@contextlib.contextmanager
def sample_key(key: int):
    """Pin the active per-sample RNG key for the current thread (set by
    the batch assembler around each per-sample transform call)."""
    prev = getattr(_sample_key, "key", None)
    _sample_key.key = key
    try:
        yield
    finally:
        _sample_key.key = prev


# eigen decomposition of ImageNet RGB covariance (AlexNet lighting noise;
# reference ``Lighting.scala`` constants)
LIGHTING_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
LIGHTING_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]], np.float32)


class ThreadRng:
    """Per-thread numpy Generators derived from one seed; the part of
    ``np.random.Generator``'s interface the ported transforms use.  Under an
    active :func:`sample_key`, draws come from a generator seeded by
    ``(seed, crc32(salt), key)``; ``salt`` (conventionally the owning
    transform's class name) keeps two transforms of one seed from drawing
    the same stream."""

    def __init__(self, seed: int = 0, salt: str = ""):
        self._seed = seed
        self._salt = zlib.crc32(salt.encode())
        self._seed_seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _gen(self) -> np.random.Generator:
        key = getattr(_sample_key, "key", None)
        if key is not None:
            cached = getattr(self._local, "keyed", None)
            if cached is None or cached[0] != key:
                g = np.random.default_rng(
                    np.random.SeedSequence((self._seed, self._salt, key)))
                self._local.keyed = (key, g)
            return self._local.keyed[1]
        g = getattr(self._local, "gen", None)
        if g is None:
            with self._lock:
                child = self._seed_seq.spawn(1)[0]
            g = np.random.default_rng(child)
            self._local.gen = g
        return g

    def random(self):
        return self._gen().random()

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._gen().uniform(low, high, size)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._gen().normal(loc, scale, size)

    def integers(self, low, high=None, size=None):
        return self._gen().integers(low, high, size)

    def permutation(self, n):
        return self._gen().permutation(n)

    def choice(self, a, size=None, p=None):
        return self._gen().choice(a, size=size, p=p)


def lighting_delta(rng, alphastd: float) -> np.ndarray:
    """Per-image RGB offset of AlexNet PCA lighting noise."""
    alpha = np.asarray(rng.normal(0, alphastd, 3), np.float32)
    return (LIGHTING_EIGVEC * alpha * LIGHTING_EIGVAL).sum(axis=1)


def color_jitter(img: np.ndarray, rng, brightness: float, contrast: float,
                 saturation: float) -> np.ndarray:
    """Random brightness/contrast/saturation in random order (reference
    ``ColorJitter.scala`` semantics on float images)."""
    for op in rng.permutation(3):
        if op == 0 and brightness:
            img = img * (1 + rng.uniform(-brightness, brightness))
        elif op == 1 and contrast:
            m = img.mean()
            img = (img - m) * (1 + rng.uniform(-contrast, contrast)) + m
        elif op == 2 and saturation and img.ndim == 3:
            grey = img.mean(-1, keepdims=True)
            img = grey + (img - grey) * (1 + rng.uniform(-saturation,
                                                         saturation))
    return np.asarray(img, np.float32)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """Vectorized RGB[0,255]→HSV (H in degrees [0,360))."""
    x = img / 255.0
    mx = x.max(-1)
    mn = x.min(-1)
    diff = mx - mn + 1e-12
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    h = np.where(mx == r, (g - b) / diff % 6,
                 np.where(mx == g, (b - r) / diff + 2, (r - g) / diff + 4))
    h = h * 60.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return np.stack([h, s, mx], -1)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    c = v * s
    xm = c * (1 - np.abs(h % 2 - 1))
    m = v - c
    z = np.zeros_like(c)
    i = (h.astype(np.int32) % 6)[..., None]
    rgb = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([c, xm, z], -1), np.stack([xm, c, z], -1),
         np.stack([z, c, xm], -1), np.stack([z, xm, c], -1),
         np.stack([xm, z, c], -1), np.stack([c, z, xm], -1)])
    return (rgb + m[..., None]) * 255.0


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-numpy bilinear resize, align_corners=False convention."""
    h, w = img.shape[:2]
    if h == out_h and w == out_w:
        return img.copy()
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None]
    wx = np.clip(xs - x0, 0, 1)[None, :]
    if img.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)

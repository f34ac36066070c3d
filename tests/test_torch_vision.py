"""The image pipeline of the port (``transform/vision.py``) on the CPU
against the reference's: every op on seeded float images, its random
draws (``ThreadRng``, with and without a per-sample key) included, must
give the reference's float array BIT FOR BIT, and the keys it stashes
(``scale``, ``expand_offset``) equal.  ``ImageFrame.read`` over a folder
of PNGs the test writes reads what the reference reads, labels and uris
too, and the image-classification chain over it is bitwise.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu.transform import vision as J  # noqa: E402
from bigdl_tpu.utils.imgops import sample_key as jsample_key  # noqa: E402
from bigdl_tpu_torch.transform import vision as T  # noqa: E402
from bigdl_tpu_torch.utils.imgops import sample_key  # noqa: E402


def _images(n=3, h=17, w=23, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
            for _ in range(n)]


# name: op of either module; the 19 names the port added, then the 10 it
# had (their draws ride on the same ThreadRng)
OPS = {
    "AspectScale": lambda m: m.AspectScale(20, max_size=30),
    "RandomAspectScale": lambda m: m.RandomAspectScale([12, 20, 28],
                                                       max_size=40, seed=3),
    "RandomResize": lambda m: m.RandomResize(10, 30, seed=4),
    "MatToFloats": lambda m: m.MatToFloats(),
    "Brightness": lambda m: m.Brightness(-32.0, 32.0, seed=5),
    "Contrast": lambda m: m.Contrast(0.5, 1.5, seed=6),
    "Saturation": lambda m: m.Saturation(0.5, 1.5, seed=7),
    "Hue": lambda m: m.Hue(-18.0, 18.0, seed=8),
    "ColorJitter": lambda m: m.ColorJitter(0.4, 0.4, 0.4, seed=9),
    "Lighting": lambda m: m.Lighting(0.1, seed=10),
    "ChannelOrder": lambda m: m.ChannelOrder(),
    "ChannelScaledNormalizer": lambda m: m.ChannelScaledNormalizer(
        104, 117, 123, 0.017),
    "PixelNormalizer": lambda m: m.PixelNormalizer(
        np.random.default_rng(11).uniform(0, 255, (17, 23, 3))),
    "Expand": lambda m: m.Expand(max_expand_ratio=2.5, seed=12),
    "Filler": lambda m: m.Filler(0.1, 0.2, 0.6, 0.7, value=3.0),
    "FixedCrop": lambda m: m.FixedCrop(0.1, 0.2, 0.8, 0.9),
    "FixedCrop-absolute": lambda m: m.FixedCrop(2, 3, 15, 12,
                                                normalized=False),
    "RandomTransformer": lambda m: m.RandomTransformer(
        m.Brightness(-10.0, 10.0, seed=13), 0.5, seed=14),
    "ChannelNormalize": lambda m: m.ChannelNormalize((123.0, 117.0, 104.0),
                                                     (58.4, 57.1, 57.4)),
    "Resize": lambda m: m.Resize(9, 31),
    "CenterCrop": lambda m: m.CenterCrop(11, 13),
    "RandomCrop": lambda m: m.RandomCrop(11, 13, pad=2, seed=15),
    "HFlip": lambda m: m.HFlip(0.5, seed=16),
    "RandomAlterAspect": lambda m: m.RandomAlterAspect(target_size=15,
                                                       seed=17),
    "ImageFrameToSample": lambda m: m.ImageFrameToSample(to_chw=True),
}


def _run(mod, name, images, keyed):
    op = OPS[name](mod)
    key_ctx = sample_key if mod is T else jsample_key
    out = []
    for i, img in enumerate(images):
        f = mod.ImageFeature(img.copy(), label=np.int32(i))
        if keyed:
            with key_ctx(100 + i):
                f = op(f)
        else:
            f = op(f)
        out.append(f)
    return out


@pytest.mark.parametrize("keyed", [False, True], ids=["stream", "keyed"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_op_bitwise_to_reference(name, keyed):
    images = _images(seed=len(name))
    got = _run(T, name, images, keyed)
    want = _run(J, name, images, keyed)
    for g, w in zip(got, want):
        assert g.image.dtype == w.image.dtype
        np.testing.assert_array_equal(g.image, w.image)
        assert set(g) == set(w)
        for k in ("scale", "expand_offset", "label", "originalSize"):
            if k in w:
                assert g[k] == w[k], k
        if "sample" in w:
            np.testing.assert_array_equal(g["sample"].feature,
                                          w["sample"].feature)
            assert g["sample"].label == w["sample"].label


def test_chain_and_frame_api():
    images = _images(4, seed=1)

    def chain(m):
        frame = m.ImageFrame.array(images, labels=list(range(4)))
        frame = (frame >> m.AspectScale(32) >> m.CenterCrop(24, 24)
                 >> m.ColorJitter(seed=2) >> m.Lighting(seed=3)
                 >> m.MatToFloats() >> m.ImageFrameToSample())
        return frame

    got, want = chain(T), chain(J)
    assert isinstance(got, T.LocalImageFrame) and len(got) == len(want) == 4
    for g, w in zip(got.to_samples(), want.to_samples()):
        np.testing.assert_array_equal(g.feature, w.feature)
        assert g.label == w.label


@pytest.mark.parametrize("with_label", [False, True],
                         ids=["flat", "class_folders"])
def test_image_frame_read_and_the_prediction_chain(tmp_path, with_label):
    """``ImageFrame.read`` over PNGs (and a file it must skip), then the
    image-classification example's chain: bitwise to the reference."""
    from PIL import Image
    rng = np.random.default_rng(4)
    folders = ["cat", "dog"] if with_label else [""]
    for d in folders:
        os.makedirs(tmp_path / d, exist_ok=True)
        for i in range(3):
            arr = rng.integers(0, 256, (28, 36, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / d / f"img_{i}.png")
        (tmp_path / d / "notes.txt").write_text("not an image")

    def chain(m):
        frame = m.ImageFrame.read(str(tmp_path), with_label=with_label)
        return frame >> (m.AspectScale(32) >> m.CenterCrop(24, 24)
                         >> m.ChannelNormalize((123.0, 117.0, 104.0),
                                               (58.4, 57.1, 57.4))
                         >> m.MatToFloats()
                         >> m.ImageFrameToSample(to_chw=True))

    got, want = chain(T), chain(J)
    assert len(got) == len(want) == 3 * len(folders)
    for g, w in zip(got.features, want.features):
        assert g[T.ImageFeature.URI] == w[J.ImageFeature.URI]
        assert g.label == w.label
        assert g["sample"].feature.shape == (3, 24, 24)
        np.testing.assert_array_equal(g["sample"].feature,
                                      w["sample"].feature)

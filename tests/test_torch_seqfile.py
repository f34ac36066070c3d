"""Hadoop SequenceFiles in the port (``dataset/seqfile.py``) on the CPU,
against the reference, and the recipe's seqfile input
(``examples/resnet/train_imagenet.py --seqfiles``).

- Both packages' writers give byte-identical files, plain,
  record-compressed and block-compressed, with Text and BytesWritable
  values and several sync intervals; each package reads the other's
  files back to the records written.
- The reference's ``test_data_pipeline.py`` and ``test_round3_closures.py``
  seqfile cases on the port: sync markers, the ImageNet key convention,
  VInt edge cases, block and record compression, truncation detected, an
  unknown codec refused, the header's flags.
- ``image_samples``: raw square HWC uint8 records read back bitwise with
  ``label - 1`` as the recipe makes them, a record that is not a square
  refused, a wrong sync marker refused.
"""

import os
import struct

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference package imports JAX

from bigdl_tpu.dataset import seqfile as ref  # noqa: E402
from bigdl_tpu_torch.dataset import seqfile as sq  # noqa: E402


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"n{i:04d}/img{i}.JPEG\n{i % 1000 + 1}".encode(),
             rng.integers(0, 256, int(rng.integers(0, 300)),
                          dtype=np.uint8).tobytes())
            for i in range(n)]


FORMATS = {"plain": {}, "record": {"compressed": True},
           "block": {"block_compressed": True}}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("val_cls", [sq.TEXT, sq.BYTES_WRITABLE])
@pytest.mark.parametrize("sync_interval", [1, 7, 100])
def test_writers_are_byte_identical(tmp_path, fmt, val_cls, sync_interval):
    recs = _records(45)
    a, b = str(tmp_path / "port.seq"), str(tmp_path / "ref.seq")
    kw = dict(val_cls=val_cls, sync_interval=sync_interval, **FORMATS[fmt])
    sq.write_seqfile(a, recs, **kw)
    ref.write_seqfile(b, recs, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(sq.read_seqfile(b)) == recs
    assert list(ref.read_seqfile(a)) == recs


# ------------------------------------------- the reference's seqfile cases
def test_roundtrip_and_sync_markers(tmp_path):
    p = str(tmp_path / "part-0.seq")
    recs = [(f"img{i}\n{i % 7}".encode(), bytes([i % 251]) * (50 + i))
            for i in range(300)]
    sq.write_seqfile(p, recs, sync_interval=64)
    back = list(sq.read_seqfile(p))
    assert len(back) == 300 and back[0][0] == b"img0\n0"
    assert back[123][1] == recs[123][1]


def test_imagenet_key_convention(tmp_path):
    assert sq.parse_imagenet_key(b"n0123/img.jpg\n42") == \
        ("n0123/img.jpg", 42)
    assert sq.parse_imagenet_key(b"7") == (None, 7)
    p = str(tmp_path / "p.seq")
    sq.write_seqfile(p, [(b"a\n3", b"xyz"), (b"5", b"pq")])
    assert list(sq.seqfiles_to_byte_records([p])) == [(3, b"xyz"),
                                                      (5, b"pq")]


def test_vint_edge_cases():
    for v in (0, 1, -1, 127, -112, 128, -113, 1 << 20, -(1 << 20),
              (1 << 31) - 1):
        b = sq.write_vint(v)
        assert b == ref.write_vint(v)
        assert sq.read_vint(b, 0) == (v, len(b))


def test_block_compressed_roundtrip(tmp_path):
    p = str(tmp_path / "c.seq")
    recs = [(f"k{i}".encode(), f"v{i}".encode() * 10) for i in range(10)]
    sq.write_seqfile(p, recs, sync_interval=4, block_compressed=True)
    assert list(sq.read_seqfile(p)) == recs
    recs = [(f"key{i}".encode(), os.urandom(50 + i * 13)) for i in range(23)]
    sq.write_seqfile(p, recs, val_cls=sq.BYTES_WRITABLE, sync_interval=7,
                     block_compressed=True)
    assert list(sq.read_seqfile(p)) == recs
    raw = open(p, "rb").read()
    assert raw[:4] == b"SEQ\x06" and b"DefaultCodec" in raw


def test_truncation_detected(tmp_path):
    p = str(tmp_path / "t.seq")
    sq.write_seqfile(p, [(b"k", b"v" * 100)])
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-20])  # cut mid-value
    with pytest.raises(IOError, match="truncated"):
        list(sq.read_seqfile(p))


def test_record_compression_roundtrip(tmp_path):
    p = str(tmp_path / "c.seq")
    recs = [(f"k{i}".encode(), (f"payload-{i}-" * 20).encode())
            for i in range(120)]
    sq.write_seqfile(p, recs, compressed=True, sync_interval=50)
    assert list(sq.read_seqfile(p)) == recs
    assert os.path.getsize(p) < sum(len(v) for _, v in recs)


def test_unknown_codec_rejected(tmp_path):
    p = str(tmp_path / "x.seq")
    with open(p, "wb") as f:
        f.write(b"SEQ\x06")
        f.write(sq._hadoop_string(sq.TEXT))
        f.write(sq._hadoop_string(sq.TEXT))
        f.write(bytes([1, 0]))
        f.write(sq._hadoop_string("org.example.SnappyCodec"))
        f.write(struct.pack(">i", 0))
        f.write(b"\x00" * 16)
    with pytest.raises(NotImplementedError, match="codec"):
        list(sq.read_seqfile(p))


def test_corrupt_sync_marker_refused(tmp_path):
    p = str(tmp_path / "s.seq")
    sq.write_seqfile(p, _records(10), sync_interval=3)
    raw = bytearray(open(p, "rb").read())
    at = raw.index(struct.pack(">i", -1), 40) + 4  # the first in-body sync
    raw[at] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="sync"):
        list(sq.read_seqfile(p))


# ------------------------------------------------- the recipe's samples
def _recipe_samples(paths):
    """The reference recipe's own loop (train_imagenet.py:66-79), on the
    reference's reader."""
    out = []
    for label, blob in ref.seqfiles_to_byte_records(paths):
        img = np.frombuffer(blob, np.uint8)
        side = int(round((img.size / 3) ** 0.5))
        assert side * side * 3 == img.size
        out.append((img.reshape(side, side, 3), np.int32(label - 1)))
    return out


def test_image_samples_read_the_recipes_records(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (9, 12, 12, 3), dtype=np.uint8)
    labels = rng.integers(1, 1001, 9)
    recs = [(f"n{i}.JPEG\n{y}".encode(), img.tobytes())
            for i, (img, y) in enumerate(zip(imgs, labels))]
    paths = []
    for k, kw in enumerate(FORMATS.values()):
        paths.append(str(tmp_path / f"part-{k}.seq"))
        sq.write_seqfile(paths[-1], recs[3 * k:3 * k + 3], **kw)
    got = sq.image_samples(paths)
    assert len(got) == 9
    for s, img, y, (w_img, w_y) in zip(got, imgs, labels,
                                       _recipe_samples(paths)):
        assert s.feature.dtype == np.uint8 and s.feature.shape == (12, 12, 3)
        assert np.array_equal(s.feature, img) and np.array_equal(w_img, img)
        assert s.label == y - 1 == w_y and s.label.dtype == np.int32


def test_image_samples_refuse_a_record_that_is_not_square(tmp_path):
    p = str(tmp_path / "bad.seq")
    sq.write_seqfile(p, [(b"a\n1", bytes(12 * 12 * 3)),
                         (b"b\n2", bytes(12 * 13 * 3))])
    with pytest.raises(ValueError, match="not a square"):
        sq.image_samples([p])

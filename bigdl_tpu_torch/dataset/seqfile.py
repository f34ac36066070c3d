"""Hadoop SequenceFile reader and writer (port of
``bigdl_tpu/dataset/seqfile.py``, stdlib and numpy only, owned by the
port).

The ImageNet ingestion of the reference packs images into sequence files
(key a Hadoop ``Text`` ``"<name>\\n<label>"`` or ``"<label>"``, the label
1-based; value the image bytes) and training reads them back.  This module
reads and writes that container without Hadoop: plain, record-compressed
(DefaultCodec, zlib, on the values) and block-compressed files, with sync
markers.  :func:`write_seqfile` writes files byte-identical to the
reference package's (the sync marker is ``default_rng(12345).bytes(16)``).

:func:`image_samples` is the real-data input of
``examples/resnet/train_imagenet.py --seqfiles``: raw square HWC uint8
records become ``Sample``s with 0-based labels (``label - 1``).

Format (all big-endian):
  header:  b"SEQ" + version byte (6), key class (Hadoop Text string),
           value class, bool compressed, bool blockCompressed,
           [codec class], metadata count (int32) + pairs, 16-byte sync
  record:  recordLen int32, keyLen int32, key bytes, value bytes;
           recordLen == -1 → 16-byte sync marker follows
  Text payloads start with a Hadoop VInt length.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample

_VERSION = 6
TEXT = "org.apache.hadoop.io.Text"
BYTES_WRITABLE = "org.apache.hadoop.io.BytesWritable"
DEFAULT_CODEC = "org.apache.hadoop.io.compress.DefaultCodec"


# ----------------------------------------------------------- hadoop VInt
def read_vint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Hadoop WritableUtils.readVInt → (value, new_pos)."""
    first = struct.unpack_from("b", buf, pos)[0]
    pos += 1
    if first >= -112:
        return first, pos
    if first >= -120:
        n = -(first + 112)
        neg = False
    else:
        n = -(first + 120)
        neg = True
    v = 0
    for _ in range(n):
        v = (v << 8) | buf[pos]
        pos += 1
    return (~v if neg else v), pos


def write_vint(v: int) -> bytes:
    if -112 <= v <= 127:
        return struct.pack("b", v)
    neg = v < 0
    if neg:
        v = ~v
    n = (v.bit_length() + 7) // 8
    first = (-112 - n) if not neg else (-120 - n)
    return struct.pack("b", first) + v.to_bytes(n, "big")


def _hadoop_string(s: str) -> bytes:
    b = s.encode()
    return write_vint(len(b)) + b


def _read_hadoop_string(f) -> str:
    # VInt length then bytes; VInt is at most 5 bytes here
    head = f.read(1)
    first = struct.unpack("b", head)[0]
    if first >= -112:
        n = first
    else:
        ln = -(first + 112) if first >= -120 else -(first + 120)
        n = int.from_bytes(f.read(ln), "big")
    return f.read(n).decode()


def _decode_text(payload: bytes) -> bytes:
    """Text serialization = VInt byte-length + utf8 bytes."""
    n, pos = read_vint(payload, 0)
    return payload[pos:pos + n]


def _decode_bytes_writable(payload: bytes) -> bytes:
    (n,) = struct.unpack_from(">i", payload, 0)
    return payload[4:4 + n]


# ------------------------------------------------------------------ reader
def read_seqfile(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key_bytes, value_bytes) decoded per the header's classes."""
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"SEQ":
            raise IOError(f"{path} is not a SequenceFile")
        version = f.read(1)[0]
        if version < 6:
            # v5 lacks the metadata section this parser expects
            raise NotImplementedError(
                f"SequenceFile version {version}; only v6 is supported")
        key_cls = _read_hadoop_string(f)
        val_cls = _read_hadoop_string(f)
        compressed = f.read(1)[0] != 0
        block = f.read(1)[0] != 0
        codec = None
        if compressed:
            codec = _read_hadoop_string(f)
            if codec != DEFAULT_CODEC:
                raise NotImplementedError(
                    f"SequenceFile codec {codec!r}: only DefaultCodec "
                    "(zlib) record compression is supported")
        (meta_count,) = struct.unpack(">i", f.read(4))
        for _ in range(meta_count):
            _read_hadoop_string(f)
            _read_hadoop_string(f)
        sync = f.read(16)

        def decode(cls, payload):
            if cls == TEXT:
                return _decode_text(payload)
            if cls == BYTES_WRITABLE:
                return _decode_bytes_writable(payload)
            return payload

        if block:
            # block compression (SequenceFile.BlockCompressWriter): each
            # block = sync escape + sync, VInt record count, then four
            # length-prefixed zlib buffers (key lengths, keys, value
            # lengths, values); the length buffers hold VInts
            yield from _read_blocks(f, sync, key_cls, val_cls, decode,
                                    path)
            return
        while True:
            head = f.read(4)
            if len(head) < 4:
                return
            (rec_len,) = struct.unpack(">i", head)
            if rec_len == -1:   # sync marker
                marker = f.read(16)
                if marker != sync:
                    raise IOError(f"corrupt sync marker in {path}")
                continue
            (key_len,) = struct.unpack(">i", f.read(4))
            key = f.read(key_len)
            value = f.read(rec_len - key_len)
            if len(key) != key_len or len(value) != rec_len - key_len:
                raise IOError(f"truncated SequenceFile record in {path}")
            if compressed:
                # record compression: the VALUE payload is deflated
                value = zlib.decompress(value)
            yield decode(key_cls, key), decode(val_cls, value)


def _read_vint_stream(f) -> int:
    """Hadoop WritableUtils.readVInt straight off a stream (shares the
    byte-level decoder with :func:`read_vint` — the first byte tells how
    many more to pull)."""
    first = f.read(1)
    if len(first) < 1:
        raise IOError("truncated SequenceFile: EOF inside a VInt")
    lead = struct.unpack("b", first)[0]
    extra = 0
    if lead < -112:
        extra = -(lead + 120) if lead < -120 else -(lead + 112)
    rest = f.read(extra)
    if len(rest) < extra:
        raise IOError("truncated SequenceFile: EOF inside a VInt")
    value, _ = read_vint(first + rest, 0)
    return value


def _vints(buf: bytes):
    pos = 0
    while pos < len(buf):
        v, pos = read_vint(buf, pos)
        yield v


def _read_blocks(f, sync, key_cls, val_cls, decode, path):
    while True:
        head = f.read(4)
        if len(head) < 4:
            return
        (esc,) = struct.unpack(">i", head)
        if esc != -1 or f.read(16) != sync:
            raise IOError(f"corrupt block sync in {path}")
        n_records = _read_vint_stream(f)

        def buf():
            ln = _read_vint_stream(f)
            return zlib.decompress(f.read(ln))

        key_lens = list(_vints(buf()))
        keys = buf()
        val_lens = list(_vints(buf()))
        vals = buf()
        if len(key_lens) != n_records or len(val_lens) != n_records:
            raise IOError(f"block record-count mismatch in {path}")
        kp = vp = 0
        for kl, vl in zip(key_lens, val_lens):
            yield (decode(key_cls, keys[kp:kp + kl]),
                   decode(val_cls, vals[vp:vp + vl]))
            kp += kl
            vp += vl


def write_seqfile(path: str, records: Sequence[Tuple[bytes, bytes]],
                  key_cls: str = TEXT, val_cls: str = TEXT,
                  sync_interval: int = 100,
                  compressed: bool = False,
                  block_compressed: bool = False) -> None:
    """Write (key, value) byte pairs as a SequenceFile
    (``BGRImgToLocalSeqFile`` analog); ``compressed=True`` uses Hadoop
    record compression with DefaultCodec (zlib) on the values;
    ``block_compressed=True`` writes the block format (one zlib buffer
    per ``sync_interval`` records — what MapReduce jobs emit by
    default)."""
    sync = np.random.default_rng(12345).bytes(16)

    def encode(cls, payload: bytes) -> bytes:
        if cls == TEXT:
            return write_vint(len(payload)) + payload
        if cls == BYTES_WRITABLE:
            return struct.pack(">i", len(payload)) + payload
        return payload

    with open(path, "wb") as f:
        f.write(b"SEQ" + bytes([_VERSION]))
        f.write(_hadoop_string(key_cls))
        f.write(_hadoop_string(val_cls))
        on = compressed or block_compressed
        f.write(bytes([1 if on else 0, 1 if block_compressed else 0]))
        if on:
            f.write(_hadoop_string(DEFAULT_CODEC))
        f.write(struct.pack(">i", 0))   # no metadata
        f.write(sync)
        if block_compressed:
            recs = list(records)
            for start in range(0, len(recs), sync_interval):
                chunk = recs[start:start + sync_interval]
                kl = b"".join(write_vint(len(encode(key_cls, k)))
                              for k, _ in chunk)
                kb = b"".join(encode(key_cls, k) for k, _ in chunk)
                vl = b"".join(write_vint(len(encode(val_cls, v)))
                              for _, v in chunk)
                vb = b"".join(encode(val_cls, v) for _, v in chunk)
                f.write(struct.pack(">i", -1))
                f.write(sync)
                f.write(write_vint(len(chunk)))
                for payload in (kl, kb, vl, vb):
                    z = zlib.compress(payload)
                    f.write(write_vint(len(z)))
                    f.write(z)
            return
        for i, (k, v) in enumerate(records):
            if i and i % sync_interval == 0:
                f.write(struct.pack(">i", -1))
                f.write(sync)
            ke = encode(key_cls, k)
            ve = encode(val_cls, v)
            if compressed:
                ve = zlib.compress(ve)
            f.write(struct.pack(">i", len(ke) + len(ve)))
            f.write(struct.pack(">i", len(ke)))
            f.write(ke)
            f.write(ve)


# ------------------------------------------------- reference key convention
def parse_imagenet_key(key: bytes) -> Tuple[Optional[str], int]:
    """``"<name>\\n<label>"`` or ``"<label>"`` → (name, label)
    (``BGRImgToLocalSeqFile.scala:67-69``)."""
    s = key.decode()
    if "\n" in s:
        name, label = s.rsplit("\n", 1)
        return name, int(label)
    return None, int(s)


def seqfiles_to_byte_records(paths: Sequence[str]
                             ) -> Iterator[Tuple[int, bytes]]:
    """Stream (label, image_bytes) from sequence files
    (``LocalSeqFileToBytes`` analog)."""
    for p in paths:
        for key, value in read_seqfile(p):
            _, label = parse_imagenet_key(key)
            yield label, value


def image_samples(paths: Sequence[str]) -> List[Sample]:
    """The recipe's samples from sequence files of raw square HWC uint8
    images (``examples/resnet/train_imagenet.py:66-79``): each record's
    bytes reshaped to (side, side, 3), its 1-based label made 0-based.
    Raises ``ValueError`` for a record that is not a square image (the
    raw format carries no dimension header)."""
    samples = []
    for label, blob in seqfiles_to_byte_records(paths):
        img = np.frombuffer(blob, np.uint8)
        side = int(round((img.size / 3) ** 0.5))
        if side * side * 3 != img.size:
            raise ValueError(
                f"seqfile record of {img.size} bytes is not a square "
                "raw-HWC image; pre-resize to a fixed square (the raw "
                "format carries no dimension header)")
        samples.append(Sample(img.reshape(side, side, 3),
                              np.int32(label - 1)))
    return samples

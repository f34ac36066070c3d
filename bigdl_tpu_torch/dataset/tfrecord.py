"""TFRecord files and ``tf.train.Example`` (de)serialization (port of
``bigdl_tpu/dataset/tfrecord.py``).

Record framing: u64-le length, u32 masked CRC32-C of the length, the
payload, u32 masked CRC32-C of the payload (``utils/summary.py``'s
writer frames TensorBoard events the same way).  The Example codec is
schema-light, over ``utils/protowire``: Example{1: Features};
Features{1: map<string, Feature>}, a map entry {1: key, 2: Feature};
Feature{1: BytesList, 2: FloatList, 3: Int64List}; each list {1:
repeated value}.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Union

import numpy as np

from bigdl_tpu_torch.utils import protowire as pw
from bigdl_tpu_torch.utils.summary import _masked_crc


# ------------------------------------------------------------ record frame
def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Iterate raw record payloads of a TFRecord file (reference
    ``TFRecordIterator``).  Framing: u64-le length, u32 masked-crc(length),
    payload, u32 masked-crc(payload)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and _masked_crc(header) != len_crc:
                raise IOError(f"corrupt TFRecord length crc in {path}")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError(f"truncated TFRecord in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and _masked_crc(payload) != data_crc:
                raise IOError(f"corrupt TFRecord data crc in {path}")
            yield payload


def write_records(path: str, payloads) -> None:
    """Write raw payloads in TFRecord framing (mirror of
    ``summary.FileWriter._write_record``)."""
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------------- tf.Example
FeatureValue = Union[bytes, str, float, int, List, np.ndarray]


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Build a serialized tf.train.Example from a {name: value} dict.
    bytes/str → BytesList, float(array) → FloatList, int(array) → Int64List."""
    entries = b""
    for key, value in features.items():
        if isinstance(value, (bytes, str)):
            vals = [value.encode() if isinstance(value, str) else value]
            inner = b"".join(pw.enc_bytes(1, v) for v in vals)
            feat = pw.enc_bytes(1, inner)                    # BytesList
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.floating):
                inner = pw.enc_bytes(
                    1, struct.pack(f"<{arr.size}f",
                                   *arr.reshape(-1).astype(np.float32)))
                feat = pw.enc_bytes(2, inner)                # FloatList
            else:
                inner = b"".join(pw.varint(int(v))
                                 for v in arr.reshape(-1))
                feat = pw.enc_bytes(3, pw.enc_bytes(1, inner))  # Int64List
        entry = pw.enc_str(1, key) + pw.enc_bytes(2, feat)
        entries += pw.enc_bytes(1, entry)
    return pw.enc_bytes(1, entries)  # Example{1: Features}


def decode_example(data: bytes) -> Dict[str, Union[List[bytes], np.ndarray]]:
    """Parse a serialized tf.train.Example into {name: values}.
    BytesList → list[bytes]; FloatList → float32 ndarray;
    Int64List → int64 ndarray."""
    example = pw.decode_message(data)
    out: Dict[str, Union[List[bytes], np.ndarray]] = {}
    for features_bytes in example.get(1, []):
        features = pw.decode_message(features_bytes)
        for entry_bytes in features.get(1, []):
            entry = pw.decode_message(entry_bytes)
            key = pw.as_str(entry[1][0])
            feature = pw.decode_message(entry[2][0])
            if 1 in feature:     # BytesList
                bl = pw.decode_message(feature[1][0])
                out[key] = list(bl.get(1, []))
            elif 2 in feature:   # FloatList (packed or not)
                fl = pw.decode_message(feature[2][0])
                vals: List[float] = []
                for v in fl.get(1, []):
                    if isinstance(v, bytes):
                        vals.extend(pw.unpack_packed(v, "float"))
                    else:
                        vals.append(pw.as_float(v))
                out[key] = np.asarray(vals, np.float32)
            elif 3 in feature:   # Int64List
                il = pw.decode_message(feature[3][0])
                vals = []
                for v in il.get(1, []):
                    if isinstance(v, bytes):
                        vals.extend(pw.as_sint(x) for x in
                                    pw.unpack_packed(v, "varint"))
                    else:
                        vals.append(pw.as_sint(v))
                out[key] = np.asarray(vals, np.int64)
            else:
                out[key] = []
    return out


def read_examples(path: str) -> Iterator[Dict]:
    """Iterate decoded tf.Examples from a TFRecord file."""
    for payload in read_records(path):
        yield decode_example(payload)


def write_examples(path: str, feature_dicts) -> None:
    write_records(path, (encode_example(d) for d in feature_dicts))

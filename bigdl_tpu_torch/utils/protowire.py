"""Minimal protobuf wire-format codec (port of
``bigdl_tpu/utils/protowire.py``; stdlib only).

The interop formats (BigDL's ``bigdl.proto`` model files, Caffe's
caffemodel, TensorFlow's GraphDef) are protobuf messages; this module
decodes them generically and encodes them field by field, with no
generated code:

- :func:`decode_message` — bytes → ``{field_number: [raw values]}``
  (varints as int, fixed32/64 as int, length-delimited as bytes).
  Callers interpret fields against the schema's field numbers.
- small typed encode helpers for building messages on export.

Wire types: 0=varint, 1=64-bit, 2=length-delimited, 5=32-bit
(groups 3/4 are legacy and unsupported — none of the target schemas
use them).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple


# ------------------------------------------------------------------ decode
def read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """Return (value, new_pos)."""
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def iter_fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, raw_value) for each field."""
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = read_varint(data, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", data, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} at {pos}")
        yield field, wire, val


def decode_message(data: bytes) -> Dict[int, List]:
    """Decode one message level into {field_number: [values]}."""
    out: Dict[int, List] = {}
    for field, _, val in iter_fields(data):
        out.setdefault(field, []).append(val)
    return out


# --------------------------------------------------- typed value accessors
def as_int(v) -> int:
    return int(v)


def as_sint(v: int) -> int:
    """Two's-complement reinterpretation of a varint as a signed int64
    (proto int32/int64 negative values are encoded as 10-byte varints)."""
    v = int(v)
    return v - (1 << 64) if v >= (1 << 63) else v


def as_zigzag(v: int) -> int:
    """sint32/sint64 zigzag decode."""
    v = int(v)
    return (v >> 1) ^ -(v & 1)


def as_float(v: int) -> float:
    """fixed32 bits -> float."""
    return struct.unpack("<f", struct.pack("<I", v))[0]


def as_double(v: int) -> float:
    """fixed64 bits -> double."""
    return struct.unpack("<d", struct.pack("<Q", v))[0]


def as_str(v: bytes) -> str:
    return v.decode("utf-8")


def unpack_packed(v: bytes, kind: str) -> List:
    """Decode a packed repeated scalar field (wire type 2 payload)."""
    out: List = []
    pos = 0
    if kind in ("varint", "int"):
        while pos < len(v):
            x, pos = read_varint(v, pos)
            out.append(x)
    elif kind == "float":
        out = list(struct.unpack(f"<{len(v) // 4}f", v))
    elif kind == "double":
        out = list(struct.unpack(f"<{len(v) // 8}d", v))
    elif kind == "fixed64":
        out = list(struct.unpack(f"<{len(v) // 8}Q", v))
    elif kind == "fixed32":
        out = list(struct.unpack(f"<{len(v) // 4}I", v))
    else:
        raise ValueError(kind)
    return out


def ints(msg: Dict[int, List], field: int, kind: str = "varint") -> List[int]:
    """Repeated int field that may be packed or unpacked."""
    out: List[int] = []
    for v in msg.get(field, []):
        if isinstance(v, bytes):
            out.extend(unpack_packed(v, kind))
        else:
            out.append(v)
    return out


# ------------------------------------------------------------------ encode
def varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wire: int) -> bytes:
    return varint((field << 3) | wire)


def enc_varint(field: int, v: int) -> bytes:
    return tag(field, 0) + varint(v)


def enc_bytes(field: int, v: bytes) -> bytes:
    return tag(field, 2) + varint(len(v)) + v


def enc_str(field: int, v: str) -> bytes:
    return enc_bytes(field, v.encode("utf-8"))


def enc_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", v)


def enc_double(field: int, v: float) -> bytes:
    return tag(field, 1) + struct.pack("<d", v)


def enc_packed_floats(field: int, vs) -> bytes:
    payload = struct.pack(f"<{len(vs)}f", *vs)
    return enc_bytes(field, payload)


def enc_packed_ints(field: int, vs) -> bytes:
    payload = b"".join(varint(int(v)) for v in vs)
    return enc_bytes(field, payload)

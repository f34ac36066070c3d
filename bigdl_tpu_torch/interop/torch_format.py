"""Torch7 ``.t7`` binary reader and writer (port of
``bigdl_tpu/interop/torch_format.py``; numpy only).

The Lua Torch serialization format, which BigDL reads and writes for
model exchange (``TorchFile``).  Its writer is deterministic and gives
the same bytes as the reference package's for the same value.

Format (little-endian):
  value   := int32 type, payload
  type    := 0 nil | 1 number (f64) | 2 string (int32 len + bytes)
           | 3 table | 4 torch object | 5 boolean (int32)
           | 6/7/8 function (unsupported)
  table   := int32 ref-index; if new: int32 count, then count key/value
             pairs
  object  := int32 ref-index; if new: string version ("V <n>" or legacy
             class name), string class name, class payload
  Tensor  := int32 ndim, int64 sizes[ndim], int64 strides[ndim],
             int64 storageOffset (1-based), storage object
  Storage := int64 size, raw elements (f32/f64/i32/i64/u8 by class)
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np

TYPE_NIL, TYPE_NUMBER, TYPE_STRING, TYPE_TABLE = 0, 1, 2, 3
TYPE_TORCH, TYPE_BOOLEAN = 4, 5

_STORAGE_DTYPES = {
    "torch.FloatStorage": (np.float32, 4),
    "torch.DoubleStorage": (np.float64, 8),
    "torch.IntStorage": (np.int32, 4),
    "torch.LongStorage": (np.int64, 8),
    "torch.ByteStorage": (np.uint8, 1),
    "torch.CharStorage": (np.int8, 1),
    "torch.ShortStorage": (np.int16, 2),
}
_TENSOR_TO_STORAGE = {
    "torch.FloatTensor": "torch.FloatStorage",
    "torch.DoubleTensor": "torch.DoubleStorage",
    "torch.IntTensor": "torch.IntStorage",
    "torch.LongTensor": "torch.LongStorage",
    "torch.ByteTensor": "torch.ByteStorage",
    "torch.CharTensor": "torch.CharStorage",
    "torch.ShortTensor": "torch.ShortStorage",
}


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.refs: Dict[int, Any] = {}

    def i32(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.f.read(8))[0]

    def string(self) -> str:
        n = self.i32()
        return self.f.read(n).decode("utf-8", "replace")

    def read(self):
        t = self.i32()
        if t == TYPE_NIL:
            return None
        if t == TYPE_NUMBER:
            v = self.f64()
            return int(v) if v.is_integer() else v
        if t == TYPE_STRING:
            return self.string()
        if t == TYPE_BOOLEAN:
            return bool(self.i32())
        if t == TYPE_TABLE:
            return self._table()
        if t == TYPE_TORCH:
            return self._object()
        raise NotImplementedError(f".t7 value type {t} (functions are not "
                                  "supported)")

    def _table(self):
        ix = self.i32()
        if ix in self.refs:
            return self.refs[ix]
        out: Dict[Any, Any] = {}
        self.refs[ix] = out
        count = self.i32()
        for _ in range(count):
            k = self.read()
            v = self.read()
            out[k] = v
        # lua array table → list
        if out and all(isinstance(k, int) for k in out) \
                and sorted(out) == list(range(1, len(out) + 1)):
            lst = [out[i] for i in range(1, len(out) + 1)]
            self.refs[ix] = lst
            return lst
        return out

    def _object(self):
        ix = self.i32()
        if ix in self.refs:
            return self.refs[ix]
        version = self.string()
        if version.startswith("V "):
            cls = self.string()
        else:
            cls = version  # legacy layout: the string was the class name
        if cls in _TENSOR_TO_STORAGE:
            out = self._tensor(cls)
        elif cls in _STORAGE_DTYPES:
            out = self._storage(cls)
        else:
            # generic torch class (e.g. an nn module): its payload is a
            # table of fields
            out = {"_torch_class": cls, "fields": self.read()}
        self.refs[ix] = out
        return out

    def _tensor(self, cls: str) -> np.ndarray:
        nd = self.i32()
        sizes = [self.i64() for _ in range(nd)]
        strides = [self.i64() for _ in range(nd)]
        offset = self.i64()  # 1-based
        storage = self.read()
        if storage is None:
            return np.zeros(sizes, _STORAGE_DTYPES[
                _TENSOR_TO_STORAGE[cls]][0])
        flat = np.asarray(storage)
        if nd == 0:
            return flat[:0]
        # materialize via strides (t7 tensors can be non-contiguous views)
        out = np.lib.stride_tricks.as_strided(
            flat[offset - 1:],
            shape=sizes,
            strides=[s * flat.itemsize for s in strides]).copy()
        return out

    def _storage(self, cls: str) -> np.ndarray:
        dtype, width = _STORAGE_DTYPES[cls]
        n = self.i64()
        return np.frombuffer(self.f.read(n * width), dtype=dtype).copy()


def load_t7(path: str):
    """Read one serialized value from a .t7 file (reference
    ``TorchFile.load``).  Tensors → numpy arrays; tables → dict/list;
    nn modules → {"_torch_class": ..., "fields": {...}} trees."""
    with open(path, "rb") as f:
        return _Reader(f).read()


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_ref = 1

    def i32(self, v: int):
        self.f.write(struct.pack("<i", v))

    def i64(self, v: int):
        self.f.write(struct.pack("<q", v))

    def write(self, v):
        import numbers
        if v is None:
            self.i32(TYPE_NIL)
        elif isinstance(v, bool):
            self.i32(TYPE_BOOLEAN)
            self.i32(int(v))
        elif isinstance(v, numbers.Number):
            self.i32(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(v)))
        elif isinstance(v, str):
            self.i32(TYPE_STRING)
            b = v.encode()
            self.i32(len(b))
            self.f.write(b)
        elif isinstance(v, np.ndarray):
            self._tensor(v)
        elif isinstance(v, dict) and "_torch_class" in v:
            # generic torch object (e.g. an nn module): class name +
            # field table — the mirror of _Reader._object
            self.i32(TYPE_TORCH)
            self.i32(self.next_ref)
            self.next_ref += 1
            self._string("V 1")
            self._string(v["_torch_class"])
            self.write(v.get("fields", {}))
        elif isinstance(v, (dict, list, tuple)):
            self._table(v)
        else:
            raise TypeError(f"cannot write {type(v)} to .t7")

    def _table(self, v):
        self.i32(TYPE_TABLE)
        self.i32(self.next_ref)
        self.next_ref += 1
        items = (list(enumerate(v, 1)) if isinstance(v, (list, tuple))
                 else list(v.items()))
        self.i32(len(items))
        for k, val in items:
            self.write(k)
            self.write(val)

    def _tensor(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float64:
            cls, scls = "torch.DoubleTensor", "torch.DoubleStorage"
        elif arr.dtype == np.int64:
            cls, scls = "torch.LongTensor", "torch.LongStorage"
        elif arr.dtype == np.int32:
            cls, scls = "torch.IntTensor", "torch.IntStorage"
        elif arr.dtype == np.int16:
            cls, scls = "torch.ShortTensor", "torch.ShortStorage"
        elif arr.dtype == np.int8:
            cls, scls = "torch.CharTensor", "torch.CharStorage"
        elif arr.dtype == np.uint8:
            cls, scls = "torch.ByteTensor", "torch.ByteStorage"
        else:
            arr = arr.astype(np.float32)
            cls, scls = "torch.FloatTensor", "torch.FloatStorage"
        self.i32(TYPE_TORCH)
        self.i32(self.next_ref)
        self.next_ref += 1
        self._string("V 1")
        self._string(cls)
        self.i32(arr.ndim)
        for s in arr.shape:
            self.i64(s)
        stride = [int(np.prod(arr.shape[i + 1:]))
                  for i in range(arr.ndim)]
        for s in stride:
            self.i64(s)
        self.i64(1)  # storage offset
        # storage object
        self.i32(TYPE_TORCH)
        self.i32(self.next_ref)
        self.next_ref += 1
        self._string("V 1")
        self._string(scls)
        self.i64(arr.size)
        self.f.write(arr.tobytes())

    def _string(self, s: str):
        b = s.encode()
        self.i32(len(b))
        self.f.write(b)


def save_t7(path: str, value) -> None:
    """Write a value (tensor / table of tensors / scalars) as .t7
    (reference ``TorchFile.save``) — enough for the golden-oracle
    transport and simple tensor exchange."""
    with open(path, "wb") as f:
        _Writer(f).write(value)

"""TensorBoard-compatible training summaries (port of
``bigdl_tpu/utils/summary.py``).

The Event protobuf is hand-encoded (only the fields TensorBoard needs) and
framed as TFRecord with a masked CRC32-C, byte for byte as the reference
writes it: the same scalars (Loss, LearningRate, Throughput a training
iteration; one per validation method) and histograms, the same record
layout and file name.  :func:`crc32c` is the table CRC that snapshots use
too (``checkpoint/snapshot.py``).  A histogram of a tensor reads it back
to the host.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32-C (Castagnoli), continuing from ``crc``."""
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def _histogram_proto(values) -> bytes:
    """HistogramProto: min=1,max=2,num=3,sum=4,sum_squares=5,
    bucket_limit=6 (repeated double), bucket=7 (repeated double)."""
    if hasattr(values, "detach"):  # a tensor, on any device
        values = values.detach().float().cpu().numpy()
    # tensorboard HistogramProto fields are doubles on the wire
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        v = np.zeros(1)
    # tensorboard-style exponential buckets
    limits = [-1e308]
    x = 1e-12
    neg = []
    while x < 1e20:
        neg.append(-x)
        x *= 1.1
    limits = sorted(neg) + [0.0]
    x = 1e-12
    while x < 1e20:
        limits.append(x)
        x *= 1.1
    limits.append(1e308)
    counts, _ = np.histogram(v, bins=[-np.inf] + limits[1:] + [np.inf])
    # keep only non-empty buckets (tensorboard convention allows all)
    msg = (_pb_double(1, float(v.min())) + _pb_double(2, float(v.max()))
           + _pb_double(3, float(v.size)) + _pb_double(4, float(v.sum()))
           + _pb_double(5, float((v * v).sum())))
    for lim, c in zip(limits, counts):
        if c > 0:
            msg += _pb_double(6, lim) + _pb_double(7, float(c))
    return msg


def _scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    value_msg = _pb_str(1, tag) + _pb_float(2, float(value))
    summary = _pb_bytes(1, value_msg)
    return (_pb_double(1, wall) + _pb_int64(2, step) + _pb_bytes(5, summary))


def _histo_event(tag: str, values, step: int, wall: float) -> bytes:
    value_msg = _pb_str(1, tag) + _pb_bytes(4, _histogram_proto(values))
    summary = _pb_bytes(1, value_msg)
    return (_pb_double(1, wall) + _pb_int64(2, step) + _pb_bytes(5, summary))


# ------------------------------------------------------------ file writer
class FileWriter:
    """TFRecord event-file writer.  The file is opened, and its version
    record written, at the first record: a process that records nothing
    (every process of a data-parallel job but process 0) leaves no file
    and no second header behind."""

    def __init__(self, log_dir: str):
        self._dir = log_dir
        self._path = None
        self._f = None

    def _write_record(self, payload: bytes):
        if self._f is None:
            os.makedirs(self._dir, exist_ok=True)
            fname = f"events.out.tfevents.{int(time.time())}.bigdl_tpu"
            self._path = os.path.join(self._dir, fname)
            self._f = open(self._path, "ab")
            # first record: file version event
            self._frame(_pb_double(1, time.time())
                        + _pb_str(3, "brain.Event:2"))
        self._frame(payload)

    def _frame(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def add_histogram(self, tag: str, values, step: int):
        self._write_record(_histo_event(tag, values, step, time.time()))

    def flush(self):
        if self._f is not None:
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


class Summary:
    """Base of Train/Validation summaries."""

    def __init__(self, log_dir: str, app_name: str, phase: str):
        self.writer = FileWriter(os.path.join(log_dir, app_name, phase))

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, value, step)
        self.writer.flush()
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        self.writer.add_histogram(tag, values, step)
        self.writer.flush()
        return self

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    """Per-iteration Loss/LearningRate/Throughput scalars, written by the
    optimizer's replay."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        self._triggers = {}

    def add_train_step(self, step: int, loss: float, lr: float,
                       throughput: float) -> "TrainSummary":
        """One training iteration's three scalars.  The K-step driver
        replays a block through here one iteration at a time, each with
        its own loss, so the file is the same at any K; one flush covers
        the three records."""
        self.writer.add_scalar("Loss", loss, step)
        self.writer.add_scalar("LearningRate", lr, step)
        self.writer.add_scalar("Throughput", throughput, step)
        self.writer.flush()
        return self

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        """Gate optional summaries (e.g. Parameters histograms) by
        trigger."""
        self._triggers[name] = trigger
        return self

    def trigger_for(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """Per-validation metric scalars."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")

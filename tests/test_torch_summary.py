"""Training summaries of the port on the CPU against the reference's
``utils/summary.py``: with the wall clock pinned, the same calls write the
same event files byte for byte (file name, version record, scalars,
histograms, TFRecord framing with masked CRC32-C).  Through
``LocalOptimizer``, the recipe's train and validation summaries hold the
reference's records (tags and steps in the same order, each step's Loss
within ``rtol=1e-5`` from the same weights and data)."""

import os
import struct

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset import image as jimage  # noqa: E402
from bigdl_tpu.dataset import mnist as jmnist  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu.optim import validation as jval  # noqa: E402
from bigdl_tpu.utils import summary as jsummary  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import image, mnist  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.optim import validation as tval  # noqa: E402
from bigdl_tpu_torch.utils import summary as tsummary  # noqa: E402


def _event_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = \
                open(os.path.join(d, f), "rb").read()
    return out


def _records(blob):
    """Payloads of a TFRecord file, each frame's masked CRCs checked."""
    out, pos = [], 0
    while pos < len(blob):
        header = blob[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", blob[pos + 8:pos + 12])
        assert hcrc == tsummary._masked_crc(header)
        payload = blob[pos + 12:pos + 12 + n]
        (pcrc,) = struct.unpack("<I", blob[pos + 12 + n:pos + 16 + n])
        assert pcrc == tsummary._masked_crc(payload)
        out.append(payload)
        pos += 16 + n
    return out


def _scalar(payload):
    """(tag, step, value) of a scalar event as FileWriter writes it:
    wall (field 1, double), step (2, varint), summary (5) > value (1) >
    tag (1, string) and simple_value (2, float)."""
    assert payload[0] == 0x09 and payload[9] == 0x10
    step, shift, i = 0, 0, 10
    while True:
        b = payload[i]
        step |= (b & 0x7F) << shift
        shift += 7
        i += 1
        if not b & 0x80:
            break
    assert payload[i] == 0x2A and payload[i + 2] == 0x0A \
        and payload[i + 4] == 0x0A
    n = payload[i + 5]
    tag = payload[i + 6:i + 6 + n].decode()
    assert payload[i + 6 + n] == 0x15
    (value,) = struct.unpack("<f", payload[i + 7 + n:i + 11 + n])
    return tag, step, value


def test_event_files_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr("time.time", lambda: 1700000000.25)
    hist = np.random.default_rng(0).normal(size=300).astype(np.float32)
    for name, mod in (("port", tsummary), ("ref", jsummary)):
        ts = mod.TrainSummary(str(tmp_path / name), "lenet")
        ts.add_train_step(1, 2.302585, 0.05, 1234.5)
        ts.add_train_step(300, 0.125, 0.025, 98765.0)
        ts.add_scalar("Telemetry/x", -1.5, 2 ** 40)
        ts.add_histogram("fc1.weight", hist if name == "ref"
                         else torch.from_numpy(hist), 7)
        ts.close()
        vs = mod.ValidationSummary(str(tmp_path / name), "lenet")
        vs.add_scalar("Top1Accuracy", 0.9375, 469)
        vs.add_histogram("empty", np.zeros(0), 1)
        vs.close()
    port, ref = _event_files(tmp_path / "port"), \
        _event_files(tmp_path / "ref")
    assert sorted(port) == sorted(ref) and len(port) == 2
    for f in ref:
        assert port[f] == ref[f], f
    assert tsummary.crc32c(b"123456789") == 0xE3069283  # the check value
    assert tsummary.crc32c(b"6789", tsummary.crc32c(b"12345")) == \
        0xE3069283


def _pipeline(pkg, n, seed, train):
    img, mn, D, S2B = pkg
    imgs, labels = mn.synthetic_mnist(n, seed=seed)
    return (D.array(mn.to_samples(imgs, labels))
            >> img.BytesToGreyImg()
            >> img.GreyImgNormalizer(mn.TRAIN_MEAN, mn.TRAIN_STD)
            >> S2B(16, drop_remainder=train))


def test_recipe_summaries_match_reference(tmp_path):
    model = lenet5(10).initialize(9)
    start = to_jax_params(model)
    (optim.LocalOptimizer(model, _pipeline(
        (image, mnist, DataSet, SampleToMiniBatch), 64, 0, True),
        nn.ClassNLLCriterion(), device="cpu")
     .set_optim_method(optim.SGD(0.05, momentum=0.9))
     .set_steps_per_dispatch(3).set_end_when(optim.max_epoch(2))
     .set_validation(optim.every_epoch(), _pipeline(
         (image, mnist, DataSet, SampleToMiniBatch), 21, 99, False),
         [tval.Top1Accuracy(), tval.Top5Accuracy()])
     .set_train_summary(tsummary.TrainSummary(str(tmp_path / "p"), "a"))
     .set_val_summary(tsummary.ValidationSummary(str(tmp_path / "p"), "a"))
     .optimize())
    jm = jax_lenet5(10)
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    ref = (jimage, jmnist, JDataSet, JSampleToMiniBatch)
    (joptim.LocalOptimizer(jm, _pipeline(ref, 64, 0, True),
                           jnn.ClassNLLCriterion())
     .set_optim_method(joptim.SGD(0.05, momentum=0.9))
     .set_steps_per_dispatch(3).set_end_when(joptim.max_epoch(2))
     .set_validation(joptim.every_epoch(), _pipeline(ref, 21, 99, False),
                     [jval.Top1Accuracy(), jval.Top5Accuracy()])
     .set_train_summary(jsummary.TrainSummary(str(tmp_path / "r"), "a"))
     .set_val_summary(jsummary.ValidationSummary(str(tmp_path / "r"), "a"))
     .optimize())
    for phase in ("train", "validation"):
        (p,), (r,) = (list(_event_files(tmp_path / d / "a" / phase)
                           .values()) for d in ("p", "r"))
        p, r = [_scalar(x) for x in _records(p)[1:]], \
            [_scalar(x) for x in _records(r)[1:]]
        assert [(t, s) for t, s, _ in p] == [(t, s) for t, s, _ in r]
        for (tag, step, pv), (_, _, rv) in zip(p, r):
            if tag in ("Loss", "LearningRate"):
                np.testing.assert_allclose(pv, rv, rtol=1e-5)
            elif tag != "Throughput":
                assert pv == rv, (tag, step)
    assert [(t, s) for t, s, _ in p] == [
        ("Top1Accuracy", 4), ("Top5Accuracy", 4),
        ("Top1Accuracy", 8), ("Top5Accuracy", 8)]

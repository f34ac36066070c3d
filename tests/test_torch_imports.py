"""Import hygiene of the port: ``bigdl_tpu_torch`` and ``chip_smoke.py``
load neither JAX nor the reference package and import with neither JAX nor
``triton`` installed; neither importing them nor running the plain
versions on the CPU (an int8 GEMM, an LSTM cell step and back, one
training step of a tiny PTB model, one bf16 step of a small NHWC ResNet
behind a max pool fed by the image pipeline, a K=2 block of a tiny
Wide&Deep on batch-COO crossed MovieLens features, an epoch of LeNet on
synthetic MNIST with validation, a snapshot and its resume, both
summaries, the preemption handler and the numeric guard, two steps of
LeNet through a world-1 ``DistriOptimizer`` with the bf16 wire, the
``parallel/`` modules with it, a step of VGG on synthetic CIFAR through
the colour ops, an NHWC inception module behind an LRN) builds or loads a
kernel; and a kernel build that fails raises."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import bigdl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, importlib.abc, json, pkgutil, sys


class Absent(importlib.abc.MetaPathFinder):
    # as if jax, triton and the reference package were not installed
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "bigdl_tpu"):
            raise ImportError(f"{name} is absent in this probe")
        return None


sys.meta_path.insert(0, Absent())
import torch
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from bigdl_tpu_torch.ops import _build, int8_gemm
x = torch.ones(3, 8)
int8_gemm.int8_matmul(x, torch.ones(4, 8, dtype=torch.int8), torch.ones(4),
                      mode="dynamic")
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_tpu_torch.models import ptb_model
from bigdl_tpu_torch.ops import lstm_cell
args = [torch.rand(2, 8 * k, requires_grad=True) for k in (4, 1, 1, 4)]
args[3] = torch.rand(8, 32, requires_grad=True)
h, c = lstm_cell.lstm_cell(*args)
(h.sum() + c.sum()).backward()
samples = [Sample(torch.arange(5).numpy() % 7, torch.arange(5).numpy() % 7)
           for _ in range(4)]
(optim.LocalOptimizer(ptb_model(7, 4, 8, 2).initialize(0),
                      DataSet.array(samples) >> SampleToMiniBatch(2),
                      nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                      device="cpu")
 .set_end_when(optim.max_iteration(1)).optimize())
assert lstm_cell.fwd_launches == lstm_cell.bwd_launches == 0
import numpy as np
from bigdl_tpu_torch.dataset import MTSampleToMiniBatch
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.ops import maxpool
from bigdl_tpu_torch.transform import vision as V
imgs = [Sample(np.full((70, 70, 3), i, np.uint8), np.int32(i % 10))
        for i in range(4)]
aug = V.RandomAlterAspect(target_size=64) >> V.HFlip() >> \
    V.ImageFrameToSample(to_chw=False)
pool_net = (nn.Sequential().add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1,
                                                     format="NHWC"))
            .add(resnet_cifar(8, format="NHWC")))
(optim.LocalOptimizer(pool_net.initialize(0),
                      DataSet.array(imgs) >> MTSampleToMiniBatch(
                          2, lambda s: aug(V.ImageFeature(
                              s.feature, s.label))["sample"], workers=2),
                      nn.ClassNLLCriterion(), device="cpu")
 .set_compute_dtype(torch.bfloat16)
 .set_end_when(optim.max_iteration(1)).optimize())
assert maxpool.launches == 0
from bigdl_tpu_torch.dataset import SparseSample, Transformer, \
    batch_sparse_samples
from bigdl_tpu_torch.dataset import datamining, movielens
from bigdl_tpu_torch.models import WideAndDeep
from bigdl_tpu_torch.ops import embed_bag
ratings = movielens.synthetic_ratings(6, 5, 8)
wide = datamining.CrossCol(50)([[str(r[0]) for r in ratings],
                                [str(r[1]) for r in ratings]])
sparse = [SparseSample(wide.col[wide.row == i].numpy(), [1.0], 50,
                       dense=[r[:2] - 1, np.ones(3, np.float32)],
                       label=np.float32(r[2] >= 4))
          for i, r in enumerate(ratings)]


class ToCOO(Transformer):
    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == 4:
                yield batch_sparse_samples(buf, [8])
                buf = []


class Squeezed(nn.BCECriterion):
    def apply(self, out, y):
        return super().apply(out[:, 0], y)


(optim.LocalOptimizer(WideAndDeep(50, [6, 5], 3, 4, (8,)).initialize(0),
                      DataSet.array(sparse) >> ToCOO(), Squeezed(),
                      device="cpu")
 .set_optim_method(optim.Adam(0.01)).set_steps_per_dispatch(2)
 .set_end_when(optim.max_iteration(2)).optimize())
assert embed_bag.launches == 0
import tempfile
from bigdl_tpu_torch.dataset import image, mnist
from bigdl_tpu_torch.models import lenet5
from bigdl_tpu_torch.optim.validation import Top1Accuracy, Top5Accuracy
from bigdl_tpu_torch.utils.summary import TrainSummary, ValidationSummary
imgs, lbls = mnist.synthetic_mnist(40, seed=0)
grey = lambda n: (DataSet.array(mnist.to_samples(imgs[:n], lbls[:n]))
                  >> image.BytesToGreyImg()
                  >> image.GreyImgNormalizer(mnist.TRAIN_MEAN,
                                             mnist.TRAIN_STD))
with tempfile.TemporaryDirectory() as tmp:
    lenet_opt = (optim.LocalOptimizer(lenet5(10).initialize(0),
                                      grey(40) >> SampleToMiniBatch(8),
                                      nn.ClassNLLCriterion(), device="cpu")
                 .set_optim_method(optim.SGD(0.05, momentum=0.9))
                 .set_end_when(optim.max_iteration(5))
                 .set_validation(optim.every_epoch(), grey(12),
                                 [Top1Accuracy(), Top5Accuracy()], 8)
                 .set_checkpoint(tmp, optim.every_epoch())
                 .set_train_summary(TrainSummary(tmp, "lenet"))
                 .set_val_summary(ValidationSummary(tmp, "lenet"))
                 .set_preemption_handling().set_numeric_guard("skip"))
    lenet_opt.optimize()
    assert lenet_opt.state["score"] >= 0 and lenet_opt.resume()
assert maxpool.launches == 0
from bigdl_tpu_torch.parallel import grad_sync, mesh
distri = (optim.Optimizer.create(lenet5(10).initialize(0),
                                 grey(40) >> SampleToMiniBatch(8),
                                 nn.ClassNLLCriterion(), distributed=True,
                                 device="cpu", grad_wire_dtype="bf16")
          .set_optim_method(optim.SGD(0.05, momentum=0.9))
          .set_end_when(optim.max_iteration(2)))
distri.optimize()
assert distri._use_grad_sync and mesh.create_mesh(backend="gloo").size == 1
assert maxpool.launches == 0
from bigdl_tpu_torch.dataset import cifar
from bigdl_tpu_torch.models import vgg_for_cifar10
from bigdl_tpu_torch.models.inception import inception_module
ci, cl = cifar.synthetic_cifar(8)
colour = DataSet.array(cifar.to_samples(ci, cl))
for t in (image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD),
          image.RandomCropper(32, 32, pad=4), image.HFlip(),
          image.ColorJitter(), image.Lighting(), image.ChannelOrder("CHW")):
    colour = colour >> t
(optim.LocalOptimizer(vgg_for_cifar10(10).initialize(0),
                      colour >> SampleToMiniBatch(4), nn.ClassNLLCriterion(),
                      device="cpu")
 .set_end_when(optim.max_iteration(1)).optimize())
tower = (nn.Sequential()
         .add(nn.SpatialCrossMapLRN(4, 1.0, 0.75, 1.0, format="NHWC"))
         .add(inception_module(8, 4, 4, 4, 2, 2, 2, "t", "NHWC"))
         .initialize(0))
xt = torch.rand(2, 9, 9, 8, requires_grad=True)
tower(xt).sum().backward()
assert xt.grad.shape == xt.shape and maxpool.launches == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "bigdl_tpu"
             or m.startswith("bigdl_tpu."))
print(json.dumps({"modules": len(names), "bad": bad,
                  "libs": sorted(_build._libs)}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["libs"] == []
    expected = len(list(pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                              "bigdl_tpu_torch.")))
    assert got["modules"] == expected >= 20


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that refuses the source raises KernelBuildError with its
    message, and leaves no library behind: there is no fallback."""
    from bigdl_tpu_torch.ops import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: source refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(_build.KernelBuildError, match="source refused"):
        _build.load("int8_gemm")
    assert not list((tmp_path / "kernels").iterdir())

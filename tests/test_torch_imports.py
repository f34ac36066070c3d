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
the colour ops, an NHWC inception module behind an LRN, two steps of the
autoencoder through each new optim method with a regularizer, an NHWC
``Remat`` block under two activation-memory policies, two steps of the
text CNN through the text pipeline, ragged samples batched under
``PaddingParam``s, ``TimeDistributedMaskCriterion`` over a weighted
criterion, a LeNet block under a fault plan with telemetry, the flight
recorder, the admin plane and spmdcheck on) builds or loads a kernel; and
a kernel build that fails raises.  The text slice's modules
(``dataset/text.py``, ``nn/shape_ops.py``, ``nn/criterion.py``,
``nn/layers.py``, ``nn/module.py``) and the resilience and telemetry
slice's (``resilience/faults.py``, ``resilience/membership.py``,
``telemetry/{tracer,context,watchdog,hooks,flight,admin}.py``,
``utils/{metrics,profiling,lockdep,spmdcheck}.py``) are among those
imported, and so are the interop slice's (``utils/protowire.py``,
``nn/graph.py``, ``ops/registry.py``, ``interop/*``), which also import
without ``h5py``: a quantized LeNet deployed from a ``.bigdl`` file and
LeNet through ``.t7`` and a GraphDef run on the CPU with no kernel
launched.  So are the prediction and Keras slice's (``optim/predictor.py``,
``estimator.py``, ``keras/*``, ``interop/{keras_format,session,
tf_queues}.py``, ``dataset/{news20,tfrecord}.py``, ``nn/{spatial_extras,
tensor_extras}.py``): a ``Predictor`` over a quantized LeNet, a Keras
LeNet step and a ``TFSession`` step launch no kernel.  And so are the
serving slice's (``frontend/*``, ``resilience/replica_set.py``,
``serving/decode.py``, ``nn/attention.py``, ``models/transformer.py``):
the wire front end over both connection cores answers predict on a
registry version and on a ``ReplicaSet`` through a replica death,
generate on a ``DecodeService`` and 404, and hot-cuts the decode
version over, with no kernel launched.  So are the tensor-parallel
slice's (``parallel/tensor_parallel.py``, ``serving/sharded.py``): a
sharded ``DecodeService`` and a ``ShardedReplicaSet`` on model groups of
``["cpu"] * 2``, two steps of ``DistriOptimizer(param_specs=)`` and a
quantized NHWC ResNet-8 run with no kernel launched.  So are the last
slice's (``dataset/seqfile.py``, ``nn/{control_flow,detection,tree,
volumetric}.py``): a block-compressed sequence file read back, a tree LSTM
forward, NMS, a 3-D convolution and a bounded ``While`` run with no kernel
launched.  No import statement anywhere
in the port, function bodies included, names JAX or the reference."""

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
    # as if jax, triton, h5py and the reference package were not installed
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "bigdl_tpu",
                                  "h5py"):
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
from bigdl_tpu_torch.models import autoencoder
ae_x = (imgs[:8].astype(np.float32) / 255.0)
ae_set = DataSet.array([Sample(a, a.reshape(-1)) for a in ae_x])
for method in (optim.Adagrad(0.01), optim.Adadelta(), optim.Adamax(),
               optim.RMSprop(), optim.Ftrl(), optim.ParallelAdam(),
               optim.LBFGS(history=2),
               optim.SGD(0.1, momentum=0.9, state_dtype=torch.bfloat16)):
    ae = autoencoder(4).initialize(0)
    ae[1].w_regularizer = nn.L1L2Regularizer(1e-4, 1e-4)
    (optim.LocalOptimizer(ae, ae_set >> SampleToMiniBatch(4),
                          nn.MSECriterion(), device="cpu")
     .set_optim_method(method).set_steps_per_dispatch(2)
     .set_end_when(optim.max_iteration(2)).optimize())
remat_net = (nn.Sequential()
             .add(nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1,
                                        format="NHWC"))
             .add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format="NHWC"))
             .add(nn.Remat(resnet_cifar(8, format="NHWC")[2], "tails"))
             .add(nn.SpatialAveragePooling(4, 4, 4, 4, format="NHWC"))
             .add(nn.Reshape((16,))).add(nn.LogSoftMax()).initialize(0))
for policy in ("dots", "bf16+full"):
    (optim.LocalOptimizer(remat_net, DataSet.array(
        [Sample(np.ones((8, 8, 3), np.float32), np.int64(1))] * 4)
        >> SampleToMiniBatch(2), nn.ClassNLLCriterion(), device="cpu")
     .set_activation_memory(policy)
     .set_end_when(optim.max_iteration(1)).optimize())
assert maxpool.launches == 0
from bigdl_tpu_torch.dataset import PaddingParam, batch_samples, text
docs = list(text.SentenceTokenizer()(iter(text.synthetic_corpus(8))))
assert text.Dictionary(docs).vocab_size() > 10
cnn_samples, cnn_vocab = chip_smoke.text_cnn_samples(
    *chip_smoke.text_cnn_corpus(64), seq_len=12)
(optim.LocalOptimizer(chip_smoke.text_cnn(cnn_vocab, 8).initialize(0),
                      DataSet.array(cnn_samples) >> SampleToMiniBatch(16),
                      nn.ClassNLLCriterion(), device="cpu")
 .set_optim_method(optim.Adam(0.01))
 .set_end_when(optim.max_iteration(2)).optimize())
ragged = batch_samples([Sample(np.ones(n, np.float32), np.arange(n) % 3)
                        for n in (2, 5, 3)], PaddingParam(buckets=(4, 8)),
                       PaddingParam(padding_value=-1))
assert ragged.input.shape == (3, 8) and ragged.target.shape == (3, 5)
masked = nn.TimeDistributedMaskCriterion(nn.ClassNLLCriterion(
    weights=[1.0, 2.0, 3.0])).apply(torch.log_softmax(torch.rand(2, 4, 3), -1),
                                    torch.tensor([[1, 2, 0, 0], [2, 1, 1, 0]]))
assert torch.isfinite(masked)
assert {"bigdl_tpu_torch.dataset.text", "bigdl_tpu_torch.nn.shape_ops",
        "bigdl_tpu_torch.nn.criterion"} <= set(names)
import os
from bigdl_tpu_torch.telemetry import flight
from bigdl_tpu_torch.utils import config, spmdcheck
with tempfile.TemporaryDirectory() as d:
    config.configure(fault_plan="corrupt_batch@at=1", telemetry_enabled=True,
                     flight_recorder_path=os.path.join(d, "f.jsonl"),
                     spmdcheck=True)
    spmdcheck.maybe_install()
    fault_opt = (optim.LocalOptimizer(lenet5(10).initialize(0),
                                      grey(40) >> SampleToMiniBatch(8),
                                      nn.ClassNLLCriterion(),
                                      device="cpu")
                 .set_numeric_guard("skip").set_steps_per_dispatch(2)
                 .set_end_when(optim.max_iteration(2)))
    fault_opt.optimize()
    assert fault_opt.registry.counter("resilience/steps_skipped").value == 1
    assert spmdcheck.notes_recorded() > 0
    spmdcheck.uninstall()
    flight.reset()
    config.reset_config()
assert maxpool.launches == 0
assert {"bigdl_tpu_torch." + m for m in (
    "resilience.faults", "resilience.membership", "telemetry.tracer",
    "telemetry.context", "telemetry.watchdog", "telemetry.hooks",
    "telemetry.flight", "telemetry.admin", "utils.metrics",
    "utils.profiling", "utils.lockdep", "utils.spmdcheck")} <= set(names)
from bigdl_tpu_torch import interop
from bigdl_tpu_torch.serving import ModelRegistry
with tempfile.TemporaryDirectory() as d:
    net = lenet5(10).initialize(0).eval()
    xin = torch.rand(2, 784)
    with torch.no_grad():
        want = net(xin)
    interop.save_bigdl_module(nn.quantize(net, mode="dynamic"),
                              os.path.join(d, "q.bigdl"))
    interop.save_torch_module(net, os.path.join(d, "m.t7"))
    interop.save_tf_graph(net, os.path.join(d, "m.pb"), (2, 784))
    with torch.no_grad():
        assert torch.equal(interop.load_torch_module(
            os.path.join(d, "m.t7")).eval()(xin), want)
        assert torch.allclose(interop.load_tf_graph(
            os.path.join(d, "m.pb"), ["input"], ["output"])(xin), want,
            atol=1e-5)
    with ModelRegistry(device="cpu") as reg:
        reg.deploy("q", path=os.path.join(d, "q.bigdl"), format="bigdl")
        assert reg.predict("q", xin.numpy(), timeout=60).shape == (2, 10)
assert int8_gemm.launches == 0
assert {"bigdl_tpu_torch." + m for m in (
    "utils.protowire", "nn.graph", "interop.bigdl_format",
    "interop.torch_format", "interop.torch_export", "interop.caffe_format",
    "interop.caffe_export", "ops.registry", "interop.tf_loops",
    "interop.tf_format", "interop.tf_export", "interop.convert_model")
} <= set(names)
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch.interop.session import TFSession
from bigdl_tpu_torch.optim import Predictor
qnet = nn.quantize(lenet5(10).initialize(0), mode="weight_only")
assert Predictor(qnet, batch_size=4, device="cpu").predict(
    np.zeros((6, 1, 28, 28), np.float32)).shape == (6, 10)
klenet = K.Sequential([K.Convolution2D(6, 5, 5, activation="tanh",
                                       input_shape=(1, 28, 28)),
                       K.MaxPooling2D(), K.Flatten(),
                       K.Dense(10, activation="softmax")])
klenet.compile("sgd", "categorical_crossentropy", device="cpu")
klenet.fit(np.zeros((8, 1, 28, 28), np.float32), np.zeros(8, np.int32),
           batch_size=8, nb_epoch=1)
with tempfile.TemporaryDirectory() as d:
    interop.save_tf_graph(nn.Sequential(nn.Linear(4, 3), nn.LogSoftMax())
                          .initialize(0), os.path.join(d, "t.pb"), (1, 4),
                          trainable=True)
    sess = TFSession(os.path.join(d, "t.pb"), ["input"], ["output"],
                     device="cpu")
    sess.train(DataSet.array([Sample(np.ones(4, np.float32), np.int32(1))]
                             * 4) >> SampleToMiniBatch(4),
               nn.ClassNLLCriterion(), end_when=optim.max_iteration(1))
assert int8_gemm.launches == maxpool.launches == 0
import http.client, threading
from bigdl_tpu_torch.frontend import FrontendServer, HotCutover
from bigdl_tpu_torch.models import transformer_lm
from bigdl_tpu_torch.resilience import FaultInjector, ReplicaSet
from bigdl_tpu_torch.serving import DecodeService, ModelRegistry
reg = ModelRegistry(device="cpu")
reg.deploy("q", qnet, input_spec=((1, 28, 28), np.float32), max_batch_size=4)
rset = ReplicaSet(qnet, n_replicas=2, devices=[torch.device("cpu")],
                  input_spec=((1, 28, 28), np.float32), max_batch_size=4,
                  fault_injector=FaultInjector(
                      "replica_death@target=0,after=1,count=1"))
lm = transformer_lm(32, 16, 2, 1, max_len=32).initialize(0)
reg.deploy("lm", service=DecodeService(lm, slots=2, max_seq_len=16,
                                       prefill_buckets="top", device="cpu"))
for core in ("eventloop", "threaded"):
    fe = FrontendServer(reg, backends={"rs": rset}, port=0, core=core)
    port = fe.start()
    for path, body in [("/v1/models/q/predict", {"inputs": np.zeros(
            (2, 1, 28, 28)).tolist()}), ("/v1/models/rs/predict", {
            "inputs": np.zeros((1, 1, 28, 28)).tolist()}),
            ("/v1/models/rs/predict", {"inputs": np.zeros(
                (1, 1, 28, 28)).tolist()}),
            ("/v1/models/lm/generate", {"prompt": [1, 2],
                                        "max_new_tokens": 3}),
            ("/v1/models/nope/predict", {"inputs": [[0.0]]})]:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == (404 if "nope" in path else 200), resp.status
        resp.read()
        conn.close()
    HotCutover(reg, fe).deploy("lm", service=DecodeService(
        lm, slots=1, max_seq_len=16, prefill_buckets="top", device="cpu"))
    fe.stop()
assert rset.stats()["resilience"]["resilience/replica_deaths"] == 1
rset.stop()
reg.stop_all()
assert int8_gemm.launches == maxpool.launches == 0
assert {"bigdl_tpu_torch." + m for m in (
    "frontend.server", "frontend.eventloop", "frontend.http1",
    "frontend.qos", "frontend.cutover", "frontend.autoscale",
    "resilience.replica_set", "serving.decode", "nn.attention",
    "models.transformer")} <= set(names)
from bigdl_tpu_torch.parallel import (build_param_specs, create_mesh,
                                      shard_module)
from bigdl_tpu_torch.serving import ShardedReplicaSet
cpu2 = create_mesh(model=2, devices=["cpu"] * 2)
tp_lm = transformer_lm(32, 16, 2, 1, max_len=32, shard=True).initialize(0)
with DecodeService(tp_lm, slots=2, max_seq_len=16, prefill_buckets="top",
                   mesh=cpu2) as tp_dec:
    assert len(tp_dec.generate([1, 2], max_new_tokens=3).tokens) == 3
tp_mlp = nn.Sequential(nn.Linear(4, 8, shard="column"), nn.ReLU(),
                       nn.Linear(8, 2, shard="row"), nn.LogSoftMax())
srs = ShardedReplicaSet(tp_mlp.initialize(0), devices=["cpu"] * 2,
                        input_spec=((4,), np.float32))
assert srs.predict(np.ones((2, 4), np.float32)).shape == (2, 2)
srs.stop()
(optim.DistriOptimizer(tp_mlp, DataSet.array(
    [Sample(np.ones(4, np.float32), np.int64(1))] * 4)
    >> SampleToMiniBatch(2), nn.ClassNLLCriterion(), device="cpu",
    mesh=cpu2, param_specs=build_param_specs(tp_mlp))
 .set_end_when(optim.max_iteration(2)).optimize())
assert nn.quantize(resnet_cifar(8, format="NHWC").initialize(0),
                   mode="dynamic")(torch.rand(1, 32, 32, 3)).shape == (1, 10)
assert int8_gemm.launches == maxpool.launches == 0
assert {"bigdl_tpu_torch." + m for m in (
    "parallel.tensor_parallel", "serving.sharded")} <= set(names)
assert {"bigdl_tpu_torch." + m for m in (
    "optim.predictor", "estimator", "keras.backend", "keras.layers",
    "keras.topology", "interop.keras_format", "interop.session",
    "interop.tf_queues", "dataset.news20", "dataset.tfrecord",
    "nn.spatial_extras", "nn.tensor_extras")} <= set(names)
assert {"bigdl_tpu_torch." + m for m in (
    "dataset.seqfile", "nn.control_flow", "nn.detection", "nn.tree",
    "nn.volumetric")} <= set(names)
import os, tempfile
from bigdl_tpu_torch.dataset import seqfile
with tempfile.TemporaryDirectory() as d:
    seqfile.write_seqfile(os.path.join(d, "a.seq"),
                          [(b"n0\\n1", bytes(12))], block_compressed=True)
    assert seqfile.image_samples([os.path.join(d, "a.seq")])[0].label == 0
assert nn.BinaryTreeLSTM(4, 3).initialize(0)((
    torch.ones(1, 2, 4), torch.tensor([[[0., 0, 1], [0, 0, 2],
                                        [1, 2, 0]]]))).shape == (1, 3, 3)
assert nn.nms(torch.tensor([[0., 0, 4, 4], [0, 0, 4, 4]]),
              torch.tensor([1., 2.]), 0.5, 2)[0].tolist() == [1, -1]
assert nn.VolumetricConvolution(1, 2, 2, 2, 2).initialize(0)(
    torch.ones(1, 1, 3, 3, 3)).shape == (1, 2, 2, 2, 2)
loop = nn.While(lambda c: c[0] < 3, nn.Lambda(lambda c: (c[0] + 1, c[1])),
                max_trip_count=5)
assert int(loop((torch.tensor(0), torch.ones(2)))[0]) == 3
assert int8_gemm.launches == maxpool.launches == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.startswith("jaxlib") or m == "bigdl_tpu"
             or m.startswith("bigdl_tpu.") or m.startswith("h5py"))
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


def _imported_modules(path):
    """Every module an ``import`` statement in ``path`` names, at any
    depth: module level, function and method bodies, branches."""
    import ast
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_import_anywhere_names_the_reference_or_jax():
    """A lazy ``from bigdl_tpu.`` inside a method passes an import-time
    check and fails only when its route runs (the front end's copied
    request paths import inside methods), so every import statement of
    the port and of ``chip_smoke.py`` is read, function bodies too."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(REPO, "bigdl_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "bigdl_tpu")]
    assert bad == []
    assert len(files) > 100


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

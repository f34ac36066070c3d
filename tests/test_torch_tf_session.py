"""``TFSession`` and ``QueuePipeline`` (``interop/session.py``,
``interop/tf_queues.py``), TFRecord files (``dataset/tfrecord.py``) and
the 20 Newsgroups loader (``dataset/news20.py``) of the port on the CPU
against the reference's.

- ``TFSession.train`` of a GraphDef saved with ``trainable=True`` (its
  variables start from their Assign initializers in both packages) over
  the same data order: each step's loss and the trained graph's outputs
  within ``rtol=1e-4`` (``atol=1e-4*max|y|`` for the outputs): 12 Adam
  steps, whose sign-like update carries the f32 sums' other order into
  the weights (the losses differ by up to 3.8e-5 on the CPU).
- The queue-fed form over a TFRecord file the test writes: the replayed
  pipeline's batches bitwise, each step's loss within ``rtol=1e-5,
  atol=1e-7``.
- TFRecord files byte-identical to the reference writer's; Examples
  decoded alike; ``news20`` bitwise.
"""

import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent on the card

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset import news20 as jnews20  # noqa: E402
from bigdl_tpu.dataset import tfrecord as jtfrecord  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.interop.session import TFSession as JSession  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import (DataSet, Sample,  # noqa: E402
                                     SampleToMiniBatch, news20, tfrecord)
from bigdl_tpu_torch.interop import save_tf_graph  # noqa: E402
from bigdl_tpu_torch.interop.session import TFSession  # noqa: E402
from bigdl_tpu_torch.interop.tf_queues import QueuePipeline  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tfgraph_util as tg  # noqa: E402


@pytest.fixture(scope="module")
def trainable_pb(tmp_path_factory):
    """A classifier's GraphDef with its weights as VariableV2 nodes."""
    model = nn.Sequential(nn.Linear(4, 16), nn.ReLU(), nn.Linear(16, 3),
                          nn.LogSoftMax()).initialize(0)
    pb = str(tmp_path_factory.mktemp("tf") / "model.pb")
    save_tf_graph(model, pb, input_shape=(1, 4), trainable=True)
    return pb


def _blobs(n=96):
    rng = np.random.RandomState(1)
    centers = rng.randn(3, 4) * 3
    y = rng.randint(0, 3, n)
    x = (centers[y] + rng.randn(n, 4)).astype(np.float32)
    return x, y.astype(np.int32)


def _recording(cls, losses):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            losses.append(float(self.state["loss"]))
    return Recording


def test_session_train_matches_reference(trainable_pb, monkeypatch):
    x, y = _blobs()
    got_l, want_l = [], []
    monkeypatch.setattr(optim, "LocalOptimizer",
                        _recording(optim.LocalOptimizer, got_l))
    monkeypatch.setattr(joptim, "LocalOptimizer",
                        _recording(joptim.LocalOptimizer, want_l))
    sess = TFSession(trainable_pb, inputs=["input"], outputs=["output"],
                     device="cpu")
    jsess = JSession(trainable_pb, inputs=["input"], outputs=["output"])
    np.testing.assert_allclose(sess.run(x), np.asarray(jsess.run(x)),
                               rtol=1e-5, atol=1e-6)
    opt = sess.train(DataSet.array([Sample(a, b) for a, b in zip(x, y)])
                     >> SampleToMiniBatch(16), nn.ClassNLLCriterion(),
                     optim_method=optim.Adam(learning_rate=0.05),
                     end_when=optim.max_epoch(2))
    jopt = jsess.train(
        JDataSet.array([JSample(a, b) for a, b in zip(x, y)])
        >> JSampleToMiniBatch(16), jnn.ClassNLLCriterion(),
        optim_method=joptim.Adam(learning_rate=0.05),
        end_when=joptim.max_epoch(2))
    assert len(got_l) == len(want_l) == 12
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4)
    assert opt.state["neval"] == jopt.state["neval"]
    got, want = sess.run(x), np.asarray(jsess.run(x))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _records(path, n=64, seed=0):
    rng = np.random.default_rng(seed)
    true_w = np.float32([1.0, -2.0, 3.0, 0.5])
    recs = []
    for _ in range(n):
        v = rng.normal(0, 1, 4).astype(np.float32)
        recs.append(np.concatenate([v, [v @ true_w]]).astype(
            np.float32).tobytes())
    tfrecord.write_records(path, recs)
    return recs


@pytest.mark.parametrize("end", [None, 5], ids=["epochs", "max_iteration"])
def test_queue_fed_training_matches_reference(tmp_path, end):
    rec = str(tmp_path / "train.tfrecord")
    _records(rec)
    pb = str(tmp_path / "queue.pb")
    with open(pb, "wb") as f:
        f.write(tg.build_queue_graph(rec))
    sess = TFSession(pb, outputs=["loss"], device="cpu")
    jsess = JSession(pb, outputs=["loss"])
    assert sess.pipeline.batch_size == jsess.pipeline.batch_size == 8
    assert sess.pipeline.dequeue == jsess.pipeline.dequeue == "dq"
    for a, b in zip(sess.pipeline.batches(epochs=2),
                    jsess.pipeline.batches(epochs=2)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got = sess.train(optim_method=optim.SGD(learning_rate=0.1), epochs=3,
                     **({} if end is None else
                        {"end_when": optim.max_iteration(end)}))
    want = jsess.train(optim_method=joptim.SGD(learning_rate=0.1), epochs=3,
                       **({} if end is None else
                          {"end_when": joptim.max_iteration(end)}))
    assert len(got) == len(want) == (24 if end is None else end)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[-1] < got[0]
    w = sess.graph.W.detach().numpy()
    np.testing.assert_allclose(
        w, np.asarray(jsess.graph._params["W"]), rtol=1e-5, atol=1e-6)


def test_cached_const_enqueue_and_shuffle_queue(tmp_path):
    """The reference session's other two sources: a constant
    EnqueueMany (no reader) and a RandomShuffleQueue (numpy's shuffle:
    the same order as the reference's)."""
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    g = (tg.node("data", "Const", value=tg.attr_tensor(xs))
         + tg.node("q", "FIFOQueueV2")
         + tg.node("enq", "QueueEnqueueManyV2", ["q", "data"])
         + tg.node("n", "Const", value=tg.int_scalar_const(3))
         + tg.node("dq", "QueueDequeueManyV2", ["q", "n"])
         + tg.node("two", "Const", value=tg.scalar_const(2.0))
         + tg.node("out", "Mul", ["dq", "two"]))
    pb = str(tmp_path / "cached.pb")
    with open(pb, "wb") as f:
        f.write(g)
    sess = TFSession(pb, outputs=["out"], device="cpu")
    feeds = list(sess.pipeline.batches())
    assert len(feeds) == 2
    np.testing.assert_allclose(sess.run(feeds[0]), xs[:3] * 2)

    rec = str(tmp_path / "s.tfrecord")
    tfrecord.write_records(rec, [np.float32([i]).tobytes()
                                 for i in range(32)])
    g = (tg.node("filenames", "Const", value=tg.string_const([rec]))
         + tg.node("fq", "FIFOQueueV2")
         + tg.node("fq_enq", "QueueEnqueueManyV2", ["fq", "filenames"])
         + tg.node("reader", "TFRecordReaderV2")
         + tg.node("read", "ReaderReadV2", ["reader", "fq"])
         + tg.node("v", "DecodeRaw", ["read:1"], out_type=tg.attr_type(1))
         + tg.node("q", "RandomShuffleQueueV2")
         + tg.node("enq", "QueueEnqueueV2", ["q", "v"])
         + tg.node("n", "Const", value=tg.int_scalar_const(32))
         + tg.node("dq", "QueueDequeueManyV2", ["q", "n"])
         + tg.node("out", "Identity", ["dq"]))
    pb = str(tmp_path / "shuf.pb")
    with open(pb, "wb") as f:
        f.write(g)
    got = next(iter(TFSession(pb, outputs=["out"], device="cpu")
                    .pipeline.batches(seed=3)))["dq:0"].reshape(-1)
    want = next(iter(JSession(pb, outputs=["out"]).pipeline.batches(
        seed=3)))["dq:0"].reshape(-1)
    assert sorted(got.tolist()) == list(range(32))
    assert got.tolist() == want.tolist() != list(range(32))


def test_queue_pipeline_refusals(tmp_path):
    g = tg.node("x", "Placeholder") + tg.node("y", "Identity", ["x"])
    pb = str(tmp_path / "plain.pb")
    with open(pb, "wb") as f:
        f.write(g)
    from bigdl_tpu_torch.interop.tf_format import parse_graphdef_binary
    with pytest.raises(ValueError, match="not a queue-fed graph"):
        QueuePipeline(parse_graphdef_binary(g), ["y"])
    sess = TFSession(pb, inputs=["x"], outputs=["y"], device="cpu")
    with pytest.raises(ValueError, match="queue pipeline"):
        sess.train()
    with pytest.raises(ValueError, match="criterion"):
        sess.train(DataSet.array([]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TFSession(pb, inputs=["x"], outputs=["y"])


# ----------------------------------------------------------- TFRecord
EXAMPLES = [
    {"img": b"abc", "label": 3, "w": np.array([1.0, 2.0]), "name": "x"},
    {"img": b"de", "label": np.array([-1, 5, 2 ** 40]), "w": [0.25]},
    {"empty_f": np.zeros(0, np.float32), "big": np.arange(300)},
]


def test_tfrecord_files_byte_identical(tmp_path):
    for name, write, jwrite, payload in (
            ("records", tfrecord.write_records, jtfrecord.write_records,
             [b"payload-one", b"", bytes(range(256)) * 9]),
            ("examples", tfrecord.write_examples, jtfrecord.write_examples,
             EXAMPLES)):
        a, b = str(tmp_path / f"{name}_t"), str(tmp_path / f"{name}_j")
        write(a, payload)
        jwrite(b, payload)
        assert open(a, "rb").read() == open(b, "rb").read(), name
    got = list(tfrecord.read_examples(a))
    want = list(jtfrecord.read_examples(b))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], list):
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert list(tfrecord.read_records(str(tmp_path / "records_j"))) \
        == list(jtfrecord.read_records(str(tmp_path / "records_j")))


def test_tfrecord_crc_detects_corruption(tmp_path):
    p = str(tmp_path / "x.tfrecord")
    tfrecord.write_records(p, [b"payload-one"])
    raw = bytearray(open(p, "rb").read())
    raw[14] ^= 0xFF  # a payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="data crc"):
        list(tfrecord.read_records(p))
    assert list(tfrecord.read_records(p, verify_crc=False))[0] \
        != b"payload-one"
    raw = bytearray(open(p, "rb").read())
    raw[2] ^= 0x01  # the length
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="length crc"):
        list(tfrecord.read_records(p))


# -------------------------------------------------------------- news20
def test_news20_bitwise(tmp_path):
    for cat, docs in (("sci.space", ["orbit launch", "moon \xe9clipse"]),
                      ("alt.atheism", ["one", "two", "three"])):
        os.makedirs(tmp_path / cat)
        for i, d in enumerate(docs):
            (tmp_path / cat / f"{i:05d}").write_bytes(d.encode("latin-1"))
    got, want = news20.load(str(tmp_path)), jnews20.load(str(tmp_path))
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    got, want = news20.synthetic_news(300, 20, seed=4), \
        jnews20.synthetic_news(300, 20, seed=4)
    assert got[0] == want[0] and got[2] == want[2]
    assert np.array_equal(got[1], want[1]) and got[1].dtype == np.int32

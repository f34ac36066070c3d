"""Public methods of the reference that the port lacked, against the
reference on the CPU: ``Sample.from_ndarray``/``feature_size``/
``label_size``, ``Transformer.chain``, ``CheckpointManager.manifest``,
``AsyncSnapshotWriter.pending`` and ``Module``'s eager conveniences
(``predict``, ``predict_class``, ``evaluate_on``, ``evaluate``,
``training_mode``, ``zero_grad_parameters``, ``set_name``/``get_name``).

Predictions within ``rtol=1e-5, atol=1e-5*max|y|`` of the reference's
(f32 convolutions summed in another order); class ids, shapes, counts and
manifests equal.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card
import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import dataset as jdataset  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu_torch import dataset as tdataset  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from bigdl_tpu_torch.checkpoint.snapshot import (  # noqa: E402
    AsyncSnapshotWriter, read_manifest)
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402


@pytest.fixture(scope="module")
def lenets():
    """(port LeNet-5, the reference's with the same weights)."""
    port = lenet5(10).initialize(5)
    params, state = to_jax_params(port)
    ref = jax_lenet5(10)
    ref._params = jax.tree_util.tree_map(jnp.asarray, params)
    ref._state = jax.tree_util.tree_map(jnp.asarray, state)
    return port, ref


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, 1, 28, 28)).astype(np.float32)


def test_sample_from_ndarray_and_sizes():
    f, lab = [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], [7]
    got = tdataset.Sample.from_ndarray(f, lab)
    want = jdataset.Sample.from_ndarray(f, lab)
    assert isinstance(got.feature, np.ndarray)
    np.testing.assert_array_equal(got.feature, want.feature)
    np.testing.assert_array_equal(got.label, want.label)
    assert got.feature_size() == want.feature_size() == (2, 3)
    assert got.label_size() == want.label_size() == (1,)
    alone = tdataset.Sample.from_ndarray(f)
    assert alone.label is None and alone.label_size() is None \
        == jdataset.Sample.from_ndarray(f).label_size()


def test_transformer_chain_is_the_pipe():
    double = tdataset.FnTransformer(lambda v: 2 * v)
    inc = tdataset.FnTransformer(lambda v: v + 1)
    chained = double.chain(inc)
    assert isinstance(chained, tdataset.ChainedTransformer)
    assert list(chained(iter(range(5)))) == list((double >> inc)(
        iter(range(5)))) == [1, 3, 5, 7, 9]


def test_checkpoint_manifest_and_writer_pending(tmp_path):
    """``manifest()`` of the newest valid snapshot (None before any),
    equal to ``read_manifest`` of its path, and no pin left behind;
    ``pending()`` counts the writer's uncommitted jobs."""
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.manifest() is None
    mgr.save(3, tree)
    mgr.save(7, tree)
    newest = mgr.path_for(7)
    got = mgr.manifest()
    assert got == read_manifest(newest) and got is not None
    assert mgr.manifest(mgr.path_for(3)) == read_manifest(mgr.path_for(3))
    assert mgr._pinned_step is None
    writer = AsyncSnapshotWriter()
    assert writer.pending() == 0
    done = []
    writer.submit(lambda: done.append(1))
    writer.drain()
    assert writer.pending() == 0 and done == [1]
    writer.close()


def test_module_predict_and_predict_class_match_reference(lenets):
    port, ref = lenets
    x = _images(37)
    got = port.predict(x, batch_size=16, device="cpu")
    want = np.asarray(ref.predict(x, batch_size=16))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(
        port.predict_class(x, batch_size=16, device="cpu"),
        np.asarray(ref.predict_class(x, batch_size=16)))
    assert not port.training  # the predictor leaves it in eval mode


def test_module_evaluate_on_matches_reference(lenets):
    port, ref = lenets
    x = _images(40, seed=1)
    y = np.random.default_rng(2).integers(0, 10, 40).astype(np.int64)

    def dataset(dsm, to_batch):
        return dsm.DataSet.array([dsm.Sample(a, b) for a, b in zip(x, y)]) \
            >> to_batch(16)

    got = port.evaluate_on(dataset(tdataset, tdataset.SampleToMiniBatch),
                           [optim.Top1Accuracy(), optim.Loss()],
                           device="cpu")
    want = ref.evaluate_on(dataset(jdataset, jdataset.SampleToMiniBatch),
                           [joptim.Top1Accuracy(), joptim.Loss()])
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].count == want[k].count
        np.testing.assert_allclose(got[k].result, want[k].result,
                                   rtol=1e-5)


def test_module_modes_names_and_zeroed_grads():
    m = nn.Sequential().add(nn.Linear(4, 3)).initialize(1).requires_grad_()
    assert m.evaluate() is m and not m.training
    assert all(not c.training for c in m.modules())
    assert m.training_mode() is m and m.training
    assert m.set_name("head") is m and m.get_name() == "head"
    m(torch.ones(2, 4)).sum().backward()
    grads = [p.grad for p in m.parameters()]
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
    m.zero_grad_parameters()
    assert all(p.grad is not None and not p.grad.any()
               for p in m.parameters())

"""Checkpoints, resume, preemption and the numeric guard of the port, on
the CPU, against the reference where a file crosses packages.

- The ``.npz`` v3 wire: the manifest with a CRC32-C per array, torn and
  corrupt files skipped by ``latest_valid``, retention, non-overwrite.
- The schema: a snapshot of another architecture is refused.
- Across packages: the reference's ``verify_snapshot`` / ``load_snapshot``
  read the port's LeNet snapshot and its ``lenet5`` gives the port's
  output from it (``rtol=1e-5, atol=1e-5``); the port resumes a
  reference LeNet snapshot (parameters, momentum, counters and data
  position bitwise) and its next steps' losses match the reference's
  continuation within ``rtol=1e-5``.
- Resume within the port is bitwise (losses and final parameters) at K=1
  and K=4: in process, after a SIGTERM preemption in process, and after a
  SIGKILL of a child process (``tests/torch_ckpt_child.py``).
- The numeric guard: ``off`` changes neither losses nor dispatch count;
  ``skip`` drops a NaN step's update (parameters and momentum bitwise as
  before it); ``abort`` raises at the exact iteration; ``rollback``
  restores the latest snapshot and ends bitwise where a clean run ends.
"""

import os
import signal
import subprocess
import sys
import time
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.checkpoint import load_snapshot as jload_snapshot  # noqa: E402
from bigdl_tpu.checkpoint import verify_snapshot as jverify_snapshot  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset import image as jimage  # noqa: E402
from bigdl_tpu.dataset import mnist as jmnist  # noqa: E402
from bigdl_tpu.models.lenet import lenet5 as jax_lenet5  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                        SchemaMismatchError, read_manifest,
                                        verify_snapshot)
from bigdl_tpu_torch.checkpoint.snapshot import (crc32c_of,  # noqa: E402
                                                 load_snapshot)
from bigdl_tpu_torch.dataset import DataSet, MiniBatch, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset import Transformer, image, mnist  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import lenet5  # noqa: E402
from bigdl_tpu_torch.resilience.numeric import NonFiniteStepError  # noqa: E402
from bigdl_tpu_torch.utils import checkpoint as shim  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_ckpt_child as child  # noqa: E402


def _pipeline(pkg, n=96, batch=16, seed=0, extra=None):
    img, mn, D, S2B = pkg
    imgs, labels = mn.synthetic_mnist(n, seed=seed)
    ds = (D.array(mn.to_samples(imgs, labels))
          >> img.BytesToGreyImg()
          >> img.GreyImgNormalizer(mn.TRAIN_MEAN, mn.TRAIN_STD)
          >> S2B(batch))
    return ds >> extra if extra is not None else ds


PORT = (image, mnist, DataSet, SampleToMiniBatch)
REF = (jimage, jmnist, JDataSet, JSampleToMiniBatch)


class Losses:
    """TrainSummary stand-in: {step: loss}, and an optional action at one
    step."""

    def __init__(self, at=None):
        self.by_step, self.at = {}, at

    def add_train_step(self, step, loss, lr, throughput):
        self.by_step[step] = loss
        if self.at is not None and step == self.at[0]:
            self.at[1]()

    def add_scalar(self, *a):
        pass

    def trigger_for(self, name):
        return None


def _port_opt(ckpt, iters, k, model=None, every=3, summary=None,
              extra=None, guard=None):
    opt = (optim.LocalOptimizer(model or child.mlp(),
                                _pipeline(PORT, extra=extra),
                                nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(optim.SGD(0.05, momentum=0.9))
           .set_steps_per_dispatch(k).set_seed(7)
           .set_end_when(optim.max_iteration(iters))
           .set_train_summary(summary or Losses()))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), optim.several_iteration(every))
    if guard is not None:
        opt.set_numeric_guard(guard)
    return opt


def _params(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------------ wire
def test_manifest_crc_and_torn_file_skip(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"0": {}, "1": {"weight": torch.from_numpy(
        rng.normal(size=(4, 3)).astype(np.float32)),
        "bias": torch.zeros(4, dtype=torch.bfloat16)}}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    for step in (3, 6):
        mgr.save(step, tree, {"0": {}, "1": {}}, {"velocity": tree},
                 driver_state={"neval": step, "epoch": 0})
    path = mgr.path_for(6)
    m = read_manifest(path)
    assert m["version"] == 3 and m["step"] == 6 and m["epoch"] == 0
    assert len(m["arrays"]) == 4
    w = tree["1"]["weight"].numpy()
    assert any(e["crc32c"] == crc32c_of(w) and e["nbytes"] == w.nbytes
               for e in m["arrays"])
    assert verify_snapshot(path)[0]
    assert jverify_snapshot(path)[0]  # the reference verifies it too
    blob = load_snapshot(path)
    assert blob["params"]["1"]["bias"].dtype == torch.bfloat16
    assert torch.equal(blob["opt_state"]["velocity"]["1"]["weight"],
                       tree["1"]["weight"])
    # a torn newest file: skipped, the older one returned
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) // 2])
    ok, detail = verify_snapshot(path)
    assert not ok
    assert mgr.latest_valid() == mgr.path_for(3)
    # a flipped byte in an array of a well-formed zip: only the manifest's
    # CRC32-C sees it, and the file is skipped too
    with zipfile.ZipFile(mgr.path_for(3)) as zf:
        members = {n: bytearray(zf.read(n)) for n in zf.namelist()}
    members["a0.npy"][-3] ^= 0xFF
    with zipfile.ZipFile(mgr.path_for(3), "w") as zf:
        for n, data in members.items():
            zf.writestr(n, bytes(data))
    ok, detail = verify_snapshot(mgr.path_for(3))
    assert not ok and "crc32c" in detail
    assert mgr.latest_valid() is None
    assert mgr._registry is None
    assert shim.latest_checkpoint(str(tmp_path)) is None


def test_retention_and_non_overwrite(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, keep_every=4,
                            async_save=True)
    tree = {"w": torch.ones(2)}
    for step in range(1, 10):
        mgr.save(step, tree, driver_state={"neval": step})
    mgr.wait()
    assert mgr.steps() == [4, 8, 9]
    mgr.overwrite = False
    with pytest.raises(FileExistsError):
        mgr.save(9, tree)
    mgr.close()
    # the shim writes and reads the same wire
    p = shim.save_checkpoint(str(tmp_path / "shim"), tree, neval=2)
    assert p.endswith("model.2")
    assert torch.equal(shim.load_checkpoint(p)["params"]["w"], tree["w"])
    with pytest.raises(FileExistsError):
        shim.save_checkpoint(str(tmp_path / "shim"), tree, neval=2,
                             overwrite=False)


def test_over_write_checkpoint_false_raises(tmp_path):
    _port_opt(tmp_path, 3, 1).optimize()
    opt = _port_opt(tmp_path, 3, 1).over_write_checkpoint(False)
    with pytest.raises(FileExistsError):
        opt.optimize()


def test_schema_mismatch_refused(tmp_path):
    (optim.LocalOptimizer(lenet5(10).initialize(0), _pipeline(PORT),
                          nn.ClassNLLCriterion(), device="cpu")
     .set_end_when(optim.max_iteration(2))
     .set_checkpoint(str(tmp_path), optim.several_iteration(2)).optimize())
    opt = (optim.LocalOptimizer(lenet5(5).initialize(0), _pipeline(PORT),
                                nn.ClassNLLCriterion(), device="cpu")
           .set_checkpoint(str(tmp_path), optim.several_iteration(2)))
    with pytest.raises(SchemaMismatchError, match="architecture"):
        opt.resume()
    # the optimizer method is part of the schema too
    opt = (optim.LocalOptimizer(lenet5(10).initialize(0), _pipeline(PORT),
                                nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(optim.Adam())
           .set_end_when(optim.max_iteration(3))
           .set_checkpoint(str(tmp_path), optim.several_iteration(2)))
    assert opt.resume()
    with pytest.raises(SchemaMismatchError, match="optim_method"):
        opt.optimize()


# --------------------------------------------------------- cross-package
def _lenet_port_opt(ckpt, iters, start_model, summary=None):
    return (optim.LocalOptimizer(start_model, _pipeline(PORT),
                                 nn.ClassNLLCriterion(), device="cpu")
            .set_optim_method(optim.SGD(0.05, momentum=0.9))
            .set_end_when(optim.max_iteration(iters))
            .set_train_summary(summary or Losses())
            .set_checkpoint(str(ckpt), optim.several_iteration(3)))


def test_reference_reads_port_snapshot(tmp_path):
    model = lenet5(10).initialize(2)
    _lenet_port_opt(tmp_path, 3, model).optimize()
    path = str(tmp_path / "model.3")
    ok, detail = jverify_snapshot(path)
    assert ok, detail
    blob = jload_snapshot(path)
    assert blob["driver_state"]["neval"] == 3
    assert blob["run"]["dataset_position"] == {"shuffle_epoch": 0}
    x = ((mnist.synthetic_mnist(8, seed=5)[0].astype(np.float32)
          - mnist.TRAIN_MEAN) / mnist.TRAIN_STD).astype(np.float32)
    want, _ = jax_lenet5(10).apply(blob["params"], blob["model_state"],
                                   jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the momentum in the reference's SGD layout
    vel = blob["opt_state"]["velocity"]
    assert jax.tree_util.tree_structure(vel) == \
        jax.tree_util.tree_structure(blob["params"])


def test_port_resumes_reference_snapshot(tmp_path):
    start = to_jax_params(lenet5(10).initialize(4))
    jm = jax_lenet5(10)
    jm._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    jm._state = start[1]
    jlog = Losses()
    (joptim.LocalOptimizer(jm, _pipeline(REF), jnn.ClassNLLCriterion())
     .set_optim_method(joptim.SGD(0.05, momentum=0.9))
     .set_end_when(joptim.max_iteration(9))
     .set_train_summary(jlog)
     .set_checkpoint(str(tmp_path), joptim.several_iteration(3))
     .optimize())
    jblob = jload_snapshot(str(tmp_path / "model.6"))
    model = lenet5(10)
    tlog = Losses()
    opt = _lenet_port_opt(tmp_path / "port", 9, model, tlog)
    assert opt.resume(str(tmp_path / "model.6"))
    for key in ("neval", "epoch", "records_processed_this_epoch"):
        assert opt.state[key] == jblob["driver_state"][key]
    tp, _ = to_jax_params(model)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa
    for path, v in flat(jax.tree_util.tree_map(np.asarray,
                                               jblob["params"])).items():
        np.testing.assert_array_equal(flat(tp)[path], v)
    opt.optimize()
    assert sorted(tlog.by_step) == [7, 8, 9]
    np.testing.assert_allclose([tlog.by_step[s] for s in (7, 8, 9)],
                               [jlog.by_step[s] for s in (7, 8, 9)],
                               rtol=1e-5)
    assert opt.state["epoch"] == 1  # 6 steps an epoch: crossed it


# ------------------------------------------------------- resume, bitwise
@pytest.fixture(scope="module")
def uninterrupted():
    """The 16-iteration MLP run at K=1: losses and final parameters."""
    log = Losses()
    opt = _port_opt(None, 16, 1, summary=log)
    opt.optimize()
    return log.by_step, _params(opt.model)


@pytest.mark.parametrize("k", [1, 4])
def test_in_process_resume_bitwise(tmp_path, uninterrupted, k):
    ref_losses, ref_params = uninterrupted
    first = Losses()
    _port_opt(tmp_path, 8, k, summary=first).optimize()  # model.6 last
    os.unlink(tmp_path / "model.6")  # resume from model.3, mid-epoch
    second = Losses()
    opt = _port_opt(tmp_path, 16, k, summary=second)
    assert opt.resume()
    assert opt.state["neval"] == 3
    opt.optimize()
    assert sorted(second.by_step) == list(range(4, 17))
    for s, loss in {**first.by_step, **second.by_step}.items():
        assert loss == ref_losses[s], s
    _assert_bitwise(_params(opt.model), ref_params)


def test_preemption_in_process_resumes_bitwise(tmp_path, uninterrupted):
    ref_losses, ref_params = uninterrupted
    prev = signal.getsignal(signal.SIGTERM)

    def preempt():
        h = opt._preemption
        if h.installed:  # the main thread: a real signal
            os.kill(os.getpid(), signal.SIGTERM)
        else:
            h.request()

    # K=2: the signal lands while step 7 replays, after the block of steps
    # 9-10 is enqueued; that block finishes, mid-epoch (6 steps an epoch)
    first = Losses(at=(7, preempt))
    opt = _port_opt(tmp_path, 16, 2, every=100,
                    summary=first).set_preemption_handling()
    opt.optimize()
    assert opt.state["preempted"]
    assert signal.getsignal(signal.SIGTERM) is prev  # uninstalled
    stop = opt.state["neval"]
    assert stop == 10 and opt.state["records_processed_this_epoch"] == 64
    assert os.path.exists(tmp_path / f"model.{stop}")
    second = Losses()
    opt2 = _port_opt(tmp_path, 16, 2, every=100, summary=second)
    assert opt2.resume() and opt2.state["neval"] == stop
    opt2.optimize()
    assert "preempted" not in opt2.state
    for s, loss in {**first.by_step, **second.by_step}.items():
        assert loss == ref_losses[s], s
    _assert_bitwise(_params(opt2.model), ref_params)


def _run_child(args, wait=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(HERE) + os.pathsep \
        + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_ckpt_child.py")] + args,
        cwd=os.path.dirname(HERE), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    if not wait:
        return proc
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err.decode()[-2000:]
    return out.decode()


def _read_losses(path):
    out = {}
    if os.path.exists(path):
        for line in open(path):
            parts = line.split()
            if len(parts) == 2:
                out[int(parts[0])] = float(parts[1])
    return out


@pytest.fixture(scope="module")
def child_reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("child_ref")
    losses, params = str(d / "l.txt"), str(d / "p.npz")
    _run_child(["--dir", str(d / "ck"), "--losses", losses,
                "--params-out", params])
    with np.load(params) as z:
        return _read_losses(losses), {k: z[k] for k in z.files}


@pytest.mark.parametrize("k", [1, 4])
def test_sigkill_child_resumes_bitwise(tmp_path, child_reference, k):
    ref_losses, ref_params = child_reference
    d, la, lb = str(tmp_path / "ck"), str(tmp_path / "a"), \
        str(tmp_path / "b")
    pout = str(tmp_path / "p.npz")
    proc = _run_child(["--dir", d, "--losses", la, "--k", str(k)],
                      wait=False)
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            if max(_read_losses(la), default=0) >= 8 and \
                    os.path.isdir(d) and any(
                        f.startswith("model.") and not f.endswith(".tmp")
                        for f in os.listdir(d)):
                break
            time.sleep(0.01)
    finally:
        proc.kill()
    proc.wait(timeout=30)
    _run_child(["--dir", d, "--losses", lb, "--k", str(k), "--resume",
                "--params-out", pout])
    a, b = _read_losses(la), _read_losses(lb)
    assert min(b) > 1 and max(b) == 16  # resumed, not restarted
    combined = {**a, **b}
    assert sorted(combined) == list(range(1, 17))
    for s, loss in combined.items():
        assert loss == ref_losses[s], s
    with np.load(pout) as z:
        for name, v in ref_params.items():
            np.testing.assert_array_equal(z[name], v, err_msg=name)


# ---------------------------------------------------------- numeric guard
class PoisonBatch(Transformer):
    """Fills the ``at``-th batch this transformer ever passes (counted
    across epochs and resumes) with NaN."""

    def __init__(self, at):
        self.at, self.seen = at, 0

    def __call__(self, it):
        for b in it:
            self.seen += 1
            if self.seen == self.at:
                b = MiniBatch(np.full_like(b.input, np.nan), b.target)
            yield b


def test_guard_off_is_inert(uninterrupted):
    ref_losses, ref_params = uninterrupted
    runs = {}
    for guard in ("off", "skip", None):
        log = Losses()
        opt = _port_opt(None, 16, 4, summary=log, guard=guard)
        opt.optimize()
        runs[guard] = (log.by_step, opt._dispatch_count, _params(opt.model))
    base = _port_opt(None, 16, 4)
    base.optimize()
    for guard, (losses, dispatches, params) in runs.items():
        assert losses == ref_losses, guard
        assert dispatches == base._dispatch_count, guard
        _assert_bitwise(params, ref_params)


def test_guard_skip_drops_the_nan_step(tmp_path):
    opt = _port_opt(tmp_path, 8, 4, every=1, extra=PoisonBatch(5),
                    guard="skip")
    opt.optimize()
    assert np.isnan(opt.train_summary.by_step[5])
    assert opt.registry.counter("resilience/steps_skipped").value == 1
    before = load_snapshot(str(tmp_path / "model.4"))
    after = load_snapshot(str(tmp_path / "model.5"))
    for key in ("params", "opt_state"):
        for (p, a), (_, b) in zip(
                jax.tree_util.tree_leaves_with_path(before[key]),
                jax.tree_util.tree_leaves_with_path(after[key])):
            assert torch.equal(a, b), (key, p)
    assert all(torch.isfinite(p).all() for p in opt.model.parameters())
    assert np.isfinite(opt.train_summary.by_step[8])


def test_guard_abort_raises_at_the_iteration():
    opt = _port_opt(None, 8, 4, extra=PoisonBatch(6), guard="abort")
    with pytest.raises(NonFiniteStepError) as e:
        opt.optimize()
    assert e.value.step == 5 and opt.state["neval"] == 6
    assert e.value.policy == "abort"


def test_guard_rollback_restores(tmp_path, uninterrupted):
    ref_losses, ref_params = uninterrupted
    with pytest.raises(ValueError, match="set_checkpoint"):
        _port_opt(None, 4, 1, guard="rollback").optimize()
    opt = _port_opt(tmp_path, 16, 4, extra=PoisonBatch(8),
                    guard="rollback")
    opt.optimize()
    assert opt.registry.counter("resilience/rollbacks").value == 1
    assert opt.state["neval"] == 16
    # after the rollback to model.6 the run replays what a clean run does
    assert {s: opt.train_summary.by_step[s] for s in range(7, 17)} == \
        {s: ref_losses[s] for s in range(7, 17)}
    _assert_bitwise(_params(opt.model), ref_params)

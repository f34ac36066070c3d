"""spmdcheck in the port (``bigdl_tpu_torch/utils/spmdcheck.py``).

The reference's own cases (``tests/test_spmdcheck.py``: divergence
detection, inertness, the driver emulation under ``participant(pid)``)
run here against the port's copy and the port's ``LocalOptimizer``: the
reference file's source, with its imports pointed at the port, is
executed into this module.  Its composition case (a pytest session under
both sanitizers' environment switches) exercises the reference's
conftest and stays with the reference.

Beyond it: one small ``DistriOptimizer`` run records the same (kind,
axis, fingerprint) schedule in both packages, and a planted divergence
(one emulated process checkpointing where the other does not) is
reported with both schedules.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from torch_reference_cases import PORTED, load_reference_cases  # noqa: E402

exec(load_reference_cases("test_spmdcheck.py", PORTED,  # noqa: S102
                          drop=("TestComposition",)))

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import Sample as JSample  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.utils import spmdcheck as jspmdcheck  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402


def _samples(S):
    rng = np.random.default_rng(0)
    return [S(rng.normal(0, 1, (16,)).astype(np.float32),
              np.int32(rng.integers(0, 4))) for _ in range(64)]


def _distri(port, start, tmp, ckpt_every=3):
    if port:
        model = nn.Sequential(nn.Linear(16, 16), nn.ReLU(),
                              nn.Linear(16, 4), nn.LogSoftMax())
        from bigdl_tpu_torch.interop import load_jax_params
        load_jax_params(model, *start)
        opt = optim.DistriOptimizer(
            model, DataSet.array(_samples(Sample)) >> SampleToMiniBatch(16),
            nn.ClassNLLCriterion(), device="cpu", grad_wire_dtype="f32")
        o = optim
    else:
        from jax.sharding import Mesh
        model = jnn.Sequential(jnn.Linear(16, 16), jnn.ReLU(),
                               jnn.Linear(16, 4), jnn.LogSoftMax())
        model._params = jax.tree_util.tree_map(jnp.asarray, start[0])
        model._state = start[1]
        opt = joptim.DistriOptimizer(
            model, JDataSet.array(_samples(JSample))
            >> JSampleToMiniBatch(16), jnn.ClassNLLCriterion(),
            mesh=Mesh(np.array(jax.devices()[:1]), ("data",)),
            grad_wire_dtype="f32")
        o = joptim
    (opt.set_optim_method(o.SGD(learning_rate=0.1)).set_steps_per_dispatch(2)
     .set_checkpoint(tmp, o.several_iteration(ckpt_every))
     .set_end_when(o.max_iteration(6))).optimize()


def _schedule(mod):
    return [(e.kind, e.axis, e.fingerprint)
            for e in mod.schedules().get(0, [])]


def test_distri_schedule_fingerprints_as_the_reference(tmp_path):
    start = to_jax_params(nn.Sequential(
        nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
        nn.LogSoftMax()).initialize(5))
    saved = spmdcheck._RECORDER, jspmdcheck._RECORDER
    spmdcheck._RECORDER = jspmdcheck._RECORDER = None
    spmdcheck.install()
    jspmdcheck.install()
    try:
        with spmdcheck.participant(0):
            _distri(True, start, str(tmp_path / "p"))
        with jspmdcheck.participant(0):
            _distri(False, start, str(tmp_path / "j"))
        mine, ref = _schedule(spmdcheck), _schedule(jspmdcheck)
    finally:
        spmdcheck._RECORDER, jspmdcheck._RECORDER = saved
    assert mine == ref
    kinds = [k for k, _, _ in mine]
    assert {"make_global", "dispatch", "block_fetch", "checkpoint"} <= \
        set(kinds) and kinds.count("checkpoint") == 2


def test_planted_divergence_is_reported(tmp_path, sandbox):
    start = to_jax_params(nn.Sequential(
        nn.Linear(16, 16), nn.ReLU(), nn.Linear(16, 4),
        nn.LogSoftMax()).initialize(5))
    with spmdcheck.participant(0):
        _distri(True, start, str(tmp_path / "a"))
    with spmdcheck.participant(1):
        # the planted fault: this process checkpoints on another cadence
        _distri(True, start, str(tmp_path / "b"), ckpt_every=2)
    divs = spmdcheck.divergences(final=True)
    assert len(divs) == 1
    rep = divs[0].render()
    assert "checkpoint" in rep and "schedule of process 1" in rep

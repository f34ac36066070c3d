"""Rematerialization and the rest of the foundation, in the port on the CPU
(against the reference where it has a twin).

- ``Remat`` at each policy (None, ``"tails"``, ``"dots"``) and the
  optimizer's activation-memory policies against no remat: outputs,
  gradients and BatchNorm's running statistics bitwise, with a
  ``Dropout(0.5)`` inside the recomputed region drawing the same mask.
  Two planted faults must break it: BatchNorm updating its statistics
  again in the recomputed forward, and the dropout generator left where
  the first forward left it.  The same through ``LocalOptimizer`` (K=2,
  f32 and bf16, B1's plain version at the pool): losses, weights and
  statistics bitwise; in bf16 a planted ``Remat`` that keeps its block's
  parameters out of the checkpoint must fail, and a ``Remat`` straight
  around a ``Dropout`` draws one mask.
- ``resnet50(remat=True|"tails")``'s ``state_dict`` keys are the
  reference's parameter paths (``tests/test_torch_layers.py`` holds NHWC;
  here NCHW).
- ``ParallelTable``, dense ``MiniBatch.slice``, ``Engine``, the config
  fields and ``tuned.resolve_default`` against the reference on the
  checked-in ``tuned_configs.json``.
"""

import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.dataset.sample import MiniBatch as JMiniBatch  # noqa: E402
from bigdl_tpu.engine import Engine as JEngine  # noqa: E402
from bigdl_tpu.models.resnet import resnet50 as jax_resnet50  # noqa: E402
from bigdl_tpu.utils import config as jconfig  # noqa: E402
from bigdl_tpu.utils import tuned as jtuned  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch  # noqa: E402
from bigdl_tpu_torch.dataset.sample import MiniBatch, SparseMiniBatch  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import resnet50  # noqa: E402
from bigdl_tpu_torch.models.resnet import bottleneck  # noqa: E402
from bigdl_tpu_torch.nn import layers, module  # noqa: E402
from bigdl_tpu_torch.utils import config, tuned  # noqa: E402


def _net(remat, fmt="NHWC", dropout=True):
    """A conv, B1's pool and two bottlenecks (each ending in a dropout),
    the bottlenecks in ``Remat(policy=remat)`` unless ``remat="off"``."""
    m = nn.Sequential()
    m.add(nn.SpatialConvolution(3, 16, 3, 3, 1, 1, 1, 1, format=fmt))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1, format=fmt))
    for _ in range(2):
        b = bottleneck(16, 4, 1, fmt)
        if dropout:
            b.add(nn.Dropout(0.5))
        m.add(b if remat == "off" else nn.Remat(b, policy=remat))
    m.add(nn.SpatialAveragePooling(4, 4, 4, 4, format=fmt))
    m.add(nn.Reshape((16,)))
    m.add(nn.Linear(16, 5)).add(nn.LogSoftMax())
    return m


def _run_direct(mode, x, start):
    m = _net(mode)
    m.load_state_dict(start)
    m.train()
    drops = [d for d in module.walk(m) if isinstance(d, nn.Dropout)]
    for i, d in enumerate(drops):
        d.generator = torch.Generator().manual_seed(i)
    for p in m.parameters():
        p.requires_grad_(True)
    y = m(x)
    y.square().sum().backward()
    return (y.detach(), {k: p.grad for k, p in m.named_parameters()},
            {k: b.clone() for k, b in m.named_buffers()})


def _same(a, b):
    y_a, g_a, s_a = a
    y_b, g_b, s_b = b
    return (torch.equal(y_a, y_b)
            and all(torch.equal(g_a[k], g_b[k]) for k in g_a)
            and all(torch.equal(s_a[k], s_b[k]) for k in s_a))


@pytest.mark.parametrize("fault", [None, "bn_updates_twice",
                                   "dropout_redraws"])
@pytest.mark.parametrize("policy", [None, "tails", "dots"])
def test_remat_is_bitwise_no_remat(policy, fault, monkeypatch):
    if fault == "bn_updates_twice":
        monkeypatch.setattr(layers, "recomputing", lambda: False)
    elif fault == "dropout_redraws":
        monkeypatch.setattr(module._Recompute, "__enter__", lambda s: None)
        monkeypatch.setattr(module._Recompute, "__exit__",
                            lambda s, *e: False)
    x = torch.randn(4, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    start = _net("off").initialize(0).state_dict()
    assert _same(_run_direct("off", x, start),
                 _run_direct(policy, x, start)) == (fault is None)


def test_remat_is_transparent_in_the_tree():
    plain, wrapped = _net("off").initialize(0), _net(None).initialize(0)
    assert list(plain.state_dict()) == list(wrapped.state_dict())
    for (k, a), b in zip(plain.state_dict().items(),
                         wrapped.state_dict().values()):
        assert torch.equal(a, b), k
    params, state = to_jax_params(wrapped)
    load_jax_params(plain, params, state)
    moved = copy.deepcopy(wrapped).to(torch.float64)
    assert all(p.dtype == torch.float64 for p in moved[2].inner.parameters())
    wrapped.eval()
    assert not wrapped[2].inner.training


@pytest.mark.parametrize("remat", [True, "tails"])
def test_resnet50_remat_keys_are_reference_paths(remat):
    params, state = jax.eval_shape(jax_resnet50(remat=remat).init,
                                   jax.random.PRNGKey(0))
    want = {}
    for tree in (params, state):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            want[".".join(p.key for p in path)] = tuple(leaf.shape)
    got = {k: tuple(v.shape)
           for k, v in resnet50(remat=remat).state_dict().items()}
    assert got == want


def _samples(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return [Sample(rng.normal(0, 1, (8, 8, 3)).astype(np.float32),
                   np.int64(rng.integers(0, 5))) for _ in range(n)]


def _train(model, policy=None, compute=None, k=2, iters=4):
    losses = []

    class Rec(optim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    opt = (Rec(model, DataSet.array(_samples()) >> SampleToMiniBatch(6),
               nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(optim.SGD(0.05, momentum=0.9))
           .set_steps_per_dispatch(k).set_end_when(optim.max_iteration(iters)))
    if policy is not None:
        opt.set_activation_memory(policy)
    if compute is not None:
        opt.set_compute_dtype(compute)
    opt.optimize()
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("case", ["remat_true", "remat_tails",
                                  "remat_true+bf16", "remat_tails+bf16",
                                  "dots", "full", "bf16+dots", "bf16+full"])
def test_activation_memory_trains_bitwise(case):
    """Against no remat at the same compute dtype: ``bf16`` in a remat
    case is ``set_compute_dtype(bf16)``, where the recomputation runs
    under the mixed-precision ``functional_call``."""
    start = _net("off").initialize(0).state_dict()
    compute = torch.bfloat16 if "bf16" in case else None
    base = _net("off")
    base.load_state_dict(start)
    want = _train(base, compute=compute)
    if case.startswith("remat"):
        m = _net(None if case.startswith("remat_true") else "tails")
        got_kw = {"compute": compute}
    else:
        m = _net("off")
        got_kw = {"policy": case}
    m.load_state_dict(start)
    got = _train(m, **got_kw)
    assert got[0] == want[0]
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


def _remat_params_not_inputs(self, x):
    """Planted fault: the block runs on its own (f32) parameters, which
    do not enter the checkpoint, so the recomputation misses the bf16
    casts of the first forward."""
    return module.checkpointed(self.inner, self.inner, self.policy)(x)


@pytest.mark.parametrize("remat", [None, "tails"])
def test_bf16_remat_check_fails_parameters_outside_the_checkpoint(
        remat, monkeypatch):
    monkeypatch.setattr(nn.Remat, "forward", _remat_params_not_inputs)
    m = _net(remat)
    m.load_state_dict(_net("off").initialize(0).state_dict())
    with pytest.raises(RuntimeError, match="should be the same|metadata"):
        _train(m, compute=torch.bfloat16)


def test_remat_of_a_bare_dropout_draws_its_mask_once():
    """A ``Remat`` straight around a ``Dropout`` (no container between):
    the optimizer still finds the layer (``module.walk``) and gives it a
    generator, and the recomputation draws the first mask."""
    def net(wrap):
        m = nn.Sequential().add(nn.Reshape((192,))).add(nn.Linear(192, 16))
        d = nn.Dropout(0.5)
        m.add(nn.Remat(d) if wrap else d)
        return m.add(nn.Linear(16, 5)).add(nn.LogSoftMax())
    start = net(False).initialize(0).state_dict()
    a, b = net(False), net(True)
    a.load_state_dict(start)
    b.load_state_dict(start)
    want, got = _train(a), _train(b)
    assert got[0] == want[0]
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k


def test_activation_memory_policy_errors():
    opt = optim.LocalOptimizer(_net("off"), DataSet.array(_samples())
                               >> SampleToMiniBatch(6),
                               nn.ClassNLLCriterion(), device="cpu")
    with pytest.raises(ValueError, match="activation memory policy"):
        opt.set_activation_memory("everything")
    assert opt.set_activation_memory(None).activation_memory == "none"
    opt.set_activation_memory("bf16").set_compute_dtype(torch.float32)
    opt.set_end_when(optim.max_iteration(1))
    with pytest.raises(ValueError, match="conflicts"):
        opt.optimize()


def test_dropout_in_remat_redraws_nothing_through_the_optimizer():
    """Dropout's generator is reseeded every step by the training loop;
    inside a Remat the recomputed mask is the first one (bitwise against no
    remat, K=2 blocks)."""
    start = _net("off").initialize(0).state_dict()
    a, b = _net("off"), _net(None)
    a.load_state_dict(start)
    b.load_state_dict(start)
    assert _train(a)[0] == _train(b)[0]


# ----------------------------------------------------------- foundation
def test_parallel_table_matches_reference():
    rng = np.random.default_rng(2)
    t = nn.ParallelTable().add(nn.Linear(3, 2)).add(nn.ReLU())
    t.initialize(0)
    j = jnn.ParallelTable().add(jnn.Linear(3, 2)).add(jnn.ReLU())
    params, state = to_jax_params(t)
    xs = (rng.normal(0, 1, (4, 3)).astype(np.float32),
          rng.normal(0, 1, (4, 5)).astype(np.float32))
    want, _ = j.apply(jax.tree_util.tree_map(jnp.asarray, params), state,
                      tuple(jnp.asarray(x) for x in xs))
    got = t(tuple(torch.from_numpy(x) for x in xs))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-7)


def test_minibatch_slice_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (10, 3)).astype(np.float32)
    nested = (x, {"a": rng.integers(0, 9, (10, 2))})
    y = rng.integers(0, 4, (10,))
    for inp, tgt in ((x, y), (nested, y), (x, None)):
        got = MiniBatch(inp, tgt).slice(3, 4)
        want = JMiniBatch(inp, tgt).slice(3, 4)
        assert got.size() == want.size() == 4
        for g, w in zip(jax.tree_util.tree_leaves(got.input),
                        jax.tree_util.tree_leaves(want.input)):
            np.testing.assert_array_equal(g, w)
        if tgt is None:
            assert got.target is None
        else:
            np.testing.assert_array_equal(got.target, want.target)
    with pytest.raises(TypeError, match="slice"):
        SparseMiniBatch(None).slice(0, 1)


@pytest.fixture
def fresh():
    """A clean Engine, config and tuned cache in both packages."""
    def reset():
        Engine.reset()
        JEngine.reset()
        config.reset_config()
        jconfig.reset_config()
    reset()
    yield
    reset()


def test_engine_matches_reference(fresh):
    for eng in (Engine, JEngine):
        assert not eng.is_initialized() and eng.seed() == 1
        eng.init(seed=7)
        assert eng.is_initialized() and eng.seed() == 7
        assert eng.workload() is None
    assert Engine.core_number() == 1 and Engine.node_number() == 1
    for wl in (None, "ptb_lstm", "wide_deep", "unknown"):
        assert Engine.steps_per_dispatch(wl, backend="cpu") \
            == JEngine.steps_per_dispatch(wl), wl
    Engine.set_workload("ptb_lstm")
    JEngine.set_workload("ptb_lstm")
    assert Engine.workload() == "ptb_lstm"
    assert Engine.steps_per_dispatch(backend="cpu") \
        == JEngine.steps_per_dispatch() == 16
    # no tuned entry exists for the card: the dataclass default
    assert Engine.steps_per_dispatch(backend="cuda") == 1
    Engine.set_steps_per_dispatch(3)
    JEngine.set_steps_per_dispatch(3)
    assert Engine.steps_per_dispatch(backend="cpu") \
        == JEngine.steps_per_dispatch() == 3
    with pytest.raises(ValueError):
        Engine.set_steps_per_dispatch(0)
    want = JEngine.serving_defaults()
    for k, v in Engine.serving_defaults().items():
        assert v == want[k], k
    Engine.reset()
    assert Engine.workload() is None and Engine.steps_per_dispatch() == 1


NEW_FIELDS = ("activation_memory", "debug_nans")


def test_config_fields_match_reference(fresh, monkeypatch):
    port, ref = config.Config(), jconfig.Config()
    for f in NEW_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    monkeypatch.setenv("BIGDL_TPU_ACTIVATION_MEMORY", "dots")
    cfg = config.get_config()
    assert cfg.activation_memory == "dots"
    assert cfg.source("activation_memory") == "env"
    assert cfg.source("grad_wire_dtype") == "default"
    config.configure(grad_wire_dtype="bf16")
    assert cfg.source("grad_wire_dtype") == "explicit"
    with pytest.raises(AttributeError):
        config.configure(_sources={})
    # a field comes with the code that reads it
    for f in ("prefetch_batches", "loader_workers", "compute_dtype", "matmul_precision", "log_every_n_iterations",
              "summary_flush_secs"):
        assert hasattr(ref, f) and not hasattr(port, f), f
        with pytest.raises(AttributeError):
            config.configure(**{f: getattr(ref, f)})
    config.configure(debug_nans=True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        config.configure(debug_nans=False)
    assert not torch.is_anomaly_enabled()


@pytest.mark.parametrize("knob", ["steps_per_dispatch", "activation_memory",
                                  "grad_wire_dtype", "serving_max_batch_size"])
@pytest.mark.parametrize("workload", [None, "ptb_lstm", "wide_deep", "nope"])
def test_tuned_resolve_default_matches_reference(fresh, knob, workload):
    assert tuned.resolve_default(knob, workload, backend="cpu") \
        == jtuned.resolve_default(knob, workload, backend="cpu")
    assert tuned.validate_document.__doc__  # the port's own copy
    assert tuned.load() == jtuned.load()


def test_tuned_chain_in_the_optimizer(fresh, monkeypatch):
    """A CPU run tagged ``ptb_lstm`` takes the file's K=16 and policy
    "none"; an explicit setter, then the environment, win over it."""
    opt = optim.LocalOptimizer(_net("off"), DataSet.array(_samples())
                               >> SampleToMiniBatch(6),
                               nn.ClassNLLCriterion(), device="cpu")
    assert opt._steps_per_block("cpu") == 1
    opt.set_workload("ptb_lstm")
    assert opt._steps_per_block("cpu") == 16
    assert opt._steps_per_block("cuda") == 1
    assert opt._resolved_activation_memory("cpu") == "none"
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_DISPATCH", "5")
    config.reset_config()
    assert opt._steps_per_block("cpu") == 5
    opt.set_steps_per_dispatch(2)
    assert opt._steps_per_block("cpu") == 2
    monkeypatch.setenv("BIGDL_TPU_ACTIVATION_MEMORY", "sideways")
    config.reset_config()
    with pytest.raises(ValueError, match="from env"):
        opt._resolved_activation_memory("cpu")

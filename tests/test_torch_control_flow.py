"""The control-flow modules and ``DynamicGraph`` of the port on the CPU,
against the reference (``nn/control_flow.py``, ``nn/graph.py``).

- The reference's own contract (``tests/test_control_flow.py``): an
  unbounded ``While`` equals the Python loop; a bounded one stops at its
  exit; a module predicate; a loop graph built through the ``nn`` API
  trains (``DynamicGraph`` of a ``While`` over a ``Linear``, Adam, the
  loss halves); iterations after the exit are skipped, so a body that
  multiplies by 50 each trip gives the gradient 50^3 after 3 live trips of
  60; Dropout inside the body; ``Cond`` picks the branch and only the
  taken one gets gradients; a Switch/Merge graph selects per its
  predicate.
- Forward and gradients against the reference through carried weights
  (``to_jax_params``, the reference's tree: ``body``, ``cond``, ``true``,
  ``false``, ``pred``): a ``DynamicGraph`` with a bounded ``While``, a
  ``Cond`` and a Switch/Merge pair, within ``rtol=1e-5, atol=1e-6``.
- A loop trained through ``max_trip_count`` whose body diverges after the
  exit (its output times ``exp(1000 * relu(i - 3.5))``, inf from the first
  dead trip on): every step's gradients finite and the loss falling; the
  planted fault, the same loop run to ``max_trip_count`` with its dead
  trips masked by a select, gives non-finite gradients.
- A ``.bigdl`` file whose graph is named ``DynamicGraph`` loads as one.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import (DataSet, Sample,  # noqa: E402
                                     SampleToMiniBatch)
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402

CLOSE = dict(rtol=1e-5, atol=1e-6)


def t(v, dtype=torch.float32):
    return torch.tensor(v, dtype=dtype)


# ----------------------------------------------- the reference's contract
def test_unbounded_while_matches_python():
    w = nn.While(lambda c: c[0] < 5,
                 nn.Lambda(lambda c: (c[0] + 1, 2.0 * c[1] + 1.0)))
    i, x = w((torch.tensor(0), t(1.0)))
    want = 1.0
    for _ in range(5):
        want = 2 * want + 1
    assert float(x) == want and int(i) == 5 and w.trips == 5


def test_bounded_while_stops_at_exit_and_at_the_bound():
    body = nn.Lambda(lambda c: (c[0] + 1, c[1] * 2.0))
    i, x = nn.While(lambda c: c[0] < 3, body, max_trip_count=10)(
        (torch.tensor(0), t(1.0)))
    assert int(i) == 3 and float(x) == 8.0
    w = nn.While(lambda c: c[0] < 30, body, max_trip_count=4)
    i, x = w((torch.tensor(0), t(1.0)))
    assert int(i) == 4 and float(x) == 16.0 and w.trips == 4


def test_module_predicate():
    w = nn.While(nn.Lambda(lambda c: c[0] < 2),
                 nn.Lambda(lambda c: (c[0] + 1, c[1] + 10.0)))
    assert float(w((torch.tensor(0), t(0.0)))[1]) == 20.0


class Step(nn.Module):
    """``(i, h) -> (i + 1, tanh(lin(h)) * grow(i))``; ``grow`` is 1 unless
    ``diverge``: then ``exp(1000 * relu(i - 3.5))``, inf from i = 4 on."""

    def __init__(self, width=6, diverge=False):
        super().__init__("Step")
        self.lin = nn.Linear(width, width)
        self.diverge = diverge

    def forward(self, c):
        i, h = c
        y = torch.tanh(self.lin(h))
        if self.diverge:
            y = y * torch.exp(1000.0 * torch.relu(i.float() - 3.5))
        return i + 1, y


def loop_graph(steps=4, max_trip=8, diverge=False, width=6):
    inp = nn.Input()
    carry = nn.Lambda(lambda x: (torch.zeros((), dtype=torch.long), x))(inp)
    looped = nn.While(lambda c: c[0] < steps, Step(width, diverge),
                      max_trip_count=max_trip)(carry)
    head = nn.Linear(width, 2)(nn.Lambda(lambda c: c[1])(looped))
    return nn.DynamicGraph([inp], [nn.LogSoftMax()(head)])


def blobs(n=64, width=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, width)).astype(np.float32)
    return x, (x.sum(1) > 0).astype(np.int64)


def train(model, steps, lr=0.01):
    x, y = blobs()
    losses = []

    class Recording(optim.LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    (Recording(model, DataSet.array([Sample(a, b) for a, b in zip(x, y)])
               >> SampleToMiniBatch(64), nn.ClassNLLCriterion(),
               device="cpu")
     .set_optim_method(optim.Adam(learning_rate=lr))
     .set_end_when(optim.max_iteration(steps)).optimize())
    return losses


def test_loop_graph_trains():
    losses = train(loop_graph().initialize(0), 80)
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_dead_iterations_are_skipped_not_masked():
    w = nn.While(lambda c: c[0] < 3,
                 nn.Lambda(lambda c: (c[0] + 1, c[1] * 50.0)),
                 max_trip_count=60)
    x = t(1.0).requires_grad_(True)
    w((torch.tensor(0), x))[1].backward()
    assert float(x.grad) == 50.0 ** 3


def test_dropout_inside_the_body():
    drop = nn.Dropout(0.5)
    drop.generator = torch.Generator().manual_seed(0)
    w = nn.While(lambda c: c[0] < 2,
                 nn.Lambda(lambda c: (c[0] + 1, drop(c[1]))),
                 max_trip_count=4).train()
    assert w((torch.tensor(0), torch.ones(8)))[1].shape == (8,)


def test_cond_selects_and_trains_the_taken_branch():
    c = nn.Cond(lambda x: x.sum() > 0, nn.Lambda(lambda x: x * 2.0),
                nn.Lambda(lambda x: x - 1.0))
    assert c(t([1.0, 2.0])).tolist() == [2.0, 4.0]
    assert c(t([-1.0, -2.0])).tolist() == [-2.0, -3.0]
    model = nn.Cond(lambda x: x.mean() > 0, nn.Linear(4, 3),
                    nn.Linear(4, 3)).initialize(0)
    for p in model.parameters():
        p.requires_grad_(True)
    (model(torch.ones(4)) ** 2).sum().backward()
    assert float(model.true.weight.grad.abs().sum()) > 0
    assert model.false.weight.grad is None


def switch_merge_graph():
    data, pred = nn.Input(), nn.Input()
    ports = nn.Switch()((data, pred))
    f_br = nn.Lambda(lambda p: p[0] * 0.1)(ports)
    t_br = nn.Lambda(lambda p: p[1])(ports)
    return nn.DynamicGraph([data, pred], [nn.Merge()((f_br, t_br, pred))])


def test_switch_merge_piecewise_graph():
    g = switch_merge_graph()
    x = t([-2.0, 3.0])
    assert g((x, torch.tensor(True))).tolist() == [-2.0, 3.0]
    np.testing.assert_allclose(g((x, torch.tensor(False))).numpy(),
                               [-0.2, 0.3], rtol=1e-6)


# ------------------------------------------------ against the reference
class JStep(jnn.Module):
    """The reference's twin of :class:`Step` (its test's body)."""

    def __init__(self, width=6):
        super().__init__("Step")
        self.lin = jnn.Linear(width, width)

    def init(self, r):
        p, s = self.lin.init(r)
        return {"lin": p}, {"lin": s}

    def apply(self, params, state, c, *, training=False, rng=None):
        i, h = c
        y, _ = self.lin.apply(params["lin"], state["lin"], h)
        return (i + 1, jnp.tanh(y)), state


def jloop_graph(steps=4, max_trip=8, width=6):
    inp = jnn.Input()
    carry = jnn.Lambda(lambda x: (jnp.zeros((), jnp.int32), x))(inp)
    looped = jnn.While(lambda c: c[0] < steps, JStep(width),
                       max_trip_count=max_trip)(carry)
    head = jnn.Linear(width, 2)(jnn.Lambda(lambda c: c[1])(looped))
    return jnn.DynamicGraph([inp], [jnn.LogSoftMax()(head)])


def _against_reference(port, ref, xs, cot_seed=5):
    """Max errors of the port's forward and gradients (inputs and
    weights) against the reference's through the port's weights."""
    params, state = to_jax_params(port)
    jx = tuple(jnp.asarray(x) for x in xs)

    def out_of(p, *a):
        return ref.apply(p, state, a[0] if len(a) == 1 else a)[0]

    want = out_of(params, *jx)
    cot = np.random.default_rng(cot_seed).normal(
        size=np.shape(want)).astype(np.float32)
    floats = [i for i, x in enumerate(xs) if x.dtype == np.float32]

    def loss(p, *f):
        a = list(jx)
        for i, v in zip(floats, f):
            a[i] = v
        return jnp.sum(out_of(p, *a) * cot)

    grads = jax.grad(loss, argnums=tuple(range(len(floats) + 1)))(
        params, *[jx[i] for i in floats])
    for p in port.parameters():
        p.requires_grad_(True)
    tx = [torch.from_numpy(x).requires_grad_(x.dtype == np.float32)
          for x in xs]
    out = port(tx[0] if len(tx) == 1 else tuple(tx))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **CLOSE)
    for i, g in zip(floats, grads[1:]):
        np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(g),
                                   **CLOSE)
    got = to_jax_params(_grads_as_weights(port))[0]
    for path, w in _leaves(jax.tree_util.tree_map(np.asarray, grads[0])):
        np.testing.assert_allclose(_at(got, path), w, **CLOSE,
                                   err_msg=str(path))


def _grads_as_weights(port):
    import copy
    twin = copy.deepcopy(port)
    with torch.no_grad():
        for (_, p), (_, q) in zip(port.named_parameters(),
                                  twin.named_parameters()):
            # a branch that did not run has no gradient: the reference's 0
            q.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return twin


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_loop_graph_matches_reference():
    x, _ = blobs(16)
    _against_reference(loop_graph().initialize(3), jloop_graph(), (x,))


def test_cond_matches_reference():
    for sign in (1.0, -1.0):
        port = nn.Cond(lambda x: x.mean() > 0, nn.Linear(4, 3),
                       nn.Sequential(nn.Linear(4, 3), nn.Tanh()))
        ref = jnn.Cond(lambda x: jnp.mean(x) > 0, jnn.Linear(4, 3),
                       jnn.Sequential(jnn.Linear(4, 3), jnn.Tanh()))
        x = np.abs(blobs(5, 4)[0]) * sign
        _against_reference(port.initialize(1), ref, (x,))


def test_switch_merge_matches_reference():
    data, pred = jnn.Input(), jnn.Input()
    ports = jnn.Switch()((data, pred))
    merged = jnn.Merge()((jnn.Lambda(lambda p: p[0] * 0.1)(ports),
                          jnn.Lambda(lambda p: p[1])(ports), pred))
    ref = jnn.DynamicGraph([data, pred], [merged])
    for p in (True, False):
        _against_reference(switch_merge_graph(), ref,
                           (blobs(3, 4)[0], np.array(p)))


# ---------------------------------- a Cond trained through the optimizer
def cond_graph(mod):
    """A ``DynamicGraph`` whose ``Cond`` picks one of two ``Linear``s by
    the sign of the batch's mean: each step trains one branch, and the
    other gets the reference's zero gradient."""
    inp = mod.Input()
    picked = mod.Cond(lambda x: x.mean() > 0, mod.Linear(6, 2),
                      mod.Linear(6, 2))(inp)
    return mod.DynamicGraph([inp], [mod.LogSoftMax()(picked)])


COND_STEPS = 8


def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _cond_data(S):
    x, y = blobs(64, seed=2)
    return [S(a, b) for a, b in zip(x, y)]


@pytest.fixture(scope="module")
def cond_reference():
    """The reference's Adam run of :func:`cond_graph` from the port's
    weights: (start weights, losses, final weights)."""
    from bigdl_tpu import optim as joptim
    from bigdl_tpu.dataset import DataSet as JDataSet
    from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch
    from bigdl_tpu.dataset.sample import Sample as JSample
    start = to_jax_params(cond_graph(nn).initialize(4))
    ref = cond_graph(jnn)
    ref._params = jax.tree_util.tree_map(jnp.asarray, start[0])
    ref._state = start[1]
    opt = (_recording(joptim.LocalOptimizer)(
        ref, JDataSet.array(_cond_data(JSample), seed=3)
        >> JSampleToMiniBatch(16), jnn.ClassNLLCriterion())
        .set_optim_method(joptim.Adam(learning_rate=0.05))
        .set_end_when(joptim.max_iteration(COND_STEPS)))
    opt.optimize()
    return start, opt.losses, jax.tree_util.tree_map(np.asarray,
                                                      ref._params)


@pytest.mark.parametrize("guard", ["off", "skip"])
def test_cond_graph_trains_through_local_optimizer_as_reference(
        cond_reference, guard):
    """Both branches are taken on some steps and left on others; the
    losses within ``rtol=1e-5`` and the final weights within ``1e-5`` of
    the reference's (f32 on both sides over 8 Adam steps)."""
    start, want_losses, want = cond_reference
    model = cond_graph(nn).initialize(4)
    opt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(_cond_data(Sample), seed=3)
        >> SampleToMiniBatch(16), nn.ClassNLLCriterion(), device="cpu")
        .set_optim_method(optim.Adam(learning_rate=0.05))
        .set_numeric_guard(guard)
        .set_end_when(optim.max_iteration(COND_STEPS)))
    opt.optimize()
    np.testing.assert_allclose(opt.losses, want_losses, rtol=1e-5)
    got = to_jax_params(model)[0]
    for path, w in _leaves(want):
        np.testing.assert_allclose(_at(got, path), w, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))
    # each branch trained: its weights left their start
    for path, w in _leaves(start[0]):
        assert not np.array_equal(_at(got, path), w), path


# ------------------------------- training through a diverging dead body
def _step_grads(model, x, y):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    nn.ClassNLLCriterion().apply(model(torch.from_numpy(x)),
                                 torch.from_numpy(y)).backward()
    return [p.grad for p in model.parameters()]


class MaskedWhile(nn.While):
    """The planted fault: every trip up to ``max_trip_count`` runs, the
    dead ones' results masked out by a select."""

    def forward(self, x):
        for _ in range(self.max_trip_count):
            live = self.cond(x)
            out = self.body(x)
            x = tuple(torch.where(live, o, c) for o, c in zip(out, x))
        return x


def test_trained_loop_with_a_diverging_dead_body_has_finite_gradients():
    model = loop_graph(diverge=True).initialize(0)
    x, y = blobs()
    assert all(bool(torch.isfinite(g).all())
               for g in _step_grads(model, x, y))
    losses = train(model, 40)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    w = next(m for m in model.modules() if isinstance(m, nn.While))
    assert w.trips == 4
    # the planted fault: masking the dead trips puts NaN into gradients
    masked = loop_graph(diverge=True).initialize(0)
    w = next(m for m in masked.modules() if isinstance(m, nn.While))
    w.__class__ = MaskedWhile
    out = masked(torch.from_numpy(x))
    assert bool(torch.isfinite(out).all())  # the forward alone looks sound
    assert not all(bool(torch.isfinite(g).all())
                   for g in _step_grads(masked, x, y))


def test_bigdl_file_naming_dynamic_graph_loads_as_one(tmp_path):
    """The writer names a graph ``StaticGraph`` (as the reference's does);
    the same file with its root renamed ``DynamicGraph`` loads as one,
    weights and all."""
    from bigdl_tpu_torch.interop import bigdl_format as B
    from bigdl_tpu_torch.utils import protowire as pw
    inp = nn.Input()
    plain = nn.Graph([inp], [nn.ReLU()(nn.Linear(3, 2)(inp))]).initialize(0)
    path = tmp_path / "g.bigdl"
    B.save_bigdl_module(plain, str(path))
    static, dynamic = (pw.enc_str(7, B._NN + name)
                       for name in ("StaticGraph", "DynamicGraph"))
    data = path.read_bytes()
    assert data.count(static) == 1
    path.write_bytes(data.replace(static, dynamic))
    m = B.load_bigdl_module(str(path))
    assert type(m) is nn.DynamicGraph
    x = torch.ones(2, 3)
    torch.testing.assert_close(m(x), plain(x), rtol=0, atol=0)
    assert type(B.load_bigdl_module(str(tmp_path / "g.bigdl"))) \
        is nn.DynamicGraph

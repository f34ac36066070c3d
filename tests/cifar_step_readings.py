"""The step readings behind ``test_torch_cifar.STEP_LIMIT``, at more seeds.

``tests/test_torch_cifar.py`` holds VGG's training a step at a time: the
reference redoes each of the port's steps from the port's own state, and
the reading is ||w_port - w_ref|| / ||w_port - w_before||.  The tests run
one weight/data seed each; this script takes the same readings at several,
on the CPU, and prints the largest of each run:

- ``local``: the K=4 ``LocalOptimizer`` block (8 steps, batch 8) at six
  weight/data seeds and 1, 4 and 8 torch threads, with the two planted
  faults' smaller reading (the recipe's dampening dropped; nesterov on);
- ``world2``: the spawned world-2 gloo ``DistriOptimizer`` (3 steps,
  global batch 8; the workers run one thread each) at 18 weight/data
  seeds.

Run from the repository root (about 10 and 7 minutes)::

    python tests/cifar_step_readings.py local
    python tests/cifar_step_readings.py world2
"""

import os
import sys
import tempfile

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_cifar as T  # noqa: E402
from bigdl_tpu_torch import optim  # noqa: E402
from bigdl_tpu_torch.dataset import cifar  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.interop.jax_weights import jax_tree  # noqa: E402
from bigdl_tpu_torch.models import vgg_for_cifar10  # noqa: E402

W = T.W
LOCAL_SEEDS = [(1, 0), (2, 0), (3, 1), (4, 2), (7, 3), (11, 5)]
WORLD2_SEEDS = [(i, d) for i in (6, 0, 1, 2, 3, 4) for d in (0, 1, 2)]


def _jax_step(mean_over_devices):
    jm = T._no_dropout(T.jax_vgg(10))
    jsgd = T._jsgd()

    def loss_fn(p, state, x, y):
        o, _ = jm.apply(p, state, x, training=True,
                        rng=jax.random.PRNGKey(0))
        return T.jnn.ClassNLLCriterion().apply(o, y)

    @jax.jit
    def jstep(params, state, vel, x, y, lr, step):
        if mean_over_devices:
            losses, gs = jax.vmap(jax.value_and_grad(loss_fn),
                                  in_axes=(None, None, 0, 0))(
                params, state, x, y)
            loss = losses.mean()
            g = jax.tree_util.tree_map(lambda a: a.mean(0), gs)
        else:
            loss, g = jax.value_and_grad(loss_fn)(params, state, x, y)
        new, _ = jsgd.update(g, params, {"velocity": vel}, lr, step)
        return loss, new
    return jstep


def _redo(net, jstep, p, buf, v, x, y, lr, step):
    def tree(d, kind="params"):
        return jax_tree(net, d, kind)
    jloss, new = jstep(tree(p), tree(buf, "state"), tree(v), x, y, lr, step)
    return float(jloss), T._flat(jax.tree_util.tree_map(np.asarray, new))


def local_readings(init_seed, data_seed):
    """(largest loss rel, largest sound share, smaller fault's largest)."""
    start = to_jax_params(vgg_for_cifar10(10).initialize(init_seed))
    samples = cifar.to_samples(*cifar.synthetic_cifar(32, seed=data_seed))
    jstep = _jax_step(False)

    def readings(sgd):
        opt, _ = T._vgg_trace(sgd, start, samples)
        out = []
        for (p, b, v), x, y, lr, step, loss, after in opt.trace:
            jloss, new = _redo(opt._run.net, jstep, p, b, v, x, y, lr, step)
            out.append((abs(loss - jloss) / jloss,
                        T._update_share(after, new, p)))
        return out

    def sgd(**kw):
        return optim.SGD(0.01, momentum=0.9, weight_decay=5e-4,
                         learning_rate_schedule=optim.EpochStep(25, 0.5),
                         **kw)
    sound = readings(W.vgg_sgd())
    fault = min(max(b for _, b in readings(f))
                for f in (sgd(), sgd(dampening=0.0, nesterov=True)))
    return (max(a for a, _ in sound), max(b for _, b in sound), fault)


def world2_readings(init_seed, data_seed):
    """(each step's share, largest loss rel) of a world-2 run."""
    start = to_jax_params(vgg_for_cifar10(10).initialize(init_seed))
    with tempfile.TemporaryDirectory() as tmp:
        rank0, rank1 = W.run_world(2, tmp, start[0],
                                   {"vgg": {"data_seed": data_seed}},
                                   fn=W.train_vgg)
    jstep = _jax_step(True)
    net = vgg_for_cifar10(10)
    shares, losses = [], []
    for a, b in zip(rank0["vgg"]["trace"], rank1["vgg"]["trace"]):
        (p, buf, v), x, y, lr, step, loss, after = a
        jloss, new = _redo(net, jstep, p, buf, v, np.stack([x, b[1]]),
                           np.stack([y, b[2]]), lr, step)
        losses.append(abs(loss - jloss) / jloss)
        shares.append(T._update_share(after, new, p))
    return shares, max(losses)


def main(mode):
    if mode == "local":
        for init_seed, data_seed in LOCAL_SEEDS:
            for threads in (1, 4, 8):
                torch.set_num_threads(threads)
                loss, share, fault = local_readings(init_seed, data_seed)
                print(f"local weights {init_seed} data {data_seed} threads "
                      f"{threads}: loss rel {loss:.2e}, share {share:.4f}, "
                      f"faults from {fault:.3f}", flush=True)
    elif mode == "world2":
        for init_seed, data_seed in WORLD2_SEEDS:
            shares, loss = world2_readings(init_seed, data_seed)
            print(f"world2 weights {init_seed} data {data_seed}: shares "
                  + ", ".join(f"{s:.4f}" for s in shares)
                  + f", loss rel {loss:.2e}", flush=True)
    else:
        raise SystemExit("mode: local or world2")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "local")

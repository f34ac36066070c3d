"""One process of a gloo world for ``tests/test_torch_distri.py``: trains the
small MLP on synthetic MNIST through the port's ``DistriOptimizer`` on the
CPU in several configurations and pickles what each run ends with.

Rank r of a world of P gets, from its ``DistributedDataSet``, the rows the
reference's P-device mesh gives device r: in global batch j of G rows,
rows r*G/P to (r+1)*G/P (:func:`mesh_order`).  Imports neither JAX nor the
reference package.

Also the spawn helper of the tests: :func:`run_world` starts P processes
with ``torch.multiprocessing.spawn`` over a ``FileStore`` in a directory of
the caller's, so no TCP port is taken.
"""

import contextlib
import os
import pickle
import struct
import warnings

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import (DistributedDataSet, SampleToMiniBatch,
                                     Transformer)
from bigdl_tpu_torch.dataset import image, mnist
from bigdl_tpu_torch.interop import load_jax_params
from bigdl_tpu_torch.optim import validation
from bigdl_tpu_torch.parallel import grad_sync
from bigdl_tpu_torch.utils.summary import TrainSummary, ValidationSummary

N_SAMPLES, GLOBAL_BATCH, ITERS = 512, 64, 6
BUCKET_BYTES = 1 << 16  # three buckets: [1.bias], [1.weight], [3.*]


def small_mlp():
    return (nn.Sequential()
            .add(nn.Reshape((784,)))
            .add(nn.Linear(784, 64)).add(nn.ReLU())
            .add(nn.Linear(64, 10)).add(nn.LogSoftMax()))


def mesh_order(samples, global_batch, world):
    """``samples`` reordered so that shard p::world of the result is, in
    order, the rows device p gets of each global batch."""
    local = global_batch // world
    out = [None] * len(samples)
    for g, s in enumerate(samples):
        j, r = divmod(g, global_batch)
        c, i = divmod(r, local)
        out[(j * local + i) * world + c] = s
    return out


class PoisonBatch(Transformer):
    """NaN inputs in batch ``at`` (0-based) of this process."""

    def __init__(self, at):
        self.at = at

    def __call__(self, it):
        for i, b in enumerate(it):
            if i == self.at:
                b.input[...] = np.nan
            yield b


def pipeline(world, rank, poison_at=None):
    imgs, labels = mnist.synthetic_mnist(N_SAMPLES, seed=0)
    samples = mesh_order(mnist.to_samples(imgs, labels), GLOBAL_BATCH,
                         world)
    ds = (DistributedDataSet(samples, process_index=rank,
                             process_count=world)
          >> image.BytesToGreyImg()
          >> image.GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
          >> SampleToMiniBatch(GLOBAL_BATCH // world))
    if poison_at is not None:
        ds = ds >> PoisonBatch(poison_at)
    return ds


@contextlib.contextmanager
def planted_fault(kind):
    """A deliberately broken wire for the checks to fail on: ``"no_update"``
    (the reduce-scatter delivers zeros, so the weights never move),
    ``"stale_gather"`` (the all-gather keeps publishing its first
    parameters) or ``"nearest"`` (round-to-nearest in place of the
    unbiased round); None: the sound wire."""
    saved = {name: getattr(grad_sync, name) for name in (
        "reduce_scatter_grads", "all_gather_params", "stochastic_round")}
    if kind == "no_update":
        grad_sync.reduce_scatter_grads = lambda *a, **k: [
            torch.zeros_like(o)
            for o in saved["reduce_scatter_grads"](*a, **k)]
    elif kind == "stale_gather":
        first = []

        def stale(*a, **k):
            new = saved["all_gather_params"](*a, **k)
            first.extend(p.clone() for p in new[len(first):])
            return [p.clone() for p in first]
        grad_sync.all_gather_params = stale
    elif kind == "nearest":
        grad_sync.stochastic_round = lambda x, dtype, gen=None: x.to(dtype)
    elif kind is not None:
        raise ValueError(f"unknown planted fault {kind!r}")
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(grad_sync, name, fn)


def wire_drift(params, ref, start):
    """How far a run's weights strayed from the f32 wire's, per leaf:
    ``||w - w_f32|| / ||w_f32 - w_0||``, the worst leaf's."""
    return max(float(np.linalg.norm(params[k] - ref[k])
                     / np.linalg.norm(ref[k] - start[k])) for k in ref)


def bf16_neighbours(published, master):
    """Whether every published weight is one of the two bf16 values around
    its f32 master: what the unbiased round of the all-gather may give."""
    bits = np.asarray(master, np.float32).view(np.uint32) & 0xFFFF0000
    down, up = bits.view(np.float32), (bits + 0x10000).view(np.float32)
    return bool(np.all((published == down) | (published == up)))


def _fields(buf):
    """(field number, value) pairs of one protobuf message: varints as
    ints, length-delimited fields as bytes, fixed widths skipped."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        else:
            value, pos = None, pos + (8 if wire == 1 else 4)
        out.append((field, value))
    return out


def _varint(buf, pos):
    value, shift = 0, 0
    while True:
        b = buf[pos]
        value |= (b & 0x7F) << shift
        shift += 7
        pos += 1
        if not b & 0x80:
            return value, pos


def summary_records(path):
    """What an event file holds, record by record: ``"version"`` for a
    file-version record, else ``(tag, step)``."""
    blob = open(path, "rb").read()
    out, pos = [], 0
    while pos < len(blob):
        (n,) = struct.unpack("<Q", blob[pos:pos + 8])
        event = dict(_fields(blob[pos + 12:pos + 12 + n]))
        pos += 16 + n
        if 3 in event:  # file_version
            out.append("version")
            continue
        value = dict(_fields(dict(_fields(event[5]))[1]))
        out.append((value[1].decode(), event.get(2, 0)))
    return out


def train(world, rank, start, *, iters=ITERS, k=1, lr=0.05, momentum=0.9,
          clip=None, ckpt=None, resume=None, guard=None, poison_at=None,
          fault=None, summary=None, **kw):
    """One run from the parameters ``start`` (the reference's layout):
    what it ends with, as numpy.  ``fault`` plants a broken wire
    (:func:`planted_fault`).  ``summary``: a directory that every rank
    hands the same train and validation summaries (app ``"w"``), with
    "Parameters" histograms and a validation every 3 iterations."""
    model = small_mlp()
    load_jax_params(model, start)
    init = {k: v.detach().numpy().copy() for k, v in model.named_parameters()}
    losses = []

    class Recording(optim.DistriOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    opt = (Recording(model, pipeline(world, rank, poison_at),
                     nn.ClassNLLCriterion(), device="cpu",
                     grad_bucket_bytes=BUCKET_BYTES, **kw)
           .set_optim_method(optim.SGD(learning_rate=lr, momentum=momentum))
           .set_seed(5).set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(iters)))
    if clip == "norm":
        opt.set_gradient_clipping_by_l2_norm(0.5)
    elif clip == "value":
        opt.set_gradient_clipping_by_value(-3e-3, 3e-3)
    if guard is not None:
        opt.set_numeric_guard(guard)
    if ckpt is not None:
        opt.set_checkpoint(ckpt, optim.several_iteration(2))
    if resume is not None:
        assert opt.resume(resume)
    if summary is not None:
        ts = TrainSummary(summary, "w").set_summary_trigger(
            "Parameters", optim.several_iteration(3))
        vs = ValidationSummary(summary, "w")
        (opt.set_train_summary(ts).set_val_summary(vs)
         .set_validation(optim.several_iteration(3), pipeline(world, rank),
                         [validation.Top1Accuracy()]))
    start_neval = opt.state["neval"]
    with planted_fault(fault):
        opt.optimize()
    if summary is not None:
        ts.close()
        vs.close()
    out = {"losses": losses, "start_neval": start_neval, "init": init,
           "state": {k: opt.state[k] for k in
                     ("neval", "epoch", "records_processed_this_epoch")},
           "params": {k: v.detach().numpy().copy()
                      for k, v in model.named_parameters()},
           "dispatches": opt._dispatch_count,
           "skipped": opt.registry.counter(
               "resilience/steps_skipped").value}
    if opt._use_grad_sync:
        plan = opt._gs_plan
        out["plan"] = {"paths": plan.paths, "buckets": plan.buckets,
                       "sizes": plan.bucket_sizes}
        out["masters"] = [m.numpy().copy()
                          for m in opt._final_opt_state["master"]]
        out["flat_params"] = [b.numpy() for b in grad_sync.flatten_to_buckets(
            plan, [dict(model.named_parameters())[n].detach()
                   for n in opt._gs_names])]
        out["master_dtypes"] = [str(m.dtype)
                                for m in opt._final_opt_state["master"]]
        full = grad_sync.gather_state(plan, opt._final_opt_state)["master"]
        out["full_masters"] = [m.numpy() for m in full]
        out["master_params"] = {
            n: v.numpy() for n, v in zip(
                opt._gs_names, grad_sync.unflatten_from_buckets(plan, full))}
    return out


def cifar_pipeline(pkg, D, samples, batch):
    """Normalised CHW CIFAR batches of ``samples`` in a dataset made by
    ``D``; ``pkg`` is a package's ``(image, cifar, SampleToMiniBatch)``."""
    image_, cifar, S2B = pkg
    return (D(samples) >> image_.BGRImgNormalizer(cifar.TRAIN_MEAN,
                                                  cifar.TRAIN_STD)
            >> image_.ChannelOrder("CHW") >> S2B(batch))


def vgg_sgd():
    """The VGG recipe's SGD."""
    return optim.SGD(0.01, momentum=0.9, dampening=0.0, weight_decay=5e-4,
                     learning_rate_schedule=optim.EpochStep(25, 0.5))


class Tracing:
    """Mixin for an optimizer class: records every step of its blocks in
    ``self.trace``: the parameters, buffers and SGD velocity before it
    (full: a DistriOptimizer gathers its owned slices), its batch, rate,
    step and loss, and the parameters after it, as numpy."""

    def _train_driver(self, step_fn, device, run):
        self._run = run
        self.trace = []
        return super()._train_driver(step_fn, device, run)

    def _velocity(self):
        run = self._run
        if getattr(self, "_use_grad_sync", False):
            full = grad_sync.gather_state(self._gs_plan, run.ostate,
                                          self.mesh.group)
            return dict(zip(self._gs_names, grad_sync.unflatten_from_buckets(
                self._gs_plan, full["opt"]["velocity"])))
        return run.ostate["velocity"]

    def _block(self, step_fn, staged, lrs, first_step):
        def snap(named):
            return {k: v.detach().numpy().copy() for k, v in named.items()}

        def traced(x, y, lr, step):
            run = self._run
            before = (snap(run.params), snap(dict(run.net.named_buffers())),
                      snap(self._velocity()))
            loss = step_fn(x, y, lr, step)
            self.trace.append((before, x.numpy().copy(), y.numpy().copy(),
                               lr, step, float(loss), snap(run.params)))
            return loss
        return super()._block(traced, staged, lrs, first_step)


def train_vgg(world, rank, start, *, n=32, global_batch=8, iters=3,
              data_seed=0):
    """VGG for CIFAR-10 through the port's DistriOptimizer on synthetic
    CIFAR, the recipe's SGD, dropout off (its masks come from another
    generator than the reference's): every step's :class:`Tracing`
    record and the final parameters."""
    from bigdl_tpu_torch.dataset import cifar
    from bigdl_tpu_torch.models import vgg_for_cifar10
    model = vgg_for_cifar10(10)
    load_jax_params(model, start)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    imgs, labels = cifar.synthetic_cifar(n, seed=data_seed)
    samples = mesh_order(cifar.to_samples(imgs, labels), global_batch,
                         world)
    ds = cifar_pipeline(
        (image, cifar, SampleToMiniBatch),
        lambda s: DistributedDataSet(s, process_index=rank,
                                     process_count=world),
        samples, global_batch // world)
    opt = (type("TracingDistri", (Tracing, optim.DistriOptimizer), {})(
        model, ds, nn.ClassNLLCriterion(), device="cpu")
        .set_optim_method(vgg_sgd())
        .set_end_when(optim.max_iteration(iters)))
    opt.optimize()
    return {"trace": opt.trace,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.named_parameters()}}


def _worker(rank, world, store_dir, runs, fn=None):
    warnings.simplefilter("ignore", FutureWarning)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"),
                                     world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(store_dir, "start.pkl"), "rb") as f:
            start = pickle.load(f)
        results = {}
        for name, kw in runs.items():
            kw = dict(kw)
            if kw.pop("rank1_only_poison", False):
                kw["poison_at"] = kw["poison_at"] if rank == 1 else None
            results[name] = (fn or train)(world, rank, start, **kw)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_world(world, store_dir, start, runs, fn=None):
    """Run ``runs`` ({name: keywords}) of ``fn`` (:func:`train` by
    default; a function of this module) in a spawned gloo world of
    ``world`` processes; returns each rank's {name: result}."""
    with open(os.path.join(store_dir, "start.pkl"), "wb") as f:
        pickle.dump(start, f)
    torch.multiprocessing.spawn(_worker, args=(world, store_dir, runs, fn),
                                nprocs=world, join=True)
    out = []
    for r in range(world):
        with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

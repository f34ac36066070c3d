"""DistriOptimizer: synchronous data-parallel training over
``torch.distributed`` (port of ``bigdl_tpu/optim/distri_optimizer.py``).

One process drives one device; the processes form the mesh's ``data`` axis
(``parallel/mesh.py``).  Each reads its own shard of the data
(``DistributedDataSet``) in local batches of B, so the global batch is B x
world and ``_records_scale`` is the world size.  A step, on every process:
forward and backward on the local batch, then

- ``parameter_sharding=True`` (default): the bucketed ZeRO-1 protocol of
  ``parallel/grad_sync.py``, the reference's ``AllReduceParameter``: the
  gradient buckets reduce-scattered through the wire dtype
  (``grad_wire_dtype``: f32 | bf16 | f16), the optimizer on the f32
  master slices this process owns, the updated slices all-gathered back
  into the parameters;
- ``parameter_sharding=False``: an f32 all-reduce of g/n and the full
  update on every process (the baseline the f32 wire equals bitwise);

then one all-reduce averages the loss, BatchNorm's running statistics
(per-process statistics, as the reference's per-partition ones) and, under
a numeric guard, the finite flags: one process's non-finite step vetoes
the step on every process.

The backend follows the device: NCCL for CUDA, gloo for the CPU; a caller
may name ``backend="gloo"`` for CUDA tensors (two processes on one card:
gloo moves them through host memory itself).  A run of one process needs
no launcher (its group starts on a ``HashStore``); several start under
``torchrun`` or call ``torch.distributed.init_process_group`` first.

Summaries: process 0 alone writes them (the train scalars, the
"Parameters" histograms of the full parameters, the validation scores);
every process evaluates the triggers.  Snapshots: every process gathers
the grad_sync state's owned slices into full buckets, process 0 writes,
every process records the step.  The state
keeps the reference's layout ``{"master": [bucket, ...], "opt": {...}}``
with the reference's leaf order and padding, so a snapshot resumes across
packages at the same world size.  Tensor parallelism (``param_specs``) and
elastic resizing (``set_elastic``) are not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from bigdl_tpu_torch.checkpoint import build_schema
from bigdl_tpu_torch.checkpoint.schema import leaves_with_path
from bigdl_tpu_torch.engine import Engine, resolve_device
from bigdl_tpu_torch.interop.jax_weights import (is_grad_sync_state,
                                                 jax_tree)
from bigdl_tpu_torch.optim.optimizer import (Optimizer, _Run, step_finite,
                                             stream_seed)
from bigdl_tpu_torch.parallel import grad_sync
from bigdl_tpu_torch.parallel.mesh import Mesh
from bigdl_tpu_torch.resilience.numeric import NonFiniteStepError
from bigdl_tpu_torch.utils.config import get_config
from bigdl_tpu_torch.utils.tuned import resolve_default

logger = logging.getLogger("bigdl_tpu_torch.optim")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree.detach().cpu()


class DistriOptimizer(Optimizer):
    """Data-parallel trainer; see the module docstring."""

    def __init__(self, model, dataset, criterion, batch_size=None,
                 mesh: Optional[Mesh] = None,
                 parameter_sharding: bool = True,
                 param_specs=None,
                 grad_sync: Optional[bool] = None,
                 grad_wire_dtype: Optional[str] = None,
                 grad_bucket_bytes: Optional[int] = None,
                 device="cuda", backend: Optional[str] = None):
        """``parameter_sharding`` picks the path; ``grad_sync`` is the
        reference's name for the same choice, kept for its signature, and
        must agree with it when given.  ``grad_wire_dtype`` and
        ``grad_bucket_bytes`` override ``Config``'s.  ``batch_size`` is
        kept for the reference's signature: the dataset's
        ``SampleToMiniBatch`` sets the local batch."""
        super().__init__(model, dataset, criterion)
        if param_specs is not None:
            raise NotImplementedError(
                "param_specs (tensor parallelism) is not ported to "
                "bigdl_tpu_torch yet (ROADMAP queue A, slice 10)")
        if grad_sync is not None and bool(grad_sync) != parameter_sharding:
            raise ValueError(
                f"grad_sync={grad_sync!r} disagrees with parameter_sharding="
                f"{parameter_sharding!r}: the port has one path for each "
                f"value of parameter_sharding; set that alone")
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.backend = backend
        self.mesh = mesh
        self.parameter_sharding = parameter_sharding
        self.param_specs = param_specs
        self.grad_wire_dtype = grad_wire_dtype
        self.grad_bucket_bytes = grad_bucket_bytes
        self._use_grad_sync = False
        self._gs_plan: Optional[grad_sync.BucketPlan] = None
        self._gs_wire: Optional[torch.dtype] = None
        self._gs_names: list = []  # parameter names in the plan's order
        # ("Parameters/<reference leaf path>", parameter name) pairs
        self._param_tags: list = []
        self._world = 1
        self._rank = 0
        self._final_opt_state = None

    def set_elastic(self, *a, **kw):
        raise NotImplementedError(
            "elastic training (set_elastic) is not ported to "
            "bigdl_tpu_torch yet (ROADMAP queue A, slice 6: "
            "resilience/membership.py)")

    # ------------------------------------------------------------ set-up
    def _resolve_mesh(self) -> Mesh:
        """The mesh of this run, its group joined (or a world-1 group
        started) on the backend the device asks for."""
        want = self.backend or ("nccl" if self.device.type == "cuda"
                                else "gloo")
        if want == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend moves CUDA tensors; a CPU "
                             "run takes backend='gloo'")
        mesh = self.mesh or Engine.get_mesh(backend=want)
        if mesh.backend != want:
            raise ValueError(f"the mesh's group runs {mesh.backend!r}, "
                             f"this run asked for {want!r}")
        return mesh

    def _place(self) -> None:
        """One device a process: under NCCL, ``cuda`` means this process's
        local rank's card."""
        dev = self.device
        if dev.type == "cuda" and self.mesh.backend == "nccl":
            if dev.index is None:
                dev = torch.device(
                    "cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        self._run_device = dev

    def _resolve_grad_sync(self, params_tree) -> None:
        """Whether this run takes the bucketed path, and its plan:
        constructor > ``configure()``/env > the workload's tuned entry >
        default."""
        self._use_grad_sync = use = self.parameter_sharding
        if not use:
            self._gs_plan = None
            return
        wl, backend = self._workload_tag(), self._run_device.type
        wire = self.grad_wire_dtype if self.grad_wire_dtype is not None \
            else resolve_default("grad_wire_dtype", wl, backend)[0]
        bucket = self.grad_bucket_bytes \
            if self.grad_bucket_bytes is not None \
            else resolve_default("grad_bucket_bytes", wl, backend)[0]
        self._gs_wire = grad_sync.resolve_wire_dtype(wire)
        self._gs_plan = grad_sync.build_plan(params_tree, self._world,
                                             int(bucket))

    def _check_resumed_opt_state(self, ostate) -> None:
        """Refuse, loudly, a resumed optimizer state written by the other
        sync path, or by another bucket plan."""
        is_gs = is_grad_sync_state(ostate)
        if self._use_grad_sync and not is_gs:
            raise ValueError(
                "resumed opt_state is not grad_sync-format (expected "
                "{'master': [...], 'opt': ...}) — the checkpoint was "
                "written by a non-grad_sync run; resume with the "
                "matching setting (parameter_sharding=False) or clear the "
                "checkpoint dir")
        if not self._use_grad_sync and is_gs:
            raise ValueError(
                "resumed opt_state is grad_sync-format but this run has "
                "grad_sync disabled (parameter_sharding=False) — set it "
                "True or clear the checkpoint dir")
        if is_gs:
            want = [(s,) for s in self._gs_plan.bucket_sizes]
            got = [tuple(m.shape) for m in ostate["master"]]
            if want != got:
                raise ValueError(
                    f"resumed grad_sync masters {got} do not match this "
                    f"run's bucket plan {want} — world size or "
                    f"grad_bucket_bytes changed since the checkpoint was "
                    f"written")

    def _records_scale(self) -> int:
        return self._world

    def _checkpoint_schema(self, params_tree) -> dict:
        if not self._use_grad_sync:
            return super()._checkpoint_schema(params_tree)
        plan = self._gs_plan
        return build_schema(
            params_tree, grad_sync=True, bucket_sizes=plan.bucket_sizes,
            wire_dtype=grad_sync.wire_dtype_name(self._gs_wire),
            n_shard=plan.n_shard,
            optim_method=type(self.optim_method).__name__,
            bucket_content=grad_sync.bucket_content_sizes(plan))

    # ---------------------------------------------------- driver hooks
    def _trees(self, run: _Run):
        if not self._use_grad_sync:
            return super()._trees(run)
        net = run.net
        params = jax_tree(net, {k: p.detach() for k, p in run.params.items()},
                          "params")
        state = jax_tree(net, dict(net.named_buffers()), "state")
        full = grad_sync.gather_state(self._gs_plan, run.ostate,
                                      self.mesh.group)
        return params, state, _to_host(full)

    # replay-boundary: called at block edges, after the loss fetch
    def _do_checkpoint(self, run: _Run, sync: bool = False) -> None:
        trees = self._trees(run)  # a collective for grad_sync state
        if self._rank != 0:
            # every process records the step: the preemption branch's
            # already-saved test must agree on all of them
            self._checkpoint_manager().last_saved_step = \
                int(self.state["neval"])
            return
        self._save_trees(*trees, sync=sync)

    def _writes_summaries(self) -> bool:
        return self._rank == 0

    def _log_parameter_histograms(self, run: _Run) -> None:
        # the reference's trigger-gated "Parameters" summary; a block ends
        # at the step the trigger names, so run.params are that step's
        # full (all-gathered) parameters
        trig = getattr(self.train_summary, "trigger_for",
                       lambda _n: None)("Parameters")
        if trig is None or not trig(self.state) \
                or not self._writes_summaries():
            return
        for tag, name in self._param_tags:
            self.train_summary.add_histogram(tag, run.params[name],
                                             self.state["neval"])

    def _reduce_validation(self, sums: dict, counts: dict):
        if self._world == 1 or not sums:
            return sums, counts
        keys = sorted(sums)
        dev = sums[keys[0]].device
        flat = torch.stack([sums[k] for k in keys] + [
            torch.tensor(float(counts[k]), dtype=torch.float64, device=dev)
            for k in keys])
        grad_sync.all_reduce_sum_(flat, self.mesh.group)
        n = len(keys)
        return ({k: flat[i] for i, k in enumerate(keys)},
                {k: int(flat[n + i].item()) for i, k in enumerate(keys)})

    def _rollback_nonfinite(self, e, attempts, retry_budget) -> None:
        # process 0's writer idle before any process looks for the latest
        # snapshot
        if self.checkpoint_path:
            self._checkpoint_manager().wait()
            dist.barrier(group=self.mesh.group)
        super()._rollback_nonfinite(e, attempts, retry_budget)

    # ------------------------------------------------------------- train
    # replay-boundary: restores happen only between _optimize_impl runs
    def optimize(self) -> torch.nn.Module:
        attempts = 0
        while True:
            try:
                return self._optimize_impl()
            except NonFiniteStepError as e:
                attempts += 1
                self._rollback_nonfinite(e, attempts,
                                         get_config().failure_retry_times)
            except Exception:
                # the reference's retry-from-checkpoint loop
                # (DistriOptimizer.scala:981-1061): the latest VALID
                # snapshot's whole state, then run again
                attempts += 1
                if attempts > get_config().failure_retry_times \
                        or not self.checkpoint_path:
                    raise
                mgr = self._checkpoint_manager()
                mgr.wait()
                ckpt = mgr.latest_valid()
                if ckpt is None:
                    raise
                logger.exception("training failed; retry %d/%d from %s",
                                 attempts, get_config().failure_retry_times,
                                 ckpt)
                mgr.restore_into(self, ckpt, verified=True)

    def _optimize_impl(self) -> torch.nn.Module:
        self.mesh = self._resolve_mesh()
        group = self.mesh.group
        self._world, self._rank = self.mesh.size, self.mesh.rank
        self._place()
        device = self._run_device
        guard = self._guard_policy = self._resolved_numeric_guard()
        self._check_rollback()
        seed = self._resolved_seed()
        net, params, stochastic = self._training_copy(device)
        # parameter names in the reference's leaf order, the walk that
        # orders the bucket plan; tags as the reference writes them
        leaves = list(leaves_with_path(
            jax_tree(net, {k: k for k in params}, "params"), keys=True))
        names = self._gs_names = [name for _, name in leaves]
        self._param_tags = [("Parameters/" + "/".join(
            k if isinstance(k, str) else f"[{k}]" for k in path), name)
            for path, name in leaves]
        params_tree = jax_tree(net, params, "params")
        self._resolve_grad_sync(params_tree)
        self._validate_resume_schema(params_tree)
        plist = [params[k] for k in names]
        saved, self._resume_opt_state = self._resume_opt_state, None
        if saved is not None:
            self._check_resumed_opt_state(saved)
        if self._use_grad_sync:
            plan = self._gs_plan
            with torch.no_grad():
                full = _to_device(saved, device) if saved is not None \
                    else grad_sync.init_state(plan, plist, self.optim_method)
            ostate = grad_sync.owned_state(plan, full, self._rank)
            del full
        else:
            self._resume_opt_state = saved
            ostate = self._restored_opt_state(net, params)
        buffers = list(net.named_buffers())
        floats = [b for _, b in buffers if b.is_floating_point()]
        optim, clip = self.optim_method, self.grad_clip
        n, use_gs, wire = self._world, self._use_grad_sync, self._gs_wire
        clip_spec = self.grad_clip_spec
        gen = None
        if use_gs and wire != torch.float32:
            gen = torch.Generator(device=device)
        loss_fn = self._loss_fn(net, params, device)

        def step_fn(x, y, lr, step):
            for i, m in enumerate(stochastic):
                m.generator.manual_seed(stream_seed(seed, i, step))
            for p in plist:
                p.grad = None
            if guard == "skip":
                before = [(t, t.detach().clone()) for t in
                          [*plist, *floats,
                           *grad_sync.state_leaves(ostate)]]
            loss = loss_fn(x, y)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in plist]
            stats = [loss.detach().float().reshape(1)]
            if guard != "off":
                ok = step_finite(loss.detach(), dict(zip(names, grads)))
                stats.append((~ok).float().reshape(1))
            if use_gs:
                new, _ = grad_sync.sync_and_update(
                    plan, grads, ostate, optim, lr, step, wire_dtype=wire,
                    group=group, clip_spec=clip_spec, generator=gen)
                with torch.no_grad(), \
                        record_function("grad_sync.unflatten"):
                    for p, v in zip(plist, new):
                        p.copy_(v)
            else:
                mean = {k: g / n for k, g in zip(names, grads)}
                for g in mean.values():
                    grad_sync.all_reduce_sum_(g, group)
                if clip is not None:
                    mean = clip(mean)
                optim.update(mean, params, ostate, lr, step)
            # the loss, the model state and the not-finite share: one
            # all-reduce, averaged
            stats = torch.cat(stats)
            grad_sync.sync_model_state(floats + [stats], group)
            if guard == "off":
                return stats[0]
            finite = stats[1] == 0
            if guard == "skip":
                with torch.no_grad():
                    for t, old in before:
                        t.copy_(torch.where(finite, t, old))
            return stats[0], finite

        logger.info(
            "DistriOptimizer: %d samples/epoch, world=%d (%s), device=%s, "
            "grad_sync=%s%s", self.dataset.size(), n, self.mesh.backend,
            device, use_gs,
            f" (wire={grad_sync.wire_dtype_name(wire)}, buckets="
            f"{plan.num_buckets})" if use_gs else "")
        self._train_driver(step_fn, device, _Run(net, params, ostate))
        self._final_opt_state = ostate
        self._write_back(net)
        return self.model

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
packages at the same world size.

Tensor parallelism (``param_specs``, a tree of ``parallel.Spec`` from
``parallel.build_param_specs``) over a ``data x model`` mesh: the training
copy is placed on the process's model device group
(``parallel.shard_module``: the opted-in layers' shards on the group, the
rest on the home device); as in the reference, such a run takes the
all-reduce path whatever ``parameter_sharding`` says (the flat ZeRO-1
buckets do not apply to parameters that are themselves split): each
device's shard gradients are averaged over the ``data`` group as one
bucket staged through the home device, the norm clip counts every shard
and every replicated parameter once, and the optimizer's state lives
beside each shard.  Snapshots, summaries and the weights written back
hold the unsharded tensors, so an unsharded model loads them.

Elastic training (``set_elastic``, or ``resize``/``host_loss``/
``device_loss`` clauses in ``Config.fault_plan``): a membership epoch
freezes a roster, a prefix of the launch ranks.  Every launch rank keeps
the same deterministic plan and ledger, so all of them cross the same
epoch boundaries.  At a change the roster finishes (graceful) or abandons
(abrupt) the block in flight, every launch rank restores the latest valid
snapshot and builds the new roster's process group (``new_group``, called
by all of them), and the run resumes on it: the ``DistributedDataSet``
re-shards over the roster with the global batch kept (each roster rank's
local batch is the global batch over the roster size), the records scale
and the bucket plan follow the roster, the ZeRO-1 state is re-padded
(``grad_sync.reshard_state``).  A launch rank outside the roster does no
step: it waits on the launch group for rank 0's word — the next epoch
(it then resumes with the rest) or the end of training (it then takes
the trained parameters and the driver counters from rank 0).
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Optional, Tuple

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
from bigdl_tpu_torch.parallel.tensor_parallel import logical_tensors
from bigdl_tpu_torch.resilience.membership import (ClusterMembership,
                                                   MembershipChanged)
from bigdl_tpu_torch.resilience.numeric import NonFiniteStepError
from bigdl_tpu_torch.utils import spmdcheck
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
            if grad_sync:
                raise ValueError(
                    "grad_sync=True requires a pure data-parallel run (no "
                    "param_specs): tensor parallelism shards the "
                    "parameters themselves, so the flat-bucket ZeRO-1 "
                    "protocol does not apply")
        elif grad_sync is not None and bool(grad_sync) != parameter_sharding:
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
        self._rank_in_roster = True
        # elastic: the mesh of every launch rank, and each roster's group
        self._launch_mesh: Optional[Mesh] = None
        self._roster: Optional[Tuple[int, ...]] = None  # the last run's
        self._roster_groups: dict = {}

    # -------------------------------------------------- elastic membership
    def set_elastic(self, membership: Optional[ClusterMembership] = None
                    ) -> "DistriOptimizer":
        """Arm elastic training: membership epochs over the launch ranks.
        A ``resize``/``host_loss``/``device_loss`` fault clause (or a
        ``request_resize`` on the returned optimizer's ``_membership``)
        opens a new epoch; the driver detects it at the replay boundary,
        snapshots, and ``optimize()`` resumes on the new roster.  Built
        once per optimizer, so epochs stay monotonic across every shrink
        and regrow of a run.  Needs ``set_checkpoint``."""
        if self._membership is None:
            # the mesh of a run already going is the launch mesh
            self._launch_mesh = self._launch_mesh or self.mesh
            self._membership = membership if membership is not None \
                else ClusterMembership(
                    tuple(range(self._launch_world())),
                    registry=self.metrics.registry, recorder=self._flight)
        return self

    def _launch_world(self) -> int:
        mesh = self._launch_mesh or self.mesh
        if mesh is not None:
            return mesh.size
        return dist.get_world_size() if dist.is_initialized() else 1

    def _arm_membership_from_plan(self, faults) -> None:
        if faults is None or not faults.has_membership_kinds():
            return
        self.set_elastic()

    def _roster_mesh(self, launch: Mesh) -> Optional[Mesh]:
        """This run's mesh: the launch mesh, or under a smaller roster
        its group's (every launch rank builds every roster's group, in
        ledger order, as ``new_group`` asks).  None on a launch rank
        outside the roster."""
        cur = self._membership.current()
        roster = tuple(cur.devices)
        prev = self._roster or tuple(range(launch.size))
        self._roster = roster
        if roster != prev and self._resize_t0 is None:
            # an epoch opened between runs (an operator's request_resize
            # before optimize()): nothing is in flight, adopt it up front
            # with no restore.  spmdcheck: adopting a roster re-keys every
            # later collective
            spmdcheck.note("membership_adopt", axis=f"epoch{cur.epoch}")
            logger.warning("membership epoch %d (%s): adopting world=%d "
                           "roster at run start", cur.epoch, cur.reason,
                           cur.world)
            self._flight_event("resize_adopt", epoch=cur.epoch,
                               world=cur.world, reason=cur.reason)
        if len(roster) == launch.size:
            return launch
        group = self._roster_groups.get(roster)
        if group is None:
            group = self._roster_groups[roster] = dist.new_group(
                ranks=list(roster), backend=launch.backend)
        if dist.get_rank() not in roster:
            return None
        return Mesh(dict(launch.shape, data=len(roster)), group,
                    launch.backend, launch.devices)

    _REASONS = ("resize", "host_loss", "device_loss")

    def _word(self, *values) -> torch.Tensor:
        """Rank 0's word to the launch ranks outside the roster: one
        broadcast on the launch group (NCCL moves CUDA tensors)."""
        dev = self._run_device if self._launch_mesh.backend == "nccl" \
            else torch.device("cpu")
        msg = torch.tensor([float(v) for v in values] or [0.0] * 6,
                           dtype=torch.float64, device=dev)
        dist.broadcast(msg, src=0, group=self._launch_mesh.group)
        return msg.cpu()

    def _has_idle_ranks(self) -> bool:
        return self._launch_mesh is not None \
            and self._world < self._launch_mesh.size

    def _announce_change(self, e: MembershipChanged) -> None:
        """The roster's side of :meth:`_sit_out` at an epoch change."""
        ep = e.epoch
        self._word(1, ep.epoch, ep.world, ep.graceful, e.detected_neval,
                   self._REASONS.index(ep.reason))

    def _announce_end(self) -> None:
        """The roster's side of :meth:`_sit_out` when training ends: the
        driver counters, then every parameter and buffer from rank 0."""
        s = self.state
        self._word(0, s["neval"], s["epoch"],
                   s["records_processed_this_epoch"], 0, 0)
        self._broadcast_model()

    def _broadcast_model(self) -> None:
        dev = self._run_device if self._launch_mesh.backend == "nccl" \
            else torch.device("cpu")
        with torch.no_grad():
            for t in [*self.model.parameters(), *self.model.buffers()]:
                buf = t.detach().to(dev).contiguous()
                dist.broadcast(buf, src=0, group=self._launch_mesh.group)
                t.copy_(buf.to(t.device))

    def _sit_out(self) -> torch.nn.Module:
        """A launch rank outside the roster: wait for rank 0's word.
        At an epoch change, adopt it into this rank's ledger and raise
        ``MembershipChanged`` like the roster does; at the end, take the
        driver counters and the trained model and return."""
        logger.info("membership epoch %d: rank %d outside the roster, "
                    "waiting", self._membership.epoch(), dist.get_rank())
        word = [int(v) for v in self._word()]
        if word[0] == 0:
            neval, epoch, records = word[1:4]
            self.state.update(neval=neval, epoch=epoch,
                              records_processed_this_epoch=records)
            self._broadcast_model()
            return self.model
        epoch, world, graceful, neval, reason = word[1:6]
        m = self._membership
        why = self._REASONS[reason]
        if why == "device_loss":
            m.signal_device_loss(to=world)
        elif why == "host_loss":
            m.signal_host_loss(to=world)
        else:
            m.request_resize(world, reason=why)
        ep = m.current()
        if ep.epoch != epoch:
            raise RuntimeError(
                f"membership ledgers disagree: rank 0 announced epoch "
                f"{epoch}, this rank is at {ep.epoch}")
        raise MembershipChanged(ep, bool(graceful), neval, time.monotonic())

    # replay-boundary: the roster replayed or abandoned the block in flight
    def _resume_after_resize(self, e: MembershipChanged) -> None:
        """Restore the latest valid snapshot (rank 0's writer idle and
        every launch rank past a barrier first), so the next run resumes
        on the new roster; a resize is a measured event, not a failure,
        and burns no retry."""
        ep = e.epoch
        logger.warning("membership epoch %d (%s, graceful=%s): resuming on "
                       "world=%d", ep.epoch, ep.reason, ep.graceful,
                       ep.world)
        mgr = self._checkpoint_manager()
        mgr.wait()
        dist.barrier(group=self._launch_mesh.group)
        ckpt = mgr.latest_valid()
        if ckpt is None:
            raise RuntimeError(
                f"membership epoch {ep.epoch} ({ep.reason}) but no "
                f"valid snapshot under {self.checkpoint_path} to resume "
                f"from — elastic training needs one committed snapshot "
                f"before an abrupt device loss") from e
        mgr.restore_into(self, ckpt, verified=True)
        lost = max(0, e.detected_neval - int(self.state["neval"]))
        self.metrics.registry.counter(
            "resilience/steps_lost_to_resize").inc(lost)
        self._flight_event("resize_restore", epoch=ep.epoch,
                           world=ep.world, reason=ep.reason,
                           steps_lost=lost,
                           iteration=int(self.state["neval"]))
        # the downtime clock runs until the resumed driver stages again
        self._resize_t0 = e.t0

    def _maybe_reshard_resumed(self, ostate):
        """An elastic resume of a grad_sync state written at another
        world size: each bucket cut to its content and re-padded to this
        run's plan (padding is zeros, which elementwise methods keep)."""
        if self._membership is None or not self._use_grad_sync \
                or not is_grad_sync_state(ostate):
            return ostate
        want = [(s,) for s in self._gs_plan.bucket_sizes]
        got = [tuple(m.shape) for m in ostate["master"]]
        if want == got:
            return ostate
        logger.info("elastic resume: re-sharding grad_sync state %s -> %s "
                    "(n_shard=%d)", got, want, self._gs_plan.n_shard)
        return grad_sync.reshard_state(self._gs_plan, ostate)

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
        if mesh.backend is None:  # a local mesh: start its world-1 group
            from bigdl_tpu_torch.parallel.mesh import init_process_group
            mesh.backend = init_process_group(want)
            if dist.get_world_size() != mesh.size:
                raise ValueError(f"a local mesh of one process in a world "
                                 f"of {dist.get_world_size()}: build the "
                                 f"mesh with create_mesh(backend=...)")
        if mesh.backend != want:
            raise ValueError(f"the mesh's group runs {mesh.backend!r}, "
                             f"this run asked for {want!r}")
        return mesh

    def _place(self) -> None:
        """One device a process (its model group's first under tensor
        parallelism): under NCCL, ``cuda`` means this process's local
        rank's card."""
        dev = self.device
        if self.mesh.devices is not None:
            dev = self.mesh.home
            if dev.type != self.device.type:
                raise ValueError(f"the mesh's model group starts on {dev}, "
                                 f"this run's device is {self.device}")
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
        self._use_grad_sync = use = self.parameter_sharding \
            and self.param_specs is None
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

    def _placed_copy(self, device) -> torch.nn.Module:
        """Under ``param_specs``, a copy placed on the mesh's model group
        (its shards there, the rest on ``device``, the home device)."""
        if self.param_specs is None:
            return super()._placed_copy(device)
        from bigdl_tpu_torch.parallel.mesh import Mesh
        from bigdl_tpu_torch.parallel.tensor_parallel import shard_module
        mesh = self.mesh if self.mesh.devices is not None \
            else Mesh(self.mesh.shape, devices=[device])
        return shard_module(copy.deepcopy(self.model), mesh,
                            self.param_specs)

    def _note_staged(self, staged) -> None:
        # spmdcheck: the reference assembles the global block from every
        # process's share here, one rendezvous a leaf; the port's
        # processes stage their own shares, and the notes keep the two
        # schedules aligned
        if spmdcheck.installed():
            for _, leaf in leaves_with_path((staged.xs, staged.ys)):
                spmdcheck.note("make_global", payload=leaf)

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
        # spmdcheck: every process captures at the same iteration
        spmdcheck.note("checkpoint", payload=trees[0])
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
        full = logical_tensors(run.net, run.params)
        for tag, name in self._param_tags:
            self.train_summary.add_histogram(tag, full[name],
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
                model = self._optimize_impl()
                if self._membership is not None and self._rank_in_roster \
                        and self._has_idle_ranks():
                    self._announce_end()
                return model
            except MembershipChanged as e:
                # the roster replayed or abandoned its block; the ranks
                # outside it hear of the change, then all of them restore
                if self._rank_in_roster \
                        and self._has_idle_ranks():
                    self._announce_change(e)
                self._resume_after_resize(e)
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
        if self._membership is None:
            self.mesh = self._resolve_mesh()
        else:
            launch = self._launch_mesh = \
                self._launch_mesh or self._resolve_mesh()
            mesh = self._roster_mesh(launch)
            self._rank_in_roster = mesh is not None
            self.mesh = mesh or launch
        self._place()
        if not self._rank_in_roster:
            return self._sit_out()
        group = self.mesh.group
        self._world, self._rank = self.mesh.size, self.mesh.rank
        device = self._run_device
        if self._membership is not None:
            # the data, the records scale and the bucket plan follow the
            # roster
            self.dataset.reshard(self._rank, self._world)
        guard = self._guard_policy = self._resolved_numeric_guard()
        self._check_rollback()
        seed = self._resolved_seed()
        net, params, stochastic = self._training_copy(device)
        logical = logical_tensors(net, params)
        # parameter names in the reference's leaf order, the walk that
        # orders the bucket plan; tags as the reference writes them (a
        # tensor-parallel shard's under its unsharded name)
        leaves = list(leaves_with_path(
            jax_tree(net, {k: k for k in logical}, "params"), keys=True))
        self._param_tags = [("Parameters/" + "/".join(
            k if isinstance(k, str) else f"[{k}]" for k in path), name)
            for path, name in leaves]
        params_tree = jax_tree(net, logical, "params")
        self._resolve_grad_sync(params_tree)
        self._validate_resume_schema(params_tree)
        names = self._gs_names = [name for _, name in leaves] \
            if self._use_grad_sync else list(params)
        plist = [params[k] for k in names]
        saved, self._resume_opt_state = self._resume_opt_state, None
        if saved is not None:
            saved = self._maybe_reshard_resumed(saved)
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
        tensor_parallel = self.param_specs is not None
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
                if tensor_parallel:
                    grad_sync.all_reduce_staged_(list(mean.values()), group,
                                                 device)
                else:
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
            "model group=%s, grad_sync=%s%s", self.dataset.size(), n,
            self.mesh.backend, device,
            None if self.mesh.devices is None
            else [str(d) for d in self.mesh.devices], use_gs,
            f" (wire={grad_sync.wire_dtype_name(wire)}, buckets="
            f"{plan.num_buckets})" if use_gs else "")
        self._train_driver(step_fn, device, _Run(net, params, ostate))
        self._final_opt_state = ostate
        self._write_back(net)
        return self.model

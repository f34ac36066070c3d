"""Optimizer, the training front door (port of
``bigdl_tpu/optim/optimizer.py``: the builder API and ``LocalOptimizer``).

Driver-loop design, as in the reference:

- **K-step blocks.** ``steps_per_dispatch = K`` steps (forward, backward,
  clipping, update) are enqueued on the card back to back with no host
  sync; each step's loss stays on the card.  A block is capped with
  :func:`~bigdl_tpu_torch.optim.trigger.probe_fire_step`, so an iteration
  at which a trigger fires, or an epoch ends, is always a block's last
  step: results and trigger cadence do not depend on K.
- **Pipelined host work.** Block b+1 is staged (pinned host memory, an
  asynchronous copy on a side stream, ``dataset/prefetch.py``) right after
  block b is enqueued, and block b's losses are copied to the host only
  after block b+1 is enqueued: the loss fetch runs one block behind.

The step is eager PyTorch: autograd over the model, then the optimizer's
in-place update under ``torch.no_grad()``.  Inputs and targets may be
nested (tuples, dicts and ``COOBatch`` es, as Wide&Deep's ``(coo, deep_ids,
dense)``): step j of a block is every leaf's slice j.  With ``set_compute_dtype(
torch.bfloat16)`` the forward and backward run in bf16 on bf16 casts of
the f32 parameters, and the gradients and the update stay f32
(``utils/precision.py``).  BatchNorm's running statistics are buffers of
the training copy, updated in place by every step of a block.  Gradient clipping
(:func:`clip_by_value`, :func:`clip_by_global_norm`) stays on the card.
The training runs on a copy of the user's model on ``device``; the trained
weights are written back into the user's model at the end.

Around the loop, as in the reference:

- **Validation** (``set_validation``): the validation set's forward in
  eval mode under ``torch.no_grad()``, at the iteration where its trigger
  fires; the scores feed ``state["score"]``, the validation summary and a
  ``Plateau`` schedule, once per validation.
- **Checkpoints** (``set_checkpoint``, ``resume``,
  ``set_preemption_handling``): the parameters, buffers and optimizer
  state in the reference's tree layout (``interop/jax_weights.py``),
  copied to the host and committed in the background
  (``checkpoint/``), with the driver counters, the seed and the dataset's
  shuffle position, so a resumed run continues mid-epoch bitwise.
  SIGTERM/SIGINT finish the block in flight, write one last snapshot and
  return.
- **Summaries** (``set_train_summary``, ``set_val_summary``).
- **The numeric guard** (``set_numeric_guard``, ``resilience/numeric.py``).

The trigger probe covers the validation and checkpoint triggers, so the
iteration where one fires ends a block: validation and the snapshot see
that iteration's parameters.  The stochastic layers (each a
:class:`~bigdl_tpu_torch.nn.module.Stochastic`: ``Dropout``, ``RReLU``,
...) draw from generators seeded by (run seed, layer, iteration), so a
resumed run draws what the uninterrupted one drew.

The step's loss is the criterion's plus every layer's regularizer penalty
(``nn/regularizers.py``).  ``set_activation_memory`` picks what the
backward keeps: ``"full"`` recomputes the whole forward, ``"dots"`` keeps
only the outputs of products and convolutions (``torch.utils.checkpoint``
and its selective form over the step's loss, ``nn/module.py``), ``"bf16"``
computes (and so stores) in bf16.  A recomputed forward leaves BatchNorm's
statistics and the stochastic layers' draws as the first one left them.
``set_workload`` names the ``tuned_configs.json`` entry whose values fill
the knobs left at their defaults (``utils/tuned.py``).

``Optimizer.create(..., distributed=True)`` builds the data-parallel
``DistriOptimizer`` (``optim/distri_optimizer.py``), which overrides the
driver's hooks: ``_records_scale`` (the global batch is the world's local
batches), the step, the snapshot and the validation's reduction.

Resilience and telemetry, as in the reference, each inert when off (no
object built, the losses and the kernel launches unchanged):

- **Telemetry** (``set_telemetry`` / ``Config.telemetry_enabled``): tracer
  spans around staging, dispatch, the one-block-behind device wait,
  replay and the triggers, the stall detector's phase fractions and the
  memory gauges (``telemetry/``); the flight recorder
  (``Config.flight_recorder_path``) and the admin plane
  (``Config.admin_port``).
- **Fault injection** (``Config.fault_plan``, ``resilience/faults.py``):
  poisoned staged blocks, driver dispatch errors retried under
  ``failure_retry_times``, membership events at the replay boundary
  (``DistriOptimizer`` only; ``LocalOptimizer`` refuses them).
- **spmdcheck** notes at the checkpoint capture, the dispatch and the
  block fetch (``utils/spmdcheck.py``).

Not ported yet, raising ``NotImplementedError`` where the reference has
the API: compute dtypes other than f32 and bf16.
"""

from __future__ import annotations

import copy
import logging
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.checkpoint import (CheckpointManager, PreemptionHandler,
                                        build_schema, validate_schema)
from bigdl_tpu_torch.checkpoint.schema import describe_params
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import (DeviceBlockStager, StagedBlock,
                                              fast_forward_records)
from bigdl_tpu_torch.engine import Engine, resolve_device
from bigdl_tpu_torch.interop.jax_weights import (from_jax_tree, jax_tree,
                                                 load_jax_params)
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import Stochastic, checkpointed, walk
from bigdl_tpu_torch.nn.regularizers import (has_regularizers,
                                             regularization_loss)
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch, probe_fire_step
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult,
                                              validation_sums)
from bigdl_tpu_torch.parallel.grad_sync import state_leaves
from bigdl_tpu_torch.parallel.tensor_parallel import (logical_parameters,
                                                      logical_tensors,
                                                      split_tensors)
from bigdl_tpu_torch.resilience.faults import FaultInjector, InjectedFault
from bigdl_tpu_torch.resilience.membership import (ClusterMembership,
                                                   MembershipChanged)
from bigdl_tpu_torch.resilience.numeric import (NonFiniteStepError,
                                                validate_policy)
from bigdl_tpu_torch.telemetry import (NULL_SPAN, DriverTelemetry, admin,
                                       flight, jit_cache_size)
from bigdl_tpu_torch.telemetry.registry import MetricRegistry
from bigdl_tpu_torch.utils import spmdcheck
from bigdl_tpu_torch.utils.config import get_config
from bigdl_tpu_torch.utils.metrics import Metrics
from bigdl_tpu_torch.utils.precision import mixed_precision_loss_fn
from bigdl_tpu_torch.utils.tuned import resolve_default

logger = logging.getLogger("bigdl_tpu_torch.optim")

Tensors = Dict[str, torch.Tensor]


def clip_by_value(grads: Tensors, min_v: float, max_v: float) -> Tensors:
    return {k: torch.clamp(g, min_v, max_v) for k, g in grads.items()}


def global_norm(grads: Tensors) -> torch.Tensor:
    """L2 norm over every gradient (each tensor once: a tensor-parallel
    shard is a gradient of its own), as a 0-d tensor on the first
    gradient's device."""
    dev = next(iter(grads.values())).device
    return torch.sqrt(sum(torch.sum(g.float() ** 2).to(dev)
                          for g in grads.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """Scale every gradient by ``min(1, max_norm / norm)``; no host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.device) for k, g in grads.items()}


def step_finite(loss, grads: Tensors) -> torch.Tensor:
    """0-d bool on the card: the loss and every floating gradient are
    finite.  Computed inside the step, so the flag rides the loss fetch."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all().to(loss.device)
              for g in grads.values() if g.is_floating_point()]
    return torch.stack(flags).all()


def select_step(finite: torch.Tensor, new, old):
    """``new`` where the step was finite, ``old`` otherwise, leaf by leaf
    of a tensor or a dict, list or tuple of them (the skip guard's select:
    a skipped step leaves parameters, model state and optimizer state as
    if it never ran)."""
    if isinstance(new, dict):
        return {k: select_step(finite, new[k], old[k]) for k in new}
    if isinstance(new, (list, tuple)):
        return type(new)(select_step(finite, a, b) for a, b in zip(new, old))
    return torch.where(finite, new, old)


def stream_seed(seed: int, layer: int, step: int) -> int:
    """Seed of stochastic layer ``layer``'s generator at iteration
    ``step``: a pure function of the three, so any K and a resumed run
    draw the same masks."""
    return ((seed * 1000 + layer) << 32) + step


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to bigdl_tpu_torch yet "
                              f"(ROADMAP queue A)")


class _InFlight:
    """An enqueued block whose per-step losses are still on the card."""

    __slots__ = ("losses", "sizes", "lrs", "t0", "stage_s", "dispatch_s")

    def __init__(self, losses, sizes, lrs, t0, stage_s=0.0, dispatch_s=0.0):
        self.losses, self.sizes, self.lrs, self.t0 = losses, sizes, lrs, t0
        self.stage_s = stage_s        # planning + staging host time
        self.dispatch_s = dispatch_s  # the steps' enqueue host time


class _Run:
    """What one run trains: the training copy ``net`` on the card, its
    parameters by name and the optimizer state."""

    __slots__ = ("net", "params", "ostate")

    def __init__(self, net, params: Tensors, ostate: dict):
        self.net, self.params, self.ostate = net, params, ostate


class Optimizer:
    """Builder and the driver loop."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = max_epoch(1)
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: Sequence[ValidationMethod] = ()
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_path: Optional[str] = None
        self.overwrite_checkpoint = True
        # retention and writer knobs (None = Config's); the manager is
        # built on first use, so builder calls in any order take effect
        self.checkpoint_keep_last: Optional[int] = None
        self.checkpoint_keep_every: Optional[int] = None
        self.checkpoint_async: Optional[bool] = None
        self.preemption_handling = False
        self._ckpt_manager: Optional[CheckpointManager] = None
        self._preemption: Optional[PreemptionHandler] = None
        self._resume_schema: Optional[dict] = None
        self._resume_opt_state: Optional[dict] = None  # reference layout
        self.train_summary = None
        self.validation_summary = None
        # the driver's phase accumulators ("data", "computing") and its
        # checkpoint, numeric-guard, fault and membership counters; the
        # telemetry watchdogs share the registry
        self.metrics = Metrics()
        # None = setter never called: Config.numeric_guard applies
        self.numeric_guard: Optional[str] = None
        self._guard_policy = "off"  # resolved per run
        self.grad_clip: Optional[Callable[[Tensors], Tensors]] = None
        # the clipping as data, for the sharded sync: ("value", lo, hi) |
        # ("norm", max_norm)
        self.grad_clip_spec: Optional[tuple] = None
        self.seed: Optional[int] = None  # None = Config.seed
        self.steps_per_dispatch: Optional[int] = None  # None = Engine's
        self.compute_dtype: Optional[torch.dtype] = None  # None = f32
        # None = setter never called: the default chain applies
        self.activation_memory: Optional[str] = None
        self.workload: Optional[str] = None  # tuned_configs.json key
        self.state: dict = {"epoch": 0, "neval": 0,
                            "records_processed_this_epoch": 0}
        self._stager: Optional[DeviceBlockStager] = None
        self._epoch_size = 0
        self._dispatch_count = 0  # blocks enqueued by the last run
        # telemetry: None = Config.telemetry_enabled; the run's bundle
        # lives in _telemetry (None when off: every site tests that)
        self.telemetry_enabled: Optional[bool] = None
        self.telemetry_trace_path: Optional[str] = None
        self._telemetry: Optional[DriverTelemetry] = None
        # flight recorder: None unless Config.flight_recorder_path is set
        self._flight = None
        # admin-plane source name, minted once per optimizer
        self._admin_name: Optional[str] = None
        # fault injector: None unless Config.fault_plan names a plan
        self._fault_injector: Optional[FaultInjector] = None
        # elastic membership: None unless a membership fault clause or
        # DistriOptimizer.set_elastic() arms one
        self._membership: Optional[ClusterMembership] = None
        # monotonic() time of the last MembershipChanged detection; the
        # resumed run observes resilience/resize_downtime_s from it
        self._resize_t0: Optional[float] = None

    @property
    def registry(self) -> MetricRegistry:
        """The driver's metric registry (``self.metrics.registry``)."""
        return self.metrics.registry

    # ------------------------------------------------------------- builder
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_gradient_clipping_by_value(self, min_v: float,
                                       max_v: float) -> "Optimizer":
        self.grad_clip = lambda g: clip_by_value(g, min_v, max_v)
        self.grad_clip_spec = ("value", min_v, max_v)
        return self

    def set_gradient_clipping_by_l2_norm(self, max_norm: float) -> "Optimizer":
        self.grad_clip = lambda g: clip_by_global_norm(g, max_norm)
        self.grad_clip_spec = ("norm", max_norm)
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip = None
        self.grad_clip_spec = None
        return self

    def set_seed(self, seed: int) -> "Optimizer":
        self.seed = seed
        return self

    def set_steps_per_dispatch(self, k: int) -> "Optimizer":
        """Enqueue ``k`` consecutive train steps per block, with no host
        sync inside it; results and trigger cadence do not depend on K."""
        if int(k) < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        self.steps_per_dispatch = int(k)
        return self

    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        """Score ``methods`` over ``dataset`` (MiniBatches; with
        ``batch_size``, Samples re-batched keeping the ragged last batch)
        whenever ``trigger`` fires."""
        self.validation_trigger = trigger
        self.validation_methods = list(methods)
        if batch_size is not None:
            from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
            dataset = dataset >> SampleToMiniBatch(
                batch_size, drop_remainder=False)
        self.validation_dataset = dataset
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       keep_last: Optional[int] = None,
                       keep_every: Optional[int] = None,
                       async_save: Optional[bool] = None) -> "Optimizer":
        """Snapshot the whole training state to ``path/model.<neval>``
        whenever ``trigger`` fires: atomic and checksummed, committed on a
        background writer (``async_save``, default
        ``Config.checkpoint_async``), kept per ``keep_last`` /
        ``keep_every`` (defaults ``Config.checkpoint_keep_last`` /
        ``checkpoint_keep_every``)."""
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.checkpoint_keep_last = keep_last
        self.checkpoint_keep_every = keep_every
        self.checkpoint_async = async_save
        if self._ckpt_manager is not None:
            # stop the old manager's writer thread
            self._ckpt_manager.close(raise_errors=False)
        self._ckpt_manager = None  # rebuilt with the new settings
        return self

    def over_write_checkpoint(self, enabled: bool = True) -> "Optimizer":
        """Allow (default) or forbid overwriting an existing
        ``model.<neval>``: with ``enabled=False`` a colliding save raises
        ``FileExistsError``."""
        self.overwrite_checkpoint = bool(enabled)
        if self._ckpt_manager is not None:
            self._ckpt_manager.overwrite = self.overwrite_checkpoint
        return self

    def set_preemption_handling(self, enabled: bool = True) -> "Optimizer":
        """Install a SIGTERM/SIGINT handler for the span of
        ``optimize()``: on a signal the driver finishes the block in
        flight, writes one last synchronous snapshot and returns with
        ``state["preempted"] = True`` (needs ``set_checkpoint``)."""
        self.preemption_handling = bool(enabled)
        return self

    # replay-boundary: run start — nothing is in flight before optimize()
    def resume(self, path: Optional[str] = None) -> bool:
        """Restore the latest valid snapshot of the checkpoint directory
        (torn or corrupt ones are skipped), or ``path``: the model's
        parameters and buffers, the optimizer state (checked against the
        saved schema at ``optimize()``), the driver counters, the seed
        and the dataset's shuffle position.  The next ``optimize()``
        continues mid-epoch exactly.  False when no snapshot exists."""
        if not self.checkpoint_path:
            raise ValueError("resume() needs set_checkpoint(path, ...) "
                             "so there is a directory to resume from")
        mgr = self._checkpoint_manager()
        verified = path is None
        ckpt = path if path is not None else mgr.latest_valid()
        if ckpt is None:
            return False
        mgr.restore_into(self, ckpt, verified=verified)
        logger.info("resumed from %s (iteration %d)", ckpt,
                    self.state.get("neval", 0))
        return True

    def set_train_summary(self, summary) -> "Optimizer":
        self.train_summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        self.validation_summary = summary
        return self

    def set_state(self, state: dict) -> "Optimizer":
        """Driver state (``epoch``, ``neval``, ...) to continue from."""
        self.state.update(state)
        return self

    def set_telemetry(self, enabled: bool = True,
                      trace_path: Optional[str] = None) -> "Optimizer":
        """Turn the telemetry on or off for this optimizer's runs
        (overrides ``Config.telemetry_enabled`` / ``BIGDL_TPU_TELEMETRY``).
        ``trace_path``: write the Chrome-trace JSON there when training
        ends (summarize with ``python -m tools.trace_report``)."""
        self.telemetry_enabled = bool(enabled)
        if trace_path is not None:
            self.telemetry_trace_path = trace_path
        return self

    def telemetry_snapshot(self) -> Optional[dict]:
        """Registry and watchdog snapshot of the last telemetry-enabled
        run; None when telemetry was off."""
        return self._telemetry.snapshot() if self._telemetry else None

    def set_numeric_guard(self, policy: Optional[str]) -> "Optimizer":
        """Non-finite loss/gradient policy for this run (overrides
        ``Config.numeric_guard``): ``None``/``"off"``, ``"skip"``,
        ``"rollback"`` (needs ``set_checkpoint``) or ``"abort"``; see
        ``resilience/numeric.py``.  No policy adds a host sync."""
        self.numeric_guard = "off" if policy is None \
            else validate_policy(policy)
        return self

    _ACTIVATION_POLICIES = ("none", "bf16", "dots", "full", "bf16+dots",
                            "bf16+full")

    def set_activation_memory(self, policy: Optional[str]) -> "Optimizer":
        """What the backward keeps of the forward: ``None``/``"none"``
        keeps everything (the step as without the setter); ``"dots"``
        keeps the outputs of matrix products and convolutions and
        recomputes the rest; ``"full"`` recomputes the whole forward from
        the step's inputs, but as one region over the step it redoes the
        forward before the backward needs any of it, so its peak is
        ``"none"``'s and only its time grows (``resnet50(remat=True)``,
        one region a block, is what lowers the peak); ``"bf16"`` computes,
        and so stores, in bf16 (the mixed-precision path: parameters,
        gradients and the update stay f32); ``"bf16+dots"``,
        ``"bf16+full"`` both.  The
        recomputation computes what the first forward computed: only what
        is stored changes."""
        if policy is not None and policy not in self._ACTIVATION_POLICIES:
            raise ValueError(
                f"activation memory policy must be one of "
                f"{self._ACTIVATION_POLICIES} or None, got {policy!r}")
        # an explicit None is the inert policy, which overrides a default
        self.activation_memory = "none" if policy is None else policy
        return self

    def set_workload(self, tag: Optional[str]) -> "Optimizer":
        """Tag this run's workload (``"ptb_lstm"``, ``"wide_deep"``, ...):
        the ``tuned_configs.json`` entry ``tag@<device type>`` fills
        ``steps_per_dispatch``, ``activation_memory`` and
        (``DistriOptimizer``) the gradient sync's wire and bucket size
        where nothing above it set them (``utils/tuned.py``).  Without such
        an entry the tag changes nothing."""
        self.workload = tag
        return self

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "Optimizer":
        """Mixed precision: forward and backward in ``dtype`` (bf16 or
        f16 for the tensor cores); parameters, gradients, optimizer state
        and the update stay f32.  ``None`` and ``torch.float32`` compute in
        f32.  f16, like the reference's, runs without loss scaling, and
        every hand-written kernel (the max-pool backward, the LSTM cell,
        the embedding bag, the int8 GEMM) has an f16 form on the card."""
        if dtype not in (None, torch.float32, torch.bfloat16,
                         torch.float16):
            _not_ported(f"compute dtype {dtype} (set_compute_dtype takes "
                        f"None, torch.float32, torch.bfloat16 or "
                        f"torch.float16)")
        self.compute_dtype = dtype
        return self

    @staticmethod
    def create(model, dataset, criterion, distributed: bool = False, **kw):
        """``LocalOptimizer``, or with ``distributed=True`` the
        data-parallel ``DistriOptimizer``; ``kw`` go to its constructor."""
        if distributed:
            from bigdl_tpu_torch.optim.distri_optimizer import \
                DistriOptimizer
            return DistriOptimizer(model, dataset, criterion, **kw)
        return LocalOptimizer(model, dataset, criterion, **kw)

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    # ------------------------------------------------------------- shared
    def _resolved_numeric_guard(self) -> str:
        if self.numeric_guard is not None:
            return self.numeric_guard
        return validate_policy(get_config().numeric_guard,
                               source="Config.numeric_guard")

    def _workload_tag(self) -> Optional[str]:
        return self.workload or Engine.workload()

    def _resolved_activation_memory(self, device) -> str:
        """The setter's policy, else the default chain (``configure()``/
        ``BIGDL_TPU_ACTIVATION_MEMORY`` > the tuned entry > ``"none"``);
        a bad value from the environment or a tuned file raises here."""
        if self.activation_memory is not None:
            return self.activation_memory
        policy, src = resolve_default("activation_memory",
                                      workload=self._workload_tag(),
                                      backend=torch.device(device).type)
        if policy not in self._ACTIVATION_POLICIES:
            raise ValueError(
                f"activation_memory {policy!r} (from {src}) must be "
                f"one of {self._ACTIVATION_POLICIES}")
        return policy

    def _steps_per_block(self, device) -> int:
        return self.steps_per_dispatch or Engine.steps_per_dispatch(
            workload=self._workload_tag(), backend=torch.device(device).type)

    def _resolved_seed(self) -> int:
        return get_config().seed if self.seed is None else int(self.seed)

    def _checkpoint_manager(self) -> CheckpointManager:
        if self._ckpt_manager is None:
            cfg = get_config()
            pick = lambda v, d: d if v is None else v  # noqa: E731
            self._ckpt_manager = CheckpointManager(
                self.checkpoint_path,
                keep_last=pick(self.checkpoint_keep_last,
                               cfg.checkpoint_keep_last),
                keep_every=pick(self.checkpoint_keep_every,
                                cfg.checkpoint_keep_every),
                overwrite=self.overwrite_checkpoint,
                async_save=pick(self.checkpoint_async,
                                cfg.checkpoint_async),
                registry=self.metrics.registry)
        return self._ckpt_manager

    def _tel_span(self, name: str, cat: str, **args):
        """A tracer span when telemetry is on; the shared no-op otherwise
        (the off path allocates nothing)."""
        tel = self._telemetry
        if tel is None:
            return NULL_SPAN
        return tel.tracer.span(name, cat=cat, **args)

    def _flight_event(self, event: str, **fields) -> None:
        """One driver event into the flight recorder (no-op when none is
        live), with the run's trace id when telemetry is on."""
        fl = self._flight
        if fl is not None:
            tel = self._telemetry
            fl.record(event, cat="driver",
                      trace_id=tel.trace_id if tel is not None else None,
                      **fields)

    def _arm_membership_from_plan(self, faults) -> None:
        """A single-process trainer cannot resize: membership clauses in
        its plan are refused, never silently left unfired
        (``DistriOptimizer`` arms a ``ClusterMembership`` instead)."""
        if faults is None or not faults.has_membership_kinds():
            return
        raise ValueError(
            "fault plan contains membership kinds (resize/host_loss/"
            "device_loss) but this is a LocalOptimizer — elastic "
            "training needs DistriOptimizer's device mesh to resize "
            "over")

    def _apply_membership_clause(self, clause) -> None:
        """One fired membership clause as its ``ClusterMembership``
        signal."""
        m = self._membership
        if clause.kind == "resize":
            m.request_resize(clause.to)
        elif clause.kind == "host_loss":
            m.signal_host_loss(to=clause.to)
        else:  # device_loss
            m.signal_device_loss(to=clause.to)

    def _records_scale(self) -> int:
        """Local batch rows -> global records (the world size under
        ``DistriOptimizer``)."""
        return 1

    def _note_staged(self, staged: StagedBlock) -> None:
        """A staged block's spmdcheck notes (none on one process)."""

    def _checkpoint_schema(self, params_tree) -> dict:
        return build_schema(params_tree,
                            optim_method=type(self.optim_method).__name__)

    def _model_params_schema(self) -> dict:
        """Shape/dtype fingerprint of the model's parameters in the
        reference's layout (``restore_into`` checks it before loading)."""
        return describe_params(jax_tree(
            self.model, dict(self.model.named_parameters()), "params"))

    def _load_training_state(self, params, model_state, opt_state) -> None:
        """A snapshot's trees (the reference's layout) into the model and,
        for the next ``optimize()``, the optimizer state."""
        load_jax_params(self.model, params, model_state or {})
        self._resume_opt_state = opt_state

    def _restored_opt_state(self, net, params: Tensors) -> dict:
        """The optimizer state of this run: fresh, or the resumed one
        copied into a fresh state's tensors (same names and shapes)."""
        ostate = self.optim_method.init_state(params)
        saved, self._resume_opt_state = self._resume_opt_state, None
        if saved is None:
            return ostate
        if set(saved) != set(ostate):
            raise ValueError(f"resumed optimizer state holds {sorted(saved)}"
                             f", {type(self.optim_method).__name__} holds "
                             f"{sorted(ostate)}")
        with torch.no_grad():
            for key, tensors in ostate.items():
                if not isinstance(tensors, dict):
                    src = torch.as_tensor(saved[key])
                    if src.numel() == tensors.numel() == 1:
                        # the reference's writer stores a 0-d leaf as (1,)
                        src = src.reshape(tensors.shape)
                    if src.shape != tensors.shape:
                        raise ValueError(
                            f"resumed optimizer state {key!r} has shape "
                            f"{tuple(src.shape)}, this run's "
                            f"{tuple(tensors.shape)}")
                    tensors.copy_(src)
                    continue
                got = split_tensors(net, from_jax_tree(net, saved[key],
                                                       "params"))
                if set(got) != set(tensors):
                    raise ValueError(f"resumed optimizer state {key!r} "
                                     f"does not cover the parameters")
                for name, t in tensors.items():
                    src = torch.as_tensor(got[name])
                    if src.shape != t.shape:
                        raise ValueError(f"resumed optimizer state "
                                         f"{key!r}[{name!r}] has shape "
                                         f"{tuple(src.shape)}, the "
                                         f"parameter {tuple(t.shape)}")
                    t.copy_(src)
        return ostate

    def _validate_resume_schema(self, params_tree) -> None:
        """The restored snapshot's schema against this run's; an elastic
        run tolerates world-size and bucket-padding drift."""
        saved, self._resume_schema = self._resume_schema, None
        if saved is not None:
            validate_schema(saved, self._checkpoint_schema(params_tree),
                            elastic=self._membership is not None)

    def _trees(self, run: _Run):
        """(params, buffers, optimizer state) of ``run`` in the
        reference's layout: a state entry keyed by parameter name as the
        parameters' tree, any other (LBFGS's flat history and counters)
        as it is."""
        net = run.net
        params = jax_tree(net, logical_tensors(
            net, {k: p.detach() for k, p in run.params.items()}), "params")
        state = jax_tree(net, dict(net.named_buffers()), "state")
        ostate = {k: jax_tree(net, logical_tensors(net, v), "params")
                  if isinstance(v, dict) else v
                  for k, v in run.ostate.items()}
        return params, state, ostate

    def _maybe_checkpoint(self, run: _Run) -> None:
        if self.checkpoint_trigger and self.checkpoint_path \
                and self.checkpoint_trigger(self.state):
            with self._tel_span("checkpoint", "trigger",
                                neval=self.state["neval"]):
                self._do_checkpoint(run)

    # replay-boundary: called at block edges, after the loss fetch
    def _do_checkpoint(self, run: _Run, sync: bool = False) -> None:
        """Snapshot the whole training state at the current replayed
        iteration (a copy to the host, then the commit on the writer)."""
        trees = self._trees(run)
        # spmdcheck: every process captures at the same iteration
        spmdcheck.note("checkpoint", payload=trees[0])
        self._save_trees(*trees, sync=sync)

    def _save_trees(self, params, mstate, ostate, sync: bool) -> None:
        run_state = {"seed": self._resolved_seed(),
                     "dataset_position": self.dataset.position_state()}
        self._checkpoint_manager().save(
            self.state["neval"], params, mstate, ostate,
            driver_state=dict(self.state), run_state=run_state,
            schema=self._checkpoint_schema(params), sync=sync)

    def _run_validation(self, run: _Run) -> Optional[dict]:
        if not (self.validation_trigger and self.validation_methods
                and self.validation_dataset is not None
                and self.validation_trigger(self.state)):
            return None
        with self._tel_span("validation", "trigger",
                            neval=self.state["neval"]):
            results = self.evaluate_with(run.net)
        for name, res in results.items():
            logger.info("validation %s = %s", name, res)
            if self.validation_summary is not None \
                    and self._writes_summaries():
                self.validation_summary.add_scalar(name, res.result,
                                                   self.state["neval"])
        # the first method's score feeds triggers and, once per
        # validation, a metric-driven schedule (Plateau)
        first = next(iter(results.values()))
        self.state["score"] = first.result
        sched = self.optim_method.learning_rate_schedule
        if sched is not None and hasattr(sched, "record"):
            sched.record(first.result)
        return results

    def evaluate_with(self, net: torch.nn.Module) -> dict:
        """The validation set through ``net`` in eval mode under
        ``torch.no_grad()``: ``{method name: ValidationResult}``.  Each
        method's sum stays on the card in f64 until the pass ends
        (:func:`~bigdl_tpu_torch.optim.validation.validation_sums`, the
        loop ``Evaluator`` runs too)."""
        sums, counts = validation_sums(net, self.validation_dataset,
                                       self.validation_methods)
        sums, counts = self._reduce_validation(sums, counts)
        if not sums:
            raise ValueError(
                "validation dataset yielded no batches — its size is "
                "smaller than the batch size and SampleToMiniBatch dropped "
                "the remainder; use SampleToMiniBatch(n, "
                "drop_remainder=False) for validation or shrink the batch")
        return {k: ValidationResult(float(v), counts[k])
                for k, v in sums.items()}

    def _reduce_validation(self, sums: dict, counts: dict):
        """The validation sums and counts of the whole job (this process's
        alone here)."""
        return sums, counts

    # ------------------------------------------------------ training copy
    def _placed_copy(self, device) -> torch.nn.Module:
        """A copy of the model on ``device``."""
        return copy.deepcopy(self.model).to(device)

    def _training_copy(self, device):
        """The run's training copy of the model on ``device``: (net, its
        parameters by name, requiring gradients, and its stochastic layers,
        each drawing from a generator of its own)."""
        net = self._placed_copy(device).train()
        stochastic = [m for m in walk(net) if isinstance(m, Stochastic)]
        for m in stochastic:
            m.generator = torch.Generator(device=device)
        params = dict(net.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return net, params, stochastic

    def _loss_fn(self, net, params: Tensors, device):
        """``loss_fn(x, y)`` of the training copy: the criterion's loss in
        the compute dtype plus the regularizers' penalties (f32, on the
        parameters), under the activation-memory policy."""
        criterion = self.criterion
        policy = self._resolved_activation_memory(device)
        compute_dtype = self.compute_dtype
        if policy.startswith("bf16"):
            if compute_dtype not in (None, torch.bfloat16):
                raise ValueError(
                    f"activation memory policy {policy!r} conflicts with "
                    f"set_compute_dtype({compute_dtype}): bf16 activation "
                    f"storage is bf16 compute; drop one of the two")
            compute_dtype = torch.bfloat16
        if compute_dtype in (None, torch.float32):
            loss_fn = lambda x, y: criterion.apply(net(x), y)  # noqa: E731
        else:
            mixed = mixed_precision_loss_fn(net, criterion, compute_dtype)
            loss_fn = lambda x, y: mixed(params, x, y)  # noqa: E731
        if has_regularizers(net):
            base = loss_fn
            loss_fn = lambda x, y: (base(x, y)  # noqa: E731
                                    + regularization_loss(net, params))
        if policy.endswith(("dots", "full")):
            loss_fn = checkpointed(loss_fn, net, "dots"
                                   if policy.endswith("dots") else None)
        return loss_fn

    def _check_rollback(self) -> None:
        if self._guard_policy == "rollback" and not self.checkpoint_path:
            raise ValueError(
                "numeric_guard='rollback' needs set_checkpoint(path, "
                "trigger) — there is no snapshot to roll back to")

    def _write_back(self, net) -> None:
        """The trained weights and buffers into the user's model."""
        with torch.no_grad():
            trained = logical_parameters(net)
            for k, p in self.model.named_parameters():
                p.copy_(trained[k])
            trained = dict(net.named_buffers())
            for k, b in self.model.named_buffers():
                b.copy_(trained[k])

    # ------------------------------------------------------ driver loop
    def _block(self, step_fn, staged: StagedBlock, lrs: List[float],
               first_step: int) -> torch.Tensor:
        """Enqueue one block's steps; returns their losses, still on the
        card, as one (k,) tensor, or under a numeric guard one (2, k)
        tensor: the losses and the steps' finite flags (1.0 / 0.0)."""
        staged.wait()
        outs = [step_fn(*staged.step(j), lrs[j], first_step + j)
                for j in range(len(staged.sizes))]
        if isinstance(outs[0], tuple):
            return torch.stack([torch.stack([o[0].float() for o in outs]),
                                torch.stack([o[1].float() for o in outs])])
        return torch.stack(outs)

    def _setup_telemetry(self, device) -> Optional[DriverTelemetry]:
        """This run's telemetry bundle (None when off), the flight
        recorder (None unless configured) and the admin plane's
        registration (none unless ``Config.admin_port``)."""
        cfg = get_config()
        tel_on = (self.telemetry_enabled if self.telemetry_enabled
                  is not None else cfg.telemetry_enabled)
        self._flight = flight.from_config()
        tel = None
        if tel_on:
            tel = DriverTelemetry(
                registry=self.metrics.registry,
                trace_capacity=cfg.telemetry_trace_capacity,
                trace_path=(self.telemetry_trace_path
                            or cfg.telemetry_trace_path or None),
                flight=self._flight, device=device)
        # an earlier enabled run's bundle must not keep recording
        self._telemetry = tel
        srv = admin.maybe_start()
        if srv is not None:
            if self._admin_name is None:
                self._admin_name = srv.unique_source_name("driver")
            srv.add_registry(self._admin_name, self.metrics.registry)
            if tel is not None:
                srv.add_tracer(self._admin_name, tel.tracer)
                srv.add_health(self._admin_name, tel.health_snapshot)
            else:
                # a telemetry-off rerun must not serve the previous
                # run's trace and verdicts as current
                srv.drop_tracer(self._admin_name)
                srv.drop_health(self._admin_name)
            if self._flight is not None:
                srv.set_flight(self._flight)
        return tel

    def _setup_faults(self) -> Optional[FaultInjector]:
        """The fault injector of ``Config.fault_plan`` (None without a
        plan).  Built once per (optimizer, plan): a plan is one timeline
        of the outside world, so its firing budgets survive the rollback
        and retry loops re-entering the driver."""
        plan = get_config().fault_plan or ""
        if self._fault_injector is not None \
                and self._fault_injector.plan != plan:
            self._fault_injector = None
        if self._fault_injector is None and plan:
            self._fault_injector = FaultInjector.from_config(
                registry=self.metrics.registry)
            logger.warning("fault injection live: %s",
                           self._fault_injector.describe())
        return self._fault_injector

    def _train_driver(self, step_fn, device, run: _Run) -> None:
        state = self.state
        k_max = self._steps_per_block(device)
        tel = self._setup_telemetry(device)
        faults = self._setup_faults()
        # elastic membership: armed only by membership clauses or
        # set_elastic(); otherwise None and every site below is inert
        self._arm_membership_from_plan(faults)
        membership = self._membership
        if membership is not None and not self.checkpoint_path:
            raise ValueError(
                "elastic training (membership fault kinds / "
                "set_elastic) needs set_checkpoint(path, trigger) — a "
                "resize resumes from the latest valid snapshot")
        # the epoch this run dispatches under, compared with the live one
        # at the replay boundary the loop already crosses
        run_epoch = membership.epoch() if membership is not None else 0
        # a previous run's preempted verdict must not leak into this one
        state.pop("preempted", None)
        mgr: Optional[CheckpointManager] = None
        if self.checkpoint_path:
            mgr = self._checkpoint_manager()
            mgr.mark_run_start()
            # this run's recorder and trace id on its commit events
            mgr.flight = self._flight
            mgr.trace_id = tel.trace_id if tel is not None else None
        epoch_size = self._epoch_size = self.dataset.size()
        data_iter = self.dataset.data(train=True)
        # records count the job's global batches; this process reads its
        # local share of them
        scale = max(1, self._records_scale())
        rec = state.get("records_processed_this_epoch", 0)
        if rec % scale:
            raise ValueError(
                f"mid-epoch resume: the snapshot's records counter ({rec}) "
                f"does not divide by this run's {scale} processes")
        if fast_forward_records(data_iter, rec // scale):
            logger.info("resume: skipped %d already-processed records", rec)
        stager = self._stager = DeviceBlockStager(
            data_iter, device, tracer=tel.tracer if tel else None)
        if self._resize_t0 is not None:
            # the elastic resume: detection to staging again is the
            # resize's downtime
            downtime = time.monotonic() - self._resize_t0
            self._resize_t0 = None
            self.metrics.registry.histogram(
                "resilience/resize_downtime_s").observe(downtime)
            self._flight_event("resize_resumed",
                               downtime_s=round(downtime, 4),
                               iteration=state["neval"], epoch=run_epoch)
        param_trig = self.train_summary.trigger_for("Parameters") \
            if hasattr(self.train_summary, "trigger_for") else None
        triggers = (self.validation_trigger, self.checkpoint_trigger,
                    self.end_when, param_trig)
        self._dispatch_count = 0
        bsz_hint = 0
        # where the driver state will be once every enqueued block has
        # been replayed (at most one block ahead)
        p_neval, p_epoch = state["neval"], state["epoch"]
        p_records = state["records_processed_this_epoch"]

        def stage_next():
            nonlocal bsz_hint
            t_stage0 = time.perf_counter()
            probe_state = dict(state, neval=p_neval, epoch=p_epoch,
                               records_processed_this_epoch=p_records)
            fire = probe_fire_step(probe_state, k_max, bsz_hint * scale,
                                   epoch_size, triggers)
            k_plan = fire if fire is not None else k_max
            with self.metrics.time("data"):
                staged = stager.take(
                    k_plan, max(1, -(-(epoch_size - p_records) // scale)))
            self._note_staged(staged)
            k = len(staged.sizes)
            if faults is not None:
                # the batch-poison fault site, keyed by global iteration,
                # after the block's copy has landed
                staged.wait()
                faults.corrupt_staged(staged.xs, p_neval, k)
            bsz_hint = staged.sizes[0]
            lrs = [float(self.optim_method.current_lr(p_neval + j, p_epoch))
                   for j in range(k)]
            sync = p_records + sum(staged.sizes) * scale >= epoch_size \
                or fire == k
            return staged, lrs, sync, time.perf_counter() - t_stage0

        pending: Optional[_InFlight] = None
        staged = None
        # installed last, right before the try whose finally removes it
        preempt = None
        if self.preemption_handling and mgr is not None:
            preempt = self._preemption = PreemptionHandler()
            preempt.install()
        try:
            while True:
                if preempt is not None and preempt.triggered:
                    # finish the block in flight (the replay syncs it),
                    # write one last synchronous snapshot, return; the
                    # staged block is dropped, and a resume re-derives
                    # its batches from the shuffle position and counter
                    if pending is not None:
                        self._replay_block(pending, run)
                        pending = None
                    logger.warning("preemption signal: final snapshot at "
                                   "iteration %d, exiting cleanly",
                                   state["neval"])
                    self._flight_event("preemption",
                                       iteration=state["neval"])
                    mgr.wait()  # writer idle before the last save
                    if mgr.last_saved_step != state["neval"]:
                        self._do_checkpoint(run, sync=True)
                    state["preempted"] = True
                    break
                if membership is not None:
                    changed = membership.changed_since(run_epoch)
                    if changed is not None:
                        # graceful: replay the block in flight and write
                        # a last synchronous snapshot (no step lost);
                        # abrupt: abandon it, the resume pays the steps
                        # since the latest snapshot.  The staged block
                        # is dropped either way.
                        t_detect = time.monotonic()
                        if changed.graceful:
                            if pending is not None:
                                self._replay_block(pending, run)
                                pending = None
                            mgr.wait()
                            if mgr.last_saved_step != state["neval"]:
                                self._do_checkpoint(run, sync=True)
                        else:
                            pending = None
                        logger.warning(
                            "membership epoch %d (world %d, %s): "
                            "suspending at iteration %d for elastic "
                            "resume", changed.epoch, changed.world,
                            changed.reason, state["neval"])
                        self._flight_event(
                            "membership_change", epoch=changed.epoch,
                            world=changed.world, reason=changed.reason,
                            graceful=changed.graceful,
                            iteration=state["neval"])
                        raise MembershipChanged(
                            changed, changed.graceful, state["neval"],
                            t_detect)
                if staged is None:
                    if pending is None and self.end_when(state):
                        break
                    staged = stage_next()
                block_in, lrs, sync, stage_s = staged
                k = len(block_in.sizes)
                # spmdcheck: every process enqueues the same block shape
                # in the same order, or the steps' collectives go
                # one-sided
                spmdcheck.note("dispatch", axis=f"k{k}", payload=block_in.xs)
                t0 = time.perf_counter()
                with self._tel_span("dispatch", "dispatch", k=k):
                    if faults is None:
                        losses = self._block(step_fn, block_in, lrs, p_neval)
                    else:
                        losses = self._dispatch_with_retry(
                            lambda: self._block(step_fn, block_in, lrs,
                                                p_neval),
                            self._dispatch_count)
                if tel is not None:
                    # silent on the eager step: it compiles nothing
                    tel.recompile.observe(("block_fn", k),
                                          jit_cache_size(step_fn))
                self._dispatch_count += 1
                block = _InFlight(losses, block_in.sizes, lrs, t0,
                                  stage_s=stage_s,
                                  dispatch_s=time.perf_counter() - t0)
                p_neval += k
                p_records += sum(block_in.sizes) * scale
                if p_records >= epoch_size:
                    p_epoch += 1
                    p_records = 0
                # double buffer: the next block's copy lands while this
                # one runs; a sync block ends at a boundary the replay
                # handles (shuffle, validation, snapshot, stop) before
                # anything more is staged
                staged = stage_next() if not sync else None
                if pending is not None:
                    ended = self._replay_block(pending, run)
                    pending = None
                    if ended:
                        break
                if sync:
                    if self._replay_block(block, run):
                        break
                else:
                    pending = block
        finally:
            exc = sys.exc_info()[0]
            run_failing = exc is not None
            if run_failing and not issubclass(exc, MembershipChanged):
                # on disk even if nothing below gets to run; a membership
                # change is a measured event, recorded above
                self._flight_event("run_crash", error=exc.__name__,
                                   iteration=state["neval"])
            if preempt is not None:
                preempt.uninstall()
            if tel is not None:
                # the trace of an interrupted run too
                tel.finalize()
            if mgr is not None:
                # optimize() returning means the snapshots exist; a
                # deferred write error fails the run unless it is failing
                # already
                try:
                    mgr.wait()
                except Exception:
                    if not run_failing:
                        raise
                    logger.exception("async checkpoint write also failed "
                                     "while an already-failing run ended")

    def _writes_summaries(self) -> bool:
        """Whether this process writes the train and validation
        summaries (a data-parallel job's process 0 alone)."""
        return True

    def _log_parameter_histograms(self, run: _Run) -> None:
        """The trigger-gated "Parameters" histograms (none here: the
        reference's LocalOptimizer writes none)."""

    def _log_train_iteration(self, lr: float) -> None:
        s = self.state
        logger.info("epoch %d iter %d loss %.4f lr %.5g throughput %.1f "
                    "rec/s", s["epoch"], s["neval"], s["loss"], lr,
                    s["throughput"])

    def _on_nonfinite_step(self, loss: float) -> None:
        """A replayed iteration carried a non-finite loss or gradient.
        ``skip``: its update was dropped on the card, count it; else
        raise at that 0-based iteration (the index fault plans and lr
        schedules see)."""
        policy = self._guard_policy
        step = self.state["neval"] - 1
        reg = self.metrics.registry
        reg.counter("resilience/nonfinite_steps").inc()
        if policy == "skip":
            reg.counter("resilience/steps_skipped").inc()
            if self._telemetry is not None:
                self._telemetry.tracer.instant(
                    "nonfinite_step_skipped", cat="resilience", step=step)
            self._flight_event("nonfinite_step", step=step, policy="skip",
                               loss=loss)
            logger.warning("non-finite step at iteration %d (loss=%s) — "
                           "update skipped on the card", step, loss)
            return
        self._flight_event("nonfinite_step", step=step, policy=policy,
                           loss=loss)
        raise NonFiniteStepError(step, loss, policy)

    # replay-boundary: the failed block is torn down before the restore
    def _rollback_nonfinite(self, e: NonFiniteStepError, attempts: int,
                            retry_budget: int) -> None:
        """``rollback``: restore the latest valid snapshot, or raise
        ``e`` (another policy, the budget spent, no snapshot)."""
        if e.policy != "rollback" or attempts > retry_budget \
                or not self.checkpoint_path:
            raise e
        mgr = self._checkpoint_manager()
        mgr.wait()  # writer idle: every committed snapshot is visible
        ckpt = mgr.latest_valid()
        if ckpt is None:
            raise e
        self.metrics.registry.counter("resilience/rollbacks").inc()
        if self._telemetry is not None:
            self._telemetry.tracer.instant(
                "rollback", cat="resilience", step=e.step, ckpt=ckpt)
        self._flight_event("rollback", step=e.step, ckpt=ckpt,
                           attempt=attempts)
        logger.warning("non-finite step at iteration %d; rollback %d/%d "
                       "from %s", e.step, attempts, retry_budget, ckpt)
        mgr.restore_into(self, ckpt, verified=True)

    def _dispatch_with_retry(self, fire, index: int):
        """Bounded retry with backoff around one block's enqueue, reached
        only with a live fault plan.  The injector raises before
        ``fire()`` runs, so a retried attempt starts from the same
        parameters; ``InjectedFault`` is transient by construction."""
        retries = get_config().failure_retry_times
        faults = self._fault_injector
        attempt = 0
        while True:
            try:
                faults.driver_dispatch(index)
                return fire()
            except InjectedFault:
                attempt += 1
                self.metrics.registry.counter(
                    "resilience/dispatch_retries").inc()
                if attempt > retries:
                    raise
                backoff = min(0.01 * (2.0 ** (attempt - 1)), 1.0)
                logger.warning(
                    "transient dispatch failure at dispatch %d; retry "
                    "%d/%d in %.0f ms", index, attempt, retries,
                    backoff * 1e3)
                time.sleep(backoff)

    def _replay_block(self, block: _InFlight, run: _Run) -> bool:
        """Copy a block's losses (and, under a numeric guard, its finite
        flags) to the host, the driver's one sync, and advance the driver
        state through its iterations: summaries, epoch rollover,
        validation and checkpoint triggers at their exact iterations, the
        stop condition.  True when training should stop."""
        tel = self._telemetry
        t_wait0 = time.perf_counter()
        # spmdcheck: every process fetches the block that produced it
        spmdcheck.note("block_fetch", payload=block.losses)
        with self.metrics.time("computing"), \
                self._tel_span("device_wait", "device_wait",
                               steps=len(block.sizes)):
            # the driver's one device-to-host sync: the span wraps the
            # fetch the driver makes anyway, it adds none
            fetched = block.losses.tolist()
        t_wait1 = time.perf_counter()
        losses, finite = (fetched if block.losses.dim() == 2
                          else (fetched, None))
        if tel is not None:
            # the block's in-flight window (enqueue to losses landed) on
            # a "device" track beside the host's spans
            tel.tracer.record("block_inflight", int(block.t0 * 1e9),
                              int(t_wait1 * 1e9), cat="pipeline",
                              track="device", steps=len(block.sizes))
        per_step = (time.perf_counter() - block.t0) / len(block.sizes)
        state = self.state
        scale = self._records_scale()
        ended = False
        t_replay0 = time.perf_counter()
        with self._tel_span("replay", "replay", steps=len(block.sizes)):
            for j, n_local in enumerate(block.sizes):
                n = n_local * scale
                state["neval"] += 1
                state["records_processed_this_epoch"] += n
                state["loss"] = float(losses[j])
                state["throughput"] = n / per_step
                if finite is not None and not finite[j]:
                    self._on_nonfinite_step(state["loss"])
                self._log_train_iteration(block.lrs[j])
                if self.train_summary is not None:
                    if self._writes_summaries():
                        self.train_summary.add_train_step(
                            state["neval"], state["loss"], block.lrs[j],
                            state["throughput"])
                    self._log_parameter_histograms(run)
                state["epoch_finished"] = \
                    state["records_processed_this_epoch"] >= self._epoch_size
                if state["epoch_finished"]:
                    state["epoch"] += 1
                    state["records_processed_this_epoch"] = 0
                    self.dataset.shuffle()
                    self._stager.reset(self.dataset.data(train=True))
                self._run_validation(run)
                self._maybe_checkpoint(run)
                state["epoch_finished"] = False
                if self._fault_injector is not None \
                        and self._membership is not None:
                    # the membership fault site, keyed by the 0-based
                    # global iteration; the loop sees the new epoch at
                    # its next replay boundary
                    for clause in self._fault_injector.membership_events(
                            state["neval"] - 1):
                        self._apply_membership_clause(clause)
                if self.end_when(state):
                    ended = True
                    break
        if tel is not None:
            tel.stalls.record_block(block.stage_s, block.dispatch_s,
                                    t_wait1 - t_wait0,
                                    time.perf_counter() - t_replay0)
            tel.memory.observe()
            self._mirror_telemetry_scalars(tel)
        return ended

    def _mirror_telemetry_scalars(self, tel) -> None:
        """The driver's gauges (phase fractions, memory watermarks) into
        the train summary, one scalar a gauge a replayed block."""
        summary = self.train_summary
        add = getattr(summary, "add_scalar", None) if summary else None
        if add is None or not self._writes_summaries():
            return
        step = self.state["neval"]
        for name, val in tel.registry.gauges().items():
            add(f"Telemetry/{name}", float(val), step)


class LocalOptimizer(Optimizer):
    """Single-card training loop on ``device`` ("cuda" by default; "cpu"
    only when asked).  The model's own weights are the starting point:
    draw them first with ``model.initialize(seed)``."""

    def __init__(self, model, dataset, criterion, device="cuda"):
        super().__init__(model, dataset, criterion)
        self.device = resolve_device(device)

    def optimize(self) -> torch.nn.Module:
        attempts = 0
        while True:
            try:
                return self._optimize_impl()
            except NonFiniteStepError as e:
                # rollback: restore the latest valid snapshot and run
                # again, at most failure_retry_times times; abort (and a
                # spent budget) reaches the caller at the exact iteration
                attempts += 1
                self._rollback_nonfinite(e, attempts,
                                         get_config().failure_retry_times)

    def _optimize_impl(self) -> torch.nn.Module:
        device = self.device
        guard = self._guard_policy = self._resolved_numeric_guard()
        self._check_rollback()
        seed = self._resolved_seed()
        net, params, stochastic = self._training_copy(device)
        self._validate_resume_schema(jax_tree(net, params, "params"))
        ostate = self._restored_opt_state(net, params)
        buffers = dict(net.named_buffers())
        optim, clip = self.optim_method, self.grad_clip
        loss_fn = self._loss_fn(net, params, device)

        def step_fn(x, y, lr, step):
            for i, m in enumerate(stochastic):
                m.generator.manual_seed(stream_seed(seed, i, step))
            for p in params.values():
                p.grad = None
            if guard == "skip":
                # the pre-step values, selected back where the step is
                # not finite (buffers: BatchNorm's running statistics)
                before = [(t, t.detach().clone()) for t in
                          [*params.values(), *buffers.values(),
                           *state_leaves(ostate)]]
            loss = loss_fn(x, y)
            loss.backward()
            # a parameter the step did not reach (a Cond's other branch)
            # has no gradient: the reference's zero
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in params.items()}
            if clip is not None:
                grads = clip(grads)
            if guard == "off":
                optim.update(grads, params, ostate, lr, step)
                return loss.detach()
            finite = step_finite(loss.detach(), grads)
            optim.update(grads, params, ostate, lr, step)
            if guard == "skip":
                with torch.no_grad():
                    for t, old in before:
                        t.copy_(select_step(finite, t, old))
            return loss.detach(), finite

        logger.info("LocalOptimizer: %d samples/epoch, device=%s",
                    self.dataset.size(), device)
        self._train_driver(step_fn, device, _Run(net, params, ostate))
        self._write_back(net)
        return self.model

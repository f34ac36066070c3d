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
that iteration's parameters.  Dropout and RReLU draw from generators
seeded by (run seed, layer, iteration), so a resumed run draws what the
uninterrupted one drew.

``Optimizer.create(..., distributed=True)`` builds the data-parallel
``DistriOptimizer`` (``optim/distri_optimizer.py``), which overrides the
driver's hooks: ``_records_scale`` (the global batch is the world's local
batches), the step, the snapshot and the validation's reduction.

Not ported yet, each raising ``NotImplementedError`` where the reference
has the API: telemetry, activation-memory policies and compute dtypes
other than f32 and bf16.
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
                                              fast_forward_records, tree_map)
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.engine import Engine, resolve_device
from bigdl_tpu_torch.interop.jax_weights import (from_jax_tree, jax_tree,
                                                 load_jax_params)
from bigdl_tpu_torch.nn.activations import RReLU
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.layers import Dropout
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch, probe_fire_step
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.resilience.numeric import (NonFiniteStepError,
                                                validate_policy)
from bigdl_tpu_torch.telemetry.registry import MetricRegistry
from bigdl_tpu_torch.utils.config import get_config
from bigdl_tpu_torch.utils.precision import mixed_precision_loss_fn

logger = logging.getLogger("bigdl_tpu_torch.optim")

Tensors = Dict[str, torch.Tensor]


def clip_by_value(grads: Tensors, min_v: float, max_v: float) -> Tensors:
    return {k: torch.clamp(g, min_v, max_v) for k, g in grads.items()}


def global_norm(grads: Tensors) -> torch.Tensor:
    """L2 norm over every gradient, as a 0-d tensor on their device."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tensors:
    """Scale every gradient by ``min(1, max_norm / norm)``; no host sync."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def step_finite(loss, grads: Tensors) -> torch.Tensor:
    """0-d bool on the card: the loss and every floating gradient are
    finite.  Computed inside the step, so the flag rides the loss fetch."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads.values()
              if g.is_floating_point()]
    return torch.stack(flags).all()


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

    __slots__ = ("losses", "sizes", "lrs", "t0")

    def __init__(self, losses, sizes, lrs, t0):
        self.losses, self.sizes, self.lrs, self.t0 = losses, sizes, lrs, t0


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
        # checkpoint, numeric-guard and validation counters
        self.registry = MetricRegistry()
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
        self.state: dict = {"epoch": 0, "neval": 0,
                            "records_processed_this_epoch": 0}
        self._stager: Optional[DeviceBlockStager] = None
        self._epoch_size = 0
        self._dispatch_count = 0  # blocks enqueued by the last run

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

    def set_telemetry(self, *a, **kw):
        _not_ported("telemetry (set_telemetry)")

    def set_numeric_guard(self, policy: Optional[str]) -> "Optimizer":
        """Non-finite loss/gradient policy for this run (overrides
        ``Config.numeric_guard``): ``None``/``"off"``, ``"skip"``,
        ``"rollback"`` (needs ``set_checkpoint``) or ``"abort"``; see
        ``resilience/numeric.py``.  No policy adds a host sync."""
        self.numeric_guard = "off" if policy is None \
            else validate_policy(policy)
        return self

    def set_activation_memory(self, *a, **kw):
        _not_ported("activation-memory policies (set_activation_memory)")

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "Optimizer":
        """Mixed precision: forward and backward in ``dtype`` (bf16 for
        the tensor cores); parameters, gradients, optimizer state and the
        update stay f32.  ``None`` and ``torch.float32`` compute in f32."""
        if dtype not in (None, torch.float32, torch.bfloat16):
            _not_ported(f"compute dtype {dtype} (set_compute_dtype takes "
                        f"None, torch.float32 or torch.bfloat16)")
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
                registry=self.registry)
        return self._ckpt_manager

    def _records_scale(self) -> int:
        """Local batch rows -> global records (the world size under
        ``DistriOptimizer``)."""
        return 1

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
                got = from_jax_tree(net, saved[key], "params")
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
        saved, self._resume_schema = self._resume_schema, None
        if saved is not None:
            validate_schema(saved, self._checkpoint_schema(params_tree))

    def _trees(self, run: _Run):
        """(params, buffers, optimizer state) of ``run`` in the
        reference's layout."""
        net = run.net
        params = jax_tree(net, {k: p.detach()
                                for k, p in run.params.items()}, "params")
        state = jax_tree(net, dict(net.named_buffers()), "state")
        ostate = {k: jax_tree(net, v, "params")
                  for k, v in run.ostate.items()}
        return params, state, ostate

    def _maybe_checkpoint(self, run: _Run) -> None:
        if self.checkpoint_trigger and self.checkpoint_path \
                and self.checkpoint_trigger(self.state):
            self._do_checkpoint(run)

    # replay-boundary: called at block edges, after the loss fetch
    def _do_checkpoint(self, run: _Run, sync: bool = False) -> None:
        """Snapshot the whole training state at the current replayed
        iteration (a copy to the host, then the commit on the writer)."""
        self._save_trees(*self._trees(run), sync=sync)

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
        method's sum stays on the card in f64 until the pass ends."""
        device = next(net.parameters()).device
        to_dev = lambda a: (a if isinstance(a, torch.Tensor)  # noqa: E731
                            else torch.from_numpy(np.asarray(a))).to(device)
        sums: dict = {}
        counts: dict = {}
        was_training = net.training
        net.eval()
        try:
            with torch.no_grad():
                for batch in self.validation_dataset.data(train=False):
                    if not isinstance(batch, MiniBatch):
                        raise TypeError("validation dataset must yield "
                                        "MiniBatch (attach "
                                        "SampleToMiniBatch)")
                    out = net(tree_map(to_dev, batch.input))
                    tgt = tree_map(to_dev, batch.target)
                    for m in self.validation_methods:
                        v, c = m.batch_stats(out, tgt)
                        v = torch.as_tensor(v, device=device).double()
                        sums[m.name] = sums[m.name] + v \
                            if m.name in sums else v
                        counts[m.name] = counts.get(m.name, 0) + c
        finally:
            net.train(was_training)
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
    def _training_copy(self, device):
        """The run's training copy of the model on ``device``: (net, its
        parameters by name, requiring gradients, and its stochastic layers,
        each drawing from a generator of its own)."""
        net = copy.deepcopy(self.model).to(device).train()
        stochastic = [m for m in net.modules()
                      if isinstance(m, (Dropout, RReLU))]
        for m in stochastic:
            m.generator = torch.Generator(device=device)
        params = dict(net.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        return net, params, stochastic

    def _loss_fn(self, net, params: Tensors):
        """``loss_fn(x, y)`` of the training copy in the compute dtype."""
        criterion = self.criterion
        if self.compute_dtype in (None, torch.float32):
            return lambda x, y: criterion.apply(net(x), y)
        mixed = mixed_precision_loss_fn(net, criterion, self.compute_dtype)
        return lambda x, y: mixed(params, x, y)

    def _check_rollback(self) -> None:
        if self._guard_policy == "rollback" and not self.checkpoint_path:
            raise ValueError(
                "numeric_guard='rollback' needs set_checkpoint(path, "
                "trigger) — there is no snapshot to roll back to")

    def _write_back(self, net) -> None:
        """The trained weights and buffers into the user's model."""
        with torch.no_grad():
            trained = dict(net.named_parameters())
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

    def _train_driver(self, step_fn, device, run: _Run) -> None:
        state = self.state
        k_max = self.steps_per_dispatch or Engine.steps_per_dispatch()
        # a previous run's preempted verdict must not leak into this one
        state.pop("preempted", None)
        mgr: Optional[CheckpointManager] = None
        if self.checkpoint_path:
            mgr = self._checkpoint_manager()
            mgr.mark_run_start()
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
        stager = self._stager = DeviceBlockStager(data_iter, device)
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
            probe_state = dict(state, neval=p_neval, epoch=p_epoch,
                               records_processed_this_epoch=p_records)
            fire = probe_fire_step(probe_state, k_max, bsz_hint * scale,
                                   epoch_size, triggers)
            k_plan = fire if fire is not None else k_max
            staged = stager.take(k_plan,
                                 max(1, -(-(epoch_size - p_records) // scale)))
            k = len(staged.sizes)
            bsz_hint = staged.sizes[0]
            lrs = [float(self.optim_method.current_lr(p_neval + j, p_epoch))
                   for j in range(k)]
            sync = p_records + sum(staged.sizes) * scale >= epoch_size \
                or fire == k
            return staged, lrs, sync

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
                    mgr.wait()  # writer idle before the last save
                    if mgr.last_saved_step != state["neval"]:
                        self._do_checkpoint(run, sync=True)
                    state["preempted"] = True
                    break
                if staged is None:
                    if pending is None and self.end_when(state):
                        break
                    staged = stage_next()
                block_in, lrs, sync = staged
                t0 = time.perf_counter()
                losses = self._block(step_fn, block_in, lrs, p_neval)
                self._dispatch_count += 1
                block = _InFlight(losses, block_in.sizes, lrs, t0)
                p_neval += len(block_in.sizes)
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
            run_failing = sys.exc_info()[0] is not None
            if preempt is not None:
                preempt.uninstall()
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
        raise at that 0-based iteration."""
        policy = self._guard_policy
        step = self.state["neval"] - 1
        self.registry.counter("resilience/nonfinite_steps").inc()
        if policy == "skip":
            self.registry.counter("resilience/steps_skipped").inc()
            logger.warning("non-finite step at iteration %d (loss=%s) — "
                           "update skipped on the card", step, loss)
            return
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
        self.registry.counter("resilience/rollbacks").inc()
        logger.warning("non-finite step at iteration %d; rollback %d/%d "
                       "from %s", e.step, attempts, retry_budget, ckpt)
        mgr.restore_into(self, ckpt, verified=True)

    def _replay_block(self, block: _InFlight, run: _Run) -> bool:
        """Copy a block's losses (and, under a numeric guard, its finite
        flags) to the host, the driver's one sync, and advance the driver
        state through its iterations: summaries, epoch rollover,
        validation and checkpoint triggers at their exact iterations, the
        stop condition.  True when training should stop."""
        fetched = block.losses.tolist()
        losses, finite = (fetched if block.losses.dim() == 2
                          else (fetched, None))
        per_step = (time.perf_counter() - block.t0) / len(block.sizes)
        state = self.state
        scale = self._records_scale()
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
            if self.end_when(state):
                return True
        return False


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
        loss_fn = self._loss_fn(net, params)

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
                           *(v for d in ostate.values()
                             for v in d.values())]]
            loss = loss_fn(x, y)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
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
                        t.copy_(torch.where(finite, t, old))
            return loss.detach(), finite

        logger.info("LocalOptimizer: %d samples/epoch, device=%s",
                    self.dataset.size(), device)
        self._train_driver(step_fn, device, _Run(net, params, ostate))
        self._write_back(net)
        return self.model

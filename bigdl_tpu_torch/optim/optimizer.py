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

Not ported yet, each raising ``NotImplementedError`` where the reference
has the API: validation, checkpointing and resume, summaries, telemetry,
the numeric guard, activation-memory policies, compute dtypes other than
f32 and bf16, and ``DistriOptimizer``.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Dict, List, Optional

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import DeviceBlockStager, StagedBlock
from bigdl_tpu_torch.engine import Engine, resolve_device
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.layers import Dropout
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch, probe_fire_step
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


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to bigdl_tpu_torch yet "
                              f"(ROADMAP queue A)")


class _InFlight:
    """An enqueued block whose per-step losses are still on the card."""

    __slots__ = ("losses", "sizes", "lrs", "t0")

    def __init__(self, losses, sizes, lrs, t0):
        self.losses, self.sizes, self.lrs, self.t0 = losses, sizes, lrs, t0


class Optimizer:
    """Builder and the driver loop."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = max_epoch(1)
        self.grad_clip: Optional[Callable[[Tensors], Tensors]] = None
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
        return self

    def set_gradient_clipping_by_l2_norm(self, max_norm: float) -> "Optimizer":
        self.grad_clip = lambda g: clip_by_global_norm(g, max_norm)
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip = None
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

    def set_validation(self, *a, **kw):
        _not_ported("validation (set_validation)")

    def set_checkpoint(self, *a, **kw):
        _not_ported("checkpointing (set_checkpoint)")

    def over_write_checkpoint(self, *a, **kw):
        _not_ported("checkpointing (over_write_checkpoint)")

    def set_preemption_handling(self, *a, **kw):
        _not_ported("checkpointing (set_preemption_handling)")

    def resume(self, *a, **kw):
        _not_ported("checkpointing (resume)")

    def set_train_summary(self, *a, **kw):
        _not_ported("summaries (set_train_summary)")

    def set_val_summary(self, *a, **kw):
        _not_ported("summaries (set_val_summary)")

    def set_telemetry(self, *a, **kw):
        _not_ported("telemetry (set_telemetry)")

    def set_numeric_guard(self, *a, **kw):
        _not_ported("the numeric guard (set_numeric_guard)")

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
        if distributed:
            _not_ported("DistriOptimizer")
        return LocalOptimizer(model, dataset, criterion, **kw)

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError

    # ------------------------------------------------------ driver loop
    def _block(self, step_fn, staged: StagedBlock, lrs: List[float],
               first_step: int) -> torch.Tensor:
        """Enqueue one block's steps; returns their losses, still on the
        card, as one (k,) tensor."""
        staged.wait()
        losses = [step_fn(*staged.step(j), lrs[j], first_step + j)
                  for j in range(len(staged.sizes))]
        return torch.stack(losses)

    def _train_driver(self, step_fn, device) -> None:
        state = self.state
        k_max = self.steps_per_dispatch or Engine.steps_per_dispatch()
        epoch_size = self._epoch_size = self.dataset.size()
        stager = self._stager = DeviceBlockStager(
            self.dataset.data(train=True), device)
        triggers = (self.end_when,)
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
            fire = probe_fire_step(probe_state, k_max, bsz_hint,
                                   epoch_size, triggers)
            k_plan = fire if fire is not None else k_max
            staged = stager.take(k_plan, max(1, epoch_size - p_records))
            k = len(staged.sizes)
            bsz_hint = staged.sizes[0]
            lrs = [float(self.optim_method.current_lr(p_neval + j, p_epoch))
                   for j in range(k)]
            sync = p_records + sum(staged.sizes) >= epoch_size or fire == k
            return staged, lrs, sync

        pending: Optional[_InFlight] = None
        staged = None
        while True:
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
            p_records += sum(block_in.sizes)
            if p_records >= epoch_size:
                p_epoch += 1
                p_records = 0
            # double buffer: the next block's copy lands while this one
            # runs; a sync block ends at a boundary the replay handles
            # (shuffle, stop) before anything more is staged
            staged = stage_next() if not sync else None
            if pending is not None:
                ended = self._replay_block(pending)
                pending = None
                if ended:
                    break
            if sync:
                if self._replay_block(block):
                    break
            else:
                pending = block

    def _log_train_iteration(self, lr: float) -> None:
        s = self.state
        logger.info("epoch %d iter %d loss %.4f lr %.5g throughput %.1f "
                    "rec/s", s["epoch"], s["neval"], s["loss"], lr,
                    s["throughput"])

    def _replay_block(self, block: _InFlight) -> bool:
        """Copy a block's losses to the host (the driver's one sync) and
        advance the driver state through its iterations; True when
        training should stop."""
        losses = block.losses.tolist()
        per_step = (time.perf_counter() - block.t0) / len(block.sizes)
        state = self.state
        for j, n in enumerate(block.sizes):
            state["neval"] += 1
            state["records_processed_this_epoch"] += n
            state["loss"] = float(losses[j])
            state["throughput"] = n / per_step
            self._log_train_iteration(block.lrs[j])
            state["epoch_finished"] = \
                state["records_processed_this_epoch"] >= self._epoch_size
            if state["epoch_finished"]:
                state["epoch"] += 1
                state["records_processed_this_epoch"] = 0
                self.dataset.shuffle()
                self._stager.reset(self.dataset.data(train=True))
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
        device = self.device
        seed = get_config().seed if self.seed is None else self.seed
        net = copy.deepcopy(self.model).to(device).train()
        for i, m in enumerate(x for x in net.modules()
                              if isinstance(x, Dropout)):
            m.generator = torch.Generator(device=device).manual_seed(
                seed * 1000 + i)
        params = dict(net.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        ostate = self.optim_method.init_state(params)
        criterion, optim, clip = self.criterion, self.optim_method, \
            self.grad_clip
        if self.compute_dtype in (None, torch.float32):
            def loss_fn(x, y):
                return criterion.apply(net(x), y)
        else:
            mixed = mixed_precision_loss_fn(net, criterion,
                                            self.compute_dtype)

            def loss_fn(x, y):
                return mixed(params, x, y)

        def step_fn(x, y, lr, step):
            for p in params.values():
                p.grad = None
            loss = loss_fn(x, y)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            if clip is not None:
                grads = clip(grads)
            optim.update(grads, params, ostate, lr, step)
            return loss.detach()

        logger.info("LocalOptimizer: %d samples/epoch, device=%s",
                    self.dataset.size(), device)
        self._train_driver(step_fn, device)
        # write the trained weights back into the user's model
        with torch.no_grad():
            trained = dict(net.named_parameters())
            for k, p in self.model.named_parameters():
                p.copy_(trained[k])
            trained = dict(net.named_buffers())
            for k, b in self.model.named_buffers():
                b.copy_(trained[k])
        return self.model

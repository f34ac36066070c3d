"""Continuous-batching autoregressive decode (port of
``bigdl_tpu/serving/decode.py``).

The batch-inference engine (``serving/service.py``) coalesces fixed-shape
requests into one dispatch — the right shape for encoder traffic, the
WRONG shape for autoregressive decode, where padding a request batch to
its slowest member holds a 4-token reply hostage to a 512-token one.
This module schedules at **iteration (step) granularity** instead — the
Orca/vLLM discipline:

- a **slotted KV cache** sized to a declared budget: k/v each
  ``(L, slots, H, max_seq_len, Dh)`` f32 tensors on the device
  (``models/transformer.py`` decode carry); a sequence owns one slot
  from admission to EOS/max-tokens/deadline, then the slot is reclaimed
  the same step and the next queued sequence takes it;
- **prefill buckets**: prompts are padded to a sequence-length bucket
  (``parse_row_buckets`` — the grammar's ``pow2@<floor>`` form exists
  for exactly this) and every bucket's prefill and cache splice run
  once at construction (warmup: on the card this sizes the caching
  allocator and the library handles), so ``compile_count`` is frozen
  after the constructor;
- one **decode step** over the full slot batch: every step
  advances ALL active sequences one token; new sequences are admitted
  into the running batch BETWEEN steps (never blocking on in-flight
  sequences finishing), which the accounting exposes as
  ``admit_step``/``finish_step`` on every :class:`DecodeResult`;
- **deadlines and per-tenant QoS ride the existing request path**: each
  queued sequence is a :class:`~bigdl_tpu_torch.serving.batcher._Request`
  (deadline + RequestContext + future), admission under pressure ranks
  by the same ``priority_fn`` contract the batcher uses (frontend
  :class:`~bigdl_tpu_torch.frontend.QosAdmission` plugs in unchanged), and an
  expired sequence — queued or mid-decode — settles
  :class:`DeadlineExceeded`;
- **token streaming**: ``submit(..., on_token=fn)`` delivers each token
  as generated (the frontend's chunked-ndjson generate route rides
  this).

Threading: ONE scheduler thread owns the device caches and all slot
bookkeeping (single-owner, no lock needed there) and names the service's
device for every launch it makes; the cross-thread
surface (queue, lifecycle flags, active count) is guarded by ``_cond``'s
lock.  Metrics land on a :class:`~bigdl_tpu_torch.serving.ServingMetrics`
(dispatch accounting reads as step occupancy: ``record_dispatch(active,
slots)`` per step, so ``mean_batch_occupancy`` is the continuous-batching
win the bench reports).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.serving.batcher import (DeadlineExceeded, RequestSpecError,
                                             ServiceClosed, ServiceOverloaded,
                                             _Request, settle_future)
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.service import device_scope, parse_row_buckets

logger = logging.getLogger("bigdl_tpu_torch.serving")


class DecodeResult:
    """What a decode future resolves to.

    - ``tokens``: np.int32 array of generated tokens (includes the EOS
      token when ``finish_reason == "eos"``);
    - ``finish_reason``: ``"eos"`` | ``"length"`` (max-new-tokens or
      context cap);
    - ``admit_step`` / ``finish_step``: the scheduler's global step
      counter at admission / completion — the dispatch accounting that
      PROVES continuous batching (request B with ``A.admit_step <
      B.admit_step < A.finish_step`` joined A's running batch);
    - ``slot``: the KV-cache slot the sequence occupied (slot-reuse
      audits);
    - ``prompt_len`` / ``prefill_bucket``: request size and the
      bucket its prefill padded into.
    """

    __slots__ = ("tokens", "finish_reason", "admit_step", "finish_step",
                 "slot", "prompt_len", "prefill_bucket")

    def __init__(self, tokens, finish_reason, admit_step, finish_step,
                 slot, prompt_len, prefill_bucket):
        self.tokens = tokens
        self.finish_reason = finish_reason
        self.admit_step = admit_step
        self.finish_step = finish_step
        self.slot = slot
        self.prompt_len = prompt_len
        self.prefill_bucket = prefill_bucket


class _Pending:
    """A queued decode request: the generic :class:`_Request` (future /
    deadline / ctx / t_enqueue — the existing request path) plus the
    decode-only fields that don't fit its __slots__."""

    __slots__ = ("req", "max_new", "on_token")

    def __init__(self, req: _Request, max_new: int, on_token):
        self.req = req
        self.max_new = max_new
        self.on_token = on_token


class _Sequence:
    """One active slot: scheduler-thread-owned bookkeeping."""

    __slots__ = ("pend", "prompt_len", "bucket", "generated",
                 "admit_step", "slot")

    def __init__(self, pend: _Pending, prompt_len: int, bucket: int,
                 admit_step: int, slot: int):
        self.pend = pend
        self.prompt_len = prompt_len
        self.bucket = bucket
        self.generated: List[int] = []
        self.admit_step = admit_step
        self.slot = slot


class DecodeService:
    """Continuous-batching decode engine for one ``transformer_lm``.

    Parameters:

    - ``slots``: concurrent-sequence capacity (the decode batch width).
    - ``max_seq_len``: per-sequence context cap (prompt + generated);
      clamped to the model's positional-embedding table.
    - ``kv_budget_mb``: declared KV-cache budget.  The cache is sized
      up front (two ``(L, slots, H, max_seq_len, Dh)`` f32 arrays); if
      that exceeds the budget, ``slots`` is CUT to what fits (raising
      if not even one slot fits) — the budget is a hard cap, not a
      hint.
    - ``prefill_buckets``: sequence-length bucket spec
      (:func:`~bigdl_tpu_torch.serving.service.parse_row_buckets` grammar
      over ``max_prompt_len``; default ``"pow2@8"``).
    - ``eos_id``: token id that finishes a sequence (None = length-only
      stopping); ``default_max_new_tokens`` caps generation when the
      caller doesn't.
    - ``deadline_ms``: default per-request deadline (0/None = none).
    - ``mesh``: optional :class:`~bigdl_tpu_torch.parallel.Mesh` with a
      model device group: a copy of the model is placed on the group
      with the splits its layers declare (``parallel.shard_module``, the
      ``ShardedReplicaSet`` discipline), making this a sharded-decode
      backend; the KV cache is split on its heads over the group
      (``models.transformer.ShardedKV``, ``kv_bytes_per_shard`` a
      device) when the group's size divides the heads, and lies whole on
      the home device otherwise, as the reference's cache is replicated.
    - ``device``: where the model and the caches live, ``"cuda"`` (the
      default, or the mesh's home device with a mesh; raises without
      CUDA) or ``"cpu"``.  The model is moved there and switched to eval
      mode in place, as
      :class:`~bigdl_tpu_torch.serving.InferenceService` does;
      ``params``/``state`` (the reference's tree layout,
      ``interop.load_jax_params``) or a ``mesh`` place a copy instead.
    - ``priority_fn``: the batcher's QoS contract — maps a queued
      ``_Request`` to an int rank (lower admits first), engaged only
      under pressure (more queued than free slots).

    Greedy (argmax) decoding — deterministic, so serving output equals
    the full-context run of the same model on the same device token for
    token, wherever the top two log-probs are not within rounding.
    """

    # duck-type marker the frontend's generate route checks — a backend
    # without it answers 400 (predict backends don't decode)
    is_decode_backend = True

    def __init__(self, model, params=None, state=None, *,
                 slots: int = 4, max_seq_len: int = 256,
                 max_prompt_len: Optional[int] = None,
                 default_max_new_tokens: int = 32,
                 eos_id: Optional[int] = None,
                 prefill_buckets: Optional[str] = None,
                 kv_budget_mb: Optional[float] = None,
                 queue_capacity: int = 64,
                 deadline_ms: Optional[float] = None,
                 name: str = "decode", mesh=None,
                 registry=None, priority_fn=None, start: bool = True,
                 device=None):
        import copy

        from bigdl_tpu_torch.engine import resolve_device
        from bigdl_tpu_torch.models.transformer import (ShardedKV,
                                                        init_kv_cache,
                                                        kv_cache_spec,
                                                        lm_layout)
        self.name = name
        if mesh is not None and getattr(mesh, "devices", None) is None:
            raise ValueError("DecodeService(mesh=) needs a mesh with a "
                             "model device group (create_mesh(model=n, "
                             "devices=...))")
        self.device = resolve_device(
            device if device is not None
            else mesh.home if mesh is not None else "cuda")
        if mesh is not None and self.device != mesh.home:
            raise ValueError(f"the mesh's home device is {mesh.home}, the "
                             f"service's {self.device}")
        embed, pos_mod, blocks, _, _, mha = lm_layout(model)  # validates
        self.vocab_size = int(embed.n_index)
        if params is not None or state is not None:
            from bigdl_tpu_torch.interop.jax_weights import (load_jax_params,
                                                             to_jax_params)
            model = load_jax_params(copy.deepcopy(model).cpu(),
                                    params if params is not None
                                    else to_jax_params(model)[0], state)
        if mesh is not None:
            from bigdl_tpu_torch.parallel.tensor_parallel import shard_module
            model = shard_module(copy.deepcopy(model).cpu(), mesh)
        else:
            model = model.to(self.device)
        self._model = model.eval()
        self._mesh = mesh
        self.max_seq_len = int(min(max_seq_len, pos_mod.max_len))
        if self.max_seq_len < 2:
            raise ValueError(f"max_seq_len must be >= 2: {self.max_seq_len}")
        self.max_prompt_len = int(max_prompt_len
                                  if max_prompt_len is not None
                                  else self.max_seq_len - 1)
        if not 1 <= self.max_prompt_len < self.max_seq_len:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} must leave room "
                f"for >= 1 generated token under max_seq_len "
                f"{self.max_seq_len}")
        self.eos_id = eos_id
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.queue_capacity = int(queue_capacity)
        self.deadline_s = (float(deadline_ms) / 1e3
                           if deadline_ms and deadline_ms > 0 else None)
        self.buckets = parse_row_buckets(prefill_buckets or "pow2@8",
                                         self.max_prompt_len)

        # KV budget: price the cache BEFORE allocating; the declared
        # budget wins over the requested slot count
        slots = int(slots)
        if slots < 1:
            raise ValueError(f"slots must be >= 1: {slots}")
        shape, dtype = kv_cache_spec(self._model, 1, self.max_seq_len)
        per_slot = 2 * int(np.prod(shape)) * dtype.itemsize
        if kv_budget_mb is not None:
            afford = int(kv_budget_mb * (1 << 20)) // per_slot
            if afford < 1:
                raise ValueError(
                    f"kv_budget_mb={kv_budget_mb} cannot hold one slot "
                    f"({per_slot / (1 << 20):.2f} MB/slot at "
                    f"max_seq_len={self.max_seq_len})")
            slots = min(slots, afford)
        self.slots = slots
        self.kv_bytes = per_slot * slots

        self.metrics = ServingMetrics(registry)
        reg = self.metrics.registry
        self._c_steps = reg.counter("decode/steps")
        self._c_tokens = reg.counter("decode/tokens_generated")
        self._c_admissions = reg.counter("decode/admissions")
        self._c_reclaims = reg.counter("decode/slots_reclaimed")
        self._c_active_steps = reg.counter("decode/active_slot_steps")

        self._priority_fn = priority_fn
        self._priority_aging_s = 0.5  # same starvation bound as batcher

        # ---- cross-thread state --------------------------------------
        self._cond = threading.Condition()
        self._queue: deque[_Pending] = deque()  # guarded-by: _cond
        self._n_active = 0       # guarded-by: _cond
        self._stopping = False   # guarded-by: _cond
        self._drain = True       # guarded-by: _cond
        self._steps_done = 0     # guarded-by: _cond
        # step-seconds EWMA; written by the scheduler only, read racily
        # for overload retry hints (a stale hint is still a hint)
        self._step_ewma: Optional[float] = None
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond

        # ---- scheduler-thread-owned state (single owner: the decode
        # loop; constructed here before the thread exists) -------------
        self._seqs: List[Optional[_Sequence]] = [None] * slots
        self._lengths = np.zeros((slots,), np.int64)  # cached positions
        self._last_tok = np.zeros((slots,), np.int64)
        self._k, self._v = init_kv_cache(self._model, slots,
                                         self.max_seq_len, self.device)
        # one device's share of the cache: the whole under a head split
        # the group's size does not divide, or without a mesh
        self.kv_bytes_per_shard = 2 * self._k.part_nbytes \
            if isinstance(self._k, ShardedKV) else self.kv_bytes

        # ---- warmup ----------------------------------------------------
        # one decode step and every bucket's prefill and splice run HERE
        # and only here; compile_count counts them (the reference's count
        # of compiled executables) and never moves after the constructor
        self._trace_count = 0
        self._step_exec = self._decode_step
        with torch.inference_mode(), device_scope(self.device):
            self._step_exec(self._device_ints(self._last_tok),
                            self._device_ints(self._lengths),
                            self._k, self._v)
            self._trace_count += 1
            for tb in self.buckets:
                _lp, kp, vp = self._prefill(
                    self._device_ints(np.zeros((1, tb), np.int64)))
                self._trace_count += 1
                self._splice(kp, vp, 0)
                self._trace_count += 1
            self._k.zero_()
            self._v.zero_()

        if start:
            self.start()

    # ------------------------------------------------------------ device
    def _device_ints(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode_step(self, tokens, lengths, k, v):
        from bigdl_tpu_torch.models.transformer import \
            transformer_lm_decode_step
        return transformer_lm_decode_step(self._model, tokens, lengths,
                                          k, v)

    def _prefill(self, tokens):
        from bigdl_tpu_torch.models.transformer import \
            transformer_lm_prefill
        return transformer_lm_prefill(self._model, tokens)

    def _splice(self, kp, vp, slot: int) -> None:
        """Write a (L, 1, H, Tb, Dh) prefill cache into ``slot`` at
        positions 0..Tb-1 (the slot index is always in range, and a
        bucket never exceeds ``max_prompt_len < max_seq_len``); a split
        cache part by part, each on its device."""
        from bigdl_tpu_torch.models.transformer import splice_kv
        splice_kv(self._k, kp, slot)
        splice_kv(self._v, vp, slot)

    @property
    def compile_count(self) -> int:
        """Warmup runs of the step, prefill and splice (one step, and a
        prefill and a splice per bucket).  Frozen after construction."""
        return self._trace_count

    # ------------------------------------------------------------ control
    def start(self) -> "DecodeService":
        with self._cond:
            if self._thread is None:
                t = threading.Thread(target=self._run,
                                     name=f"decode-sched/{self.name}",
                                     daemon=True)
                self._thread = t
                t.start()
        return self

    @property
    def alive(self) -> bool:
        with self._cond:
            t = self._thread
        return t is not None and t.is_alive()

    @property
    def max_batch_size(self) -> int:
        """Slot capacity — the backend-contract name the frontend's
        request validators expect."""
        return self.slots

    @property
    def row_spec(self):
        """Backend-contract compatibility (``HotCutover`` / registry
        introspection): decode requests are token prompts, not fixed
        row shapes — there is no per-row spec to advertise."""
        return None

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    @property
    def steps_done(self) -> int:
        with self._cond:
            return self._steps_done

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Refuse new work; with ``drain`` finish every queued + active
        sequence first, else cancel them (``ServiceClosed``)."""
        with self._cond:
            self._stopping = True
            self._drain = bool(drain)
            t = self._thread
            self._cond.notify_all()
        if t is not None:
            t.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- submit
    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline: Optional[float] = None, ctx=None,
               on_token: Optional[Callable[[int, int], None]] = None):
        """Enqueue one prompt (1-D int array/list).  Returns a Future
        resolving to a :class:`DecodeResult`.  ``on_token(index,
        token_id)`` fires from the scheduler thread as each token is
        generated — it must not block (the streaming route hands tokens
        to its own writer).  ``deadline`` is absolute monotonic seconds
        (the frontend's ``X-Deadline-Ms`` path); default from
        ``deadline_ms``."""
        x = np.asarray(prompt)
        if x.ndim != 1 or x.size < 1 or not np.issubdtype(x.dtype,
                                                          np.integer):
            raise RequestSpecError(
                f"prompt must be a non-empty 1-D int array, got "
                f"shape {x.shape} dtype {x.dtype}")
        if x.min() < 0 or x.max() >= self.vocab_size:
            # the reference's gather fills NaN for such a token and
            # serves what follows from it; a CUDA gather would assert
            raise RequestSpecError(
                f"prompt token ids must lie in [0, {self.vocab_size}): "
                f"got {int(x.min())}..{int(x.max())}")
        if x.size > self.max_prompt_len:
            raise RequestSpecError(
                f"prompt length {x.size} > max_prompt_len "
                f"{self.max_prompt_len}")
        max_new = (int(max_new_tokens) if max_new_tokens is not None
                   else self.default_max_new_tokens)
        if max_new < 1:
            raise RequestSpecError(f"max_new_tokens must be >= 1: "
                                   f"{max_new}")
        max_new = min(max_new, self.max_seq_len - int(x.size))
        if deadline is None and self.deadline_s is not None:
            deadline = time.monotonic() + self.deadline_s
        req = _Request(x.astype(np.int32), 1, deadline=deadline, ctx=ctx)
        pend = _Pending(req, max_new, on_token)
        with self._cond:
            if self._stopping:
                raise ServiceClosed(f"decode service {self.name!r} is "
                                    f"stopping")
            if len(self._queue) >= self.queue_capacity:
                self.metrics.record_reject(1)
                raise ServiceOverloaded(
                    len(self._queue), self.queue_capacity, self.name,
                    retry_after_ms=self._retry_hint_locked())
            self._queue.append(pend)
            self._cond.notify_all()
        self.metrics.record_submit(1)
        return req.future

    def generate(self, prompt, **kw) -> DecodeResult:
        """Blocking sugar over :meth:`submit`."""
        return self.submit(prompt, **kw).result()

    def _retry_hint_locked(self) -> Optional[float]:  # guarded-by: _cond
        """Queue-drain estimate: steps to free a slot times step time.
        Coarse by design — a shed caller needs a magnitude, not a
        promise."""
        ew = self._step_ewma
        if ew is None:
            return None
        waves = (len(self._queue) + self.slots) / max(1, self.slots)
        return ew * 1e3 * waves * max(1, self.default_max_new_tokens // 4)

    # ---------------------------------------------------------- scheduler
    def _rank_locked(self, pend: _Pending, now: float) -> int:
        """The batcher's effective-rank rule verbatim: declared rank
        minus one class per aging period waited; a broken priority_fn
        ranks most-urgent instead of killing the scheduler."""
        try:
            rank = int(self._priority_fn(pend.req))
        except Exception:
            return 0
        return rank - int((now - pend.req.t_enqueue)
                          / self._priority_aging_s)

    # guarded-by: _cond
    def _pick_admissions_locked(self, free: int) -> List[_Pending]:
        """Pop up to ``free`` queued sequences.  FIFO under light load;
        with a ``priority_fn`` and more queued than admissible, best
        (effective rank, arrival) wins — the batcher's pressure rule at
        slot granularity."""
        if free <= 0 or not self._queue:
            return []
        picked: List[_Pending] = []
        pressure = (self._priority_fn is not None
                    and len(self._queue) > free)
        now = time.monotonic()
        for _ in range(min(free, len(self._queue))):
            if pressure:
                best = min(range(len(self._queue)),
                           key=lambda i: (self._rank_locked(
                               self._queue[i], now),
                               self._queue[i].req.t_enqueue))
                picked.append(self._queue[best])
                del self._queue[best]
            else:
                picked.append(self._queue.popleft())
        return picked

    def _emit(self, seq: _Sequence, index: int, token: int) -> None:
        cb = seq.pend.on_token
        if cb is None:
            return
        try:
            cb(index, token)
        except Exception:
            logger.exception("decode on_token callback failed "
                             "(model=%s)", self.name)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _admit(self, pend: _Pending, slot: int) -> None:
        """Prefill one sequence into ``slot`` (scheduler thread)."""
        req = pend.req
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            if settle_future(req.future, exc=DeadlineExceeded(
                    f"deadline expired before admission "
                    f"(model={self.name})")):
                self.metrics.record_failure(1)
            return
        prompt = req.x
        n = int(prompt.shape[0])
        tb = self._bucket_for(n)
        padded = np.zeros((1, tb), np.int64)
        padded[0, :n] = prompt
        with torch.inference_mode():
            lp, kp, vp = self._prefill(self._device_ints(padded))
            self._splice(kp, vp, slot)
            first = int(lp[0, n - 1].argmax())  # device sync point
        self.metrics.record_dispatch(1, 1)  # prefill dispatch
        with self._cond:
            admit_step = self._steps_done
            self._n_active += 1
        seq = _Sequence(pend, n, tb, admit_step, slot)
        self._seqs[slot] = seq
        self._lengths[slot] = n
        self._last_tok[slot] = first
        self._c_admissions.inc()
        seq.generated.append(first)
        self._c_tokens.inc()
        self._emit(seq, 0, first)
        # a 1-token request (or instant EOS) finishes without ever
        # joining the step batch
        self._maybe_finish(seq, first)

    def _finish(self, seq: _Sequence, reason: str) -> None:
        with self._cond:
            finish_step = self._steps_done
            self._n_active -= 1
            self._cond.notify_all()
        self._seqs[seq.slot] = None
        self._lengths[seq.slot] = 0
        self._last_tok[seq.slot] = 0
        self._c_reclaims.inc()
        res = DecodeResult(np.asarray(seq.generated, np.int32), reason,
                           seq.admit_step, finish_step, seq.slot,
                           seq.prompt_len, seq.bucket)
        if settle_future(seq.pend.req.future, result=res):
            self.metrics.record_done(
                1, time.monotonic() - seq.pend.req.t_enqueue,
                bucket=seq.bucket)

    def _fail(self, seq: _Sequence, exc: BaseException) -> None:
        with self._cond:
            self._n_active -= 1
            self._cond.notify_all()
        self._seqs[seq.slot] = None
        self._lengths[seq.slot] = 0
        self._last_tok[seq.slot] = 0
        self._c_reclaims.inc()
        if settle_future(seq.pend.req.future, exc=exc):
            self.metrics.record_failure(1)

    def _maybe_finish(self, seq: _Sequence, token: int) -> bool:
        if self.eos_id is not None and token == self.eos_id:
            self._finish(seq, "eos")
            return True
        if len(seq.generated) >= seq.pend.max_new:
            self._finish(seq, "length")
            return True
        if seq.prompt_len + len(seq.generated) >= self.max_seq_len:
            self._finish(seq, "length")
            return True
        return False

    def _step(self) -> None:
        """One decode iteration over the slot batch (scheduler thread):
        every active sequence's last token is written to its cache and
        its next token decoded — ONE forward over the slot batch
        regardless of how many sequences are active (the inactive lanes
        compute discarded values; occupancy is the metric that prices
        this)."""
        t0 = time.monotonic()
        active = [s for s in self._seqs if s is not None]
        with torch.inference_mode():
            lp, self._k, self._v = self._step_exec(
                self._device_ints(self._last_tok),
                self._device_ints(self._lengths), self._k, self._v)
            nxt = lp.argmax(-1).cpu().numpy()  # device sync point
        dt = time.monotonic() - t0
        self._step_ewma = (dt if self._step_ewma is None
                           else 0.8 * self._step_ewma + 0.2 * dt)
        with self._cond:
            self._steps_done += 1
        self._c_steps.inc()
        self._c_active_steps.inc(len(active))
        self.metrics.record_dispatch(len(active), self.slots)
        now = time.monotonic()
        for seq in active:
            # cache grew by one position (the step wrote last_tok's K/V)
            self._lengths[seq.slot] += 1
            if (seq.pend.req.deadline is not None
                    and now >= seq.pend.req.deadline):
                self._fail(seq, DeadlineExceeded(
                    f"deadline expired mid-decode after "
                    f"{len(seq.generated)} tokens (model={self.name})"))
                continue
            tok = int(nxt[seq.slot])
            self._last_tok[seq.slot] = tok
            seq.generated.append(tok)
            self._c_tokens.inc()
            self._emit(seq, len(seq.generated) - 1, tok)
            self._maybe_finish(seq, tok)

    def _cancel_backlog_locked(self) -> List[_Pending]:  # guarded-by: _cond
        out = list(self._queue)
        self._queue.clear()
        return out

    def _run(self) -> None:
        """The decode loop.  Each pass: admit queued sequences into free
        slots (prefill off the lock), then run one step if anything is
        active.  Blocks on the condition when idle.  An unexpected
        exception anywhere in the loop fails every in-flight future
        with it instead of dying silently — a crashed scheduler with
        live futures would park every ``generate()`` caller forever."""
        cancelled: List[_Pending] = []
        to_admit: List[_Pending] = []
        crash: Optional[BaseException] = None
        scope = device_scope(self.device)
        scope.__enter__()
        try:
            while True:
                with self._cond:
                    while (not self._stopping and not self._queue
                           and self._n_active == 0):
                        self._cond.wait()
                    if self._stopping and (
                            not self._drain
                            or (not self._queue and self._n_active == 0)):
                        cancelled = self._cancel_backlog_locked()
                        break
                    free = self.slots - self._n_active
                    to_admit = self._pick_admissions_locked(free)
                for slot in range(self.slots):
                    if not to_admit:
                        break
                    if self._seqs[slot] is None:
                        # popped only once admitted: a crash in the
                        # prefill settles the sequence in hand too
                        self._admit(to_admit[0], slot)
                        to_admit.pop(0)
                if any(s is not None for s in self._seqs):
                    self._step()
        except Exception as e:
            logger.exception("decode scheduler crashed (model=%s)",
                             self.name)
            crash = e
            with self._cond:
                self._stopping = True  # submit() refuses from here on
                # the sequences popped for admission are in neither the
                # queue nor a slot: settle them with the rest
                cancelled = to_admit + self._cancel_backlog_locked()
                self._cond.notify_all()
        finally:
            scope.__exit__(None, None, None)
        # non-drain stop (or crash): settle queued work and active
        # sequences — the crash exception propagates to every caller
        exc = crash if crash is not None else ServiceClosed(
            f"decode service {self.name!r} stopped")
        for pend in cancelled:
            if settle_future(pend.req.future, exc=exc):
                if crash is None:
                    self.metrics.record_cancel(1)
                else:
                    self.metrics.record_failure(1)
        for seq in list(self._seqs):
            if seq is not None:
                self._fail(seq, exc)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The ``service.stats()`` schema plus a ``decode`` section:
        step/token/admission accounting and step-level occupancy
        (active-slot-steps over total slot-steps — the continuous-
        batching utilization figure)."""
        with self._cond:
            qd = len(self._queue)
            steps = self._steps_done
            active = self._n_active
        snap = self.metrics.snapshot(queue_depth=qd,
                                     compile_count=self._trace_count)
        ew = self._step_ewma
        snap["decode"] = {
            "slots": self.slots,
            "active": active,
            "steps": steps,
            "tokens_generated": self._c_tokens.value,
            "admissions": self._c_admissions.value,
            "slots_reclaimed": self._c_reclaims.value,
            "step_occupancy": (
                round(self._c_active_steps.value / (steps * self.slots), 4)
                if steps else None),
            "step_ms_ewma": round(ew * 1e3, 3) if ew is not None else None,
            "prefill_buckets": list(self.buckets),
            "max_seq_len": self.max_seq_len,
            "kv_bytes": self.kv_bytes,
            "kv_bytes_per_shard": self.kv_bytes_per_shard,
        }
        return snap

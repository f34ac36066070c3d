"""Multi-worker batch assembly and device staging of K-step training
blocks (port of ``bigdl_tpu/dataset/prefetch.py``: ``MTSampleToMiniBatch``
and ``DeviceBlockStager``).

:class:`MTSampleToMiniBatch` fans a per-sample transform (an augmentation
pipeline) out over a thread pool (numpy releases the GIL in its kernels)
and buffers assembled MiniBatches in a bounded queue, so batch i+1 is
assembled while the card trains on batch i.  Each transform call runs
under :func:`~bigdl_tpu_torch.utils.imgops.sample_key` with the sample's
stream position and the transformer's pass counter, so its random draws,
and the batches, are the reference's exactly, whichever worker runs it.

The stager pulls MiniBatches from the host pipeline, stacks up to K of them
along a new leading step axis, and puts the stack on the training device.
Inputs and targets may be trees (tuples, lists, dicts and ``COOBatch`` es,
as the Wide&Deep input ``(coo, deep_ids, dense)``): every leaf is stacked,
and a block breaks where the structure, a static ``dense_shape`` or a
leaf's shape or dtype (a COO pipeline's nnz bucket) changes.  On a CUDA
device each stacked leaf goes to pinned host memory and is copied with a
non-blocking copy on a side stream; an event marks the copy's end, and the
block's consumer makes the training stream wait on that event
(:meth:`StagedBlock.wait`).  A driver that stages block b+1 right after
enqueuing block b thus overlaps the copy with block b's compute.  On the
CPU the stack is used as it is.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import Transformer, rescaled_batch
from bigdl_tpu_torch.telemetry.tracer import NULL_SPAN
from bigdl_tpu_torch.utils.imgops import sample_key


def _node(x):
    """``(kind, static metadata, children)`` of a tree node, or None for a
    leaf.  Nodes: tuples, lists, dicts and ``COOBatch`` (its three
    tensors; ``dense_shape`` is static)."""
    from bigdl_tpu_torch.nn.sparse import COOBatch
    if isinstance(x, COOBatch):
        return COOBatch, x.dense_shape, (x.row, x.col, x.values)
    if isinstance(x, (tuple, list)):
        return type(x), len(x), tuple(x)
    if isinstance(x, dict):
        keys = tuple(x)
        return dict, keys, tuple(x[k] for k in keys)
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), rebuilt in its structure;
    None stays None (the reference's ``jax.tree_util.tree_map`` over the
    port's input structures)."""
    if tree is None:
        return None
    node = _node(tree)
    if node is None:
        return fn(tree, *rest)
    kind, meta, kids = node
    others = [_node(r)[2] for r in rest]
    out = [tree_map(fn, k, *(o[i] for o in others))
           for i, k in enumerate(kids)]
    if kind is dict:
        return dict(zip(meta, out))
    if kind in (tuple, list):
        return kind(out)
    return kind(*out, meta)


def tree_signature(tree):
    """Structure, static metadata and per-leaf shape and dtype: batches
    stack into one block only when theirs agree (a ragged last batch or a
    new nnz bucket of a COO pipeline starts a new block)."""
    if tree is None:
        return None
    node = _node(tree)
    if node is None:
        return np.shape(tree), np.asarray(tree).dtype
    kind, meta, kids = node
    return kind.__name__, meta, tuple(tree_signature(k) for k in kids)


class StagedBlock:
    """A staged block: ``xs``/``ys`` trees whose leaves carry a leading
    step axis (``ys`` None for unlabelled batches), the batch ``sizes``,
    the copy's event and the device."""

    __slots__ = ("xs", "ys", "event", "sizes", "device")

    def __init__(self, xs, ys, event, sizes: List[int], device):
        self.xs, self.ys, self.event, self.sizes = xs, ys, event, sizes
        self.device = device

    def wait(self) -> None:
        """Make the current stream wait until the block has landed."""
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)

    def step(self, j: int):
        """Step ``j``'s ``(input, target)``: every leaf's slice ``j``."""
        take = lambda a: a[j]  # noqa: E731
        return tree_map(take, self.xs), tree_map(take, self.ys)


def _signature(b: MiniBatch):
    return tree_signature(b.input), tree_signature(b.target)


def _stack_leaves(*leaves):
    return np.stack([np.asarray(a) for a in leaves])


class DeviceBlockStager:
    """Stage blocks of consecutive same-signature batches on ``device``."""

    def __init__(self, batch_iter: Iterator, device, tracer=None):
        self._it = batch_iter
        self._device = torch.device(device)
        # telemetry: host_stack / h2d_stage spans (cat "stage") when the
        # driver's tracer is given; None records nothing
        self._tracer = tracer
        self._held: Optional[MiniBatch] = None  # deferred to the next block
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None

    def reset(self, batch_iter: Iterator) -> None:
        """Point at a fresh iterator (epoch rollover).  Blocks stop at the
        epoch boundary, so no pre-shuffle batch is held."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()
        self._it = batch_iter
        self._held = None

    def take(self, k: int, records_budget: int) -> StagedBlock:
        """Stage up to ``k`` consecutive same-signature batches whose total
        size stays within ``records_budget`` (the batch that reaches it is
        included).  Raises StopIteration if the iterator is exhausted with
        nothing staged: training iterators must be infinite."""
        span = self._tracer.span if self._tracer is not None else None
        with span("host_stack", cat="stage") if span else NULL_SPAN:
            xs, ys, sizes = self._stack_block(k, records_budget)
        with span("h2d_stage", cat="stage", k=len(sizes)) if span \
                else NULL_SPAN:
            # the copy is asynchronous: the span times the host's side
            # of the staging, not the transfer itself
            if self._stream is None:
                return StagedBlock(tree_map(torch.from_numpy, xs),
                                   tree_map(torch.from_numpy, ys), None,
                                   sizes, self._device)
            return StagedBlock(*self._to_device(xs, ys), sizes,
                               self._device)

    def _stack_block(self, k: int, records_budget: int):
        batches, sig, total = [], None, 0
        while len(batches) < max(1, int(k)) and total < records_budget:
            if self._held is not None:
                b, self._held = self._held, None
            else:
                try:
                    b = next(self._it)
                except StopIteration:
                    break
            if not isinstance(b, MiniBatch):
                raise TypeError("training dataset must yield MiniBatch "
                                "(attach SampleToMiniBatch)")
            if sig is None:
                sig = _signature(b)
            elif _signature(b) != sig:
                self._held = b  # a ragged batch heads the next block
                break
            batches.append(b)
            total += b.size()
        if not batches:
            raise StopIteration("training data iterator exhausted mid-epoch: "
                                "train=True iterators must be infinite")
        xs = tree_map(_stack_leaves, *[b.input for b in batches])
        ys = None if batches[0].target is None else \
            tree_map(_stack_leaves, *[b.target for b in batches])
        return xs, ys, [b.size() for b in batches]

    def _to_device(self, xs, ys):
        main = torch.cuda.current_stream(self._device)

        def copy(a):
            t = torch.from_numpy(a).pin_memory().to(self._device,
                                                    non_blocking=True)
            # allocated on the side stream, used on the training one
            t.record_stream(main)
            return t

        with torch.cuda.stream(self._stream):
            xs, ys = tree_map(copy, xs), tree_map(copy, ys)
            event = torch.cuda.Event()
            event.record(self._stream)
        return xs, ys, event


def fast_forward_records(batch_iter, skip: int) -> int:
    """Advance a fresh epoch iterator past exactly ``skip`` records (the
    mid-epoch resume).  Raises when the epoch runs out first or the batch
    boundaries cannot land on ``skip``: overshooting would replay the
    epoch from a position the interrupted run never visited."""
    skipped = 0
    while skipped < skip:
        try:
            skipped += next(batch_iter).size()
        except StopIteration:
            raise ValueError(
                f"dataset fast-forward: epoch exhausted after "
                f"{skipped} records while seeking {skip} — the "
                f"dataset shrank since the snapshot was written"
            ) from None
    if skipped != skip:
        raise ValueError(
            f"dataset fast-forward: batch boundaries land on {skipped} "
            f"records, not the {skip} the snapshot recorded — batch "
            f"size or dataset layout changed since the snapshot was "
            f"written")
    return skipped


def _stack(samples) -> MiniBatch:
    feats = np.stack([s.feature for s in samples])
    if samples[0].label is None:
        return MiniBatch(feats, None)
    return MiniBatch(feats, np.stack([np.asarray(s.label)
                                      for s in samples]))


class MTSampleToMiniBatch(Transformer):
    """Parallel per-sample transform, batch assembly and prefetch.

    ``transform`` maps one Sample to a Sample and runs on ``workers``
    threads; up to ``prefetch`` assembled batches wait ahead of the
    consumer.  A consumer that stops early (``close()``) stops the
    producer and its workers; a worker's error reaches the consumer."""

    def __init__(self, batch_size: int,
                 transform: Optional[Callable[[Sample], Sample]] = None,
                 workers: int = 4, prefetch: int = 2,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.transform = transform
        self.workers = workers
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder
        # pass counter folded into the sample key: each call (an epoch)
        # draws fresh augmentation, run-to-run deterministic
        self._passes = itertools.count()

    def rescale(self, old_count: int, new_count: int) -> None:
        self.batch_size = rescaled_batch(self.batch_size, old_count,
                                         new_count)

    def __call__(self, it: Iterator[Sample]) -> Iterator[MiniBatch]:
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()
        failure: list = [None]  # the producer's error, out of band
        pass_ix = next(self._passes)

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def keyed_transform(ix_sample):
            ix, sample = ix_sample
            with sample_key((pass_ix << 40) | ix):
                return self.transform(sample)

        def producer():
            pool = None
            stream_ix = 0
            try:
                pool = ThreadPoolExecutor(max_workers=self.workers)
                buf = []
                src = iter(it)
                while not stop.is_set():
                    chunk = list(itertools.islice(src, self.batch_size))
                    if not chunk:
                        break
                    if self.transform is not None:
                        chunk = list(pool.map(
                            keyed_transform,
                            enumerate(chunk, start=stream_ix)))
                    stream_ix += len(chunk)
                    buf.extend(chunk)
                    while len(buf) >= self.batch_size:
                        if not put_or_stop(_stack(buf[:self.batch_size])):
                            return
                        buf = buf[self.batch_size:]
                    if len(chunk) < self.batch_size:
                        break
                if buf and not self.drop_remainder:
                    put_or_stop(_stack(buf))
            except BaseException as e:  # re-raised by the consumer
                failure[0] = e
                put_or_stop(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=False, cancel_futures=True)
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # must not mask the end marker
                        pass
                put_or_stop(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = out_q.get(timeout=0.2)
                except queue.Empty:
                    if t.is_alive() or not out_q.empty():
                        continue
                    if failure[0] is not None:
                        raise failure[0]
                    raise RuntimeError("batch-assembly producer thread died "
                                       "without an end marker or an error")
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer sees `stop`, then reap it
            while True:
                try:
                    # drained items are DATA batches discarded so the
                    # producer can observe `stop` — no futures ride
                    # this queue; graftlint: disable=GL203
                    out_q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            while True:  # items put during the join window
                try:
                    # same deliberate discard as above
                    # graftlint: disable=GL203
                    out_q.get_nowait()
                except queue.Empty:
                    break

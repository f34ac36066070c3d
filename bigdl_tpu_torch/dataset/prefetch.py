"""Device staging of K-step training blocks (port of ``DeviceBlockStager``
from ``bigdl_tpu/dataset/prefetch.py``).

The stager pulls MiniBatches from the host pipeline, stacks up to K of them
along a new leading step axis, and puts the stack on the training device.
On a CUDA device the stack goes to pinned host memory and is copied with a
non-blocking copy on a side stream; an event marks the copy's end, and the
block's consumer makes the training stream wait on that event
(:meth:`StagedBlock.wait`).  A driver that stages block b+1 right after
enqueuing block b thus overlaps the copy with block b's compute.  On the
CPU the stack is used as it is.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import MiniBatch


class StagedBlock:
    """A staged block: ``xs``/``ys`` with a leading step axis (``ys`` None
    for unlabelled batches), the batch ``sizes``, and the copy's event."""

    __slots__ = ("xs", "ys", "event", "sizes")

    def __init__(self, xs, ys, event, sizes: List[int]):
        self.xs, self.ys, self.event, self.sizes = xs, ys, event, sizes

    def wait(self) -> None:
        """Make the current stream wait until the block has landed."""
        if self.event is not None:
            torch.cuda.current_stream(self.xs.device).wait_event(self.event)


def _signature(b: MiniBatch):
    meta = lambda a: None if a is None else (np.shape(a), np.asarray(a).dtype)  # noqa: E731
    return meta(b.input), meta(b.target)


class DeviceBlockStager:
    """Stage blocks of consecutive same-shape batches on ``device``."""

    def __init__(self, batch_iter: Iterator, device):
        self._it = batch_iter
        self._device = torch.device(device)
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
        """Stage up to ``k`` consecutive same-shape batches whose total
        size stays within ``records_budget`` (the batch that reaches it is
        included).  Raises StopIteration if the iterator is exhausted with
        nothing staged: training iterators must be infinite."""
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
        xs = np.stack([np.asarray(b.input) for b in batches])
        ys = None if batches[0].target is None else \
            np.stack([np.asarray(b.target) for b in batches])
        sizes = [b.size() for b in batches]
        if self._stream is None:
            return StagedBlock(torch.from_numpy(xs),
                               None if ys is None else torch.from_numpy(ys),
                               None, sizes)
        return StagedBlock(*self._to_device(xs, ys), sizes)

    def _to_device(self, xs, ys):
        main = torch.cuda.current_stream(self._device)
        out = []
        with torch.cuda.stream(self._stream):
            for a in (xs, ys):
                if a is None:
                    out.append(None)
                    continue
                t = torch.from_numpy(a).pin_memory().to(self._device,
                                                        non_blocking=True)
                # allocated on the side stream, used on the training one
                t.record_stream(main)
                out.append(t)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out[0], out[1], event

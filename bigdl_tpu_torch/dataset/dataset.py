"""DataSet, the training-data container (port of
``bigdl_tpu/dataset/dataset.py``).

``data(train=True)`` is an infinite iterator over a permuted index array;
``shuffle()`` moves to the next epoch's permutation.  The permutation of
epoch E is a pure function of ``(seed, E)`` — ``np.random.default_rng((seed,
E))``, epoch 0 in insertion order — so it is the reference's order exactly,
and a checkpoint records it as one number (:meth:`position_state`) from
which a resumed run re-derives the same order.  The per-host sharded
``DistributedDataSet`` comes with the multi-card slice.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer


class AbstractDataSet:
    def data(self, train: bool) -> Iterator:
        """Infinite shuffled iterator when ``train``, one pass when not."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self) -> None:
        raise NotImplementedError

    def position_state(self) -> dict:
        """JSON-able shuffle position for a checkpoint (empty when this
        dataset has no shuffle state)."""
        return {}

    def restore_position(self, state: dict) -> None:
        """Re-derive the shuffle order saved by :meth:`position_state`."""

    def reshard(self, process_index: int, process_count: int) -> int:
        """Read shard ``process_index`` of ``process_count`` from now on
        (an elastic resize); returns the previous count.  Only a
        ``DistributedDataSet`` root shards."""
        raise TypeError(
            f"{type(self).__name__} is not sharded over processes: elastic "
            f"training needs a DistributedDataSet")

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)

    def __rshift__(self, transformer: Transformer) -> "TransformedDataSet":
        return self.transform(transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset; ``shuffle`` re-permutes indices only."""

    def __init__(self, data: Sequence, seed: int = 1):
        self._data = data
        self._seed = seed
        self._epoch = 0  # shuffles so far; epoch 0 = insertion order
        self._indexes = np.arange(len(data))

    def size(self) -> int:
        return len(self._data)

    def _permutation(self, epoch: int) -> np.ndarray:
        if epoch == 0:
            return np.arange(len(self._data))
        return np.random.default_rng(
            (self._seed, epoch)).permutation(len(self._data))

    def shuffle(self) -> None:
        self._epoch += 1
        self._indexes = self._permutation(self._epoch)

    def position_state(self) -> dict:
        return {"shuffle_epoch": self._epoch}

    def restore_position(self, state: dict) -> None:
        self._epoch = int(state.get("shuffle_epoch", 0))
        self._indexes = self._permutation(self._epoch)

    def data(self, train: bool) -> Iterator:
        if train:
            def infinite():
                i = 0
                n = len(self._data)
                while True:
                    yield self._data[self._indexes[i % n]]
                    i += 1
            return infinite()
        return iter(self._data)


class DistributedDataSet(AbstractDataSet):
    """Process ``process_index`` of ``process_count``'s shard: indices
    p::P of the epoch's permutation.  Both default to the process group's
    rank and world size (0 and 1 without a group).  ``size()`` is the
    GLOBAL size, which the driver's epoch accounting compares against
    global records."""

    def __init__(self, data: Sequence, seed: int = 1,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        import torch.distributed as dist
        group = dist.is_initialized()
        self._data = data
        self._p = process_index if process_index is not None \
            else (dist.get_rank() if group else 0)
        self._np = process_count if process_count is not None \
            else (dist.get_world_size() if group else 1)
        if not 0 <= self._p < self._np:
            raise ValueError(f"process {self._p} of {self._np}")
        self._seed = seed
        self._epoch = 0
        self._global_indexes = np.arange(len(data))

    def size(self) -> int:
        return len(self._data)

    def local_size(self) -> int:
        return len(range(self._p, len(self._data), self._np))

    def _permutation(self) -> np.ndarray:
        if self._epoch == 0:
            return np.arange(len(self._data))
        return np.random.default_rng(
            self._seed + self._epoch).permutation(len(self._data))

    def shuffle(self) -> None:
        self._epoch += 1
        self._global_indexes = self._permutation()

    def position_state(self) -> dict:
        return {"shuffle_epoch": self._epoch}

    def restore_position(self, state: dict) -> None:
        self._epoch = int(state.get("shuffle_epoch", 0))
        self._global_indexes = self._permutation()

    def reshard(self, process_index: int, process_count: int) -> int:
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        old, self._p, self._np = self._np, int(process_index), \
            int(process_count)
        return old

    def data(self, train: bool) -> Iterator:
        if train:
            def infinite():
                i = 0
                while True:
                    # the shard re-read each record, so shuffle() applies
                    cur = self._global_indexes[self._p::self._np]
                    yield self._data[cur[i % len(cur)]]
                    i += 1
            return infinite()
        local = self._global_indexes[self._p::self._np]
        return (self._data[i] for i in local)


class TransformedDataSet(AbstractDataSet):
    """A dataset with a transformer pipeline attached."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self) -> None:
        self.base.shuffle()

    def position_state(self) -> dict:
        return self.base.position_state()

    def restore_position(self, state: dict) -> None:
        self.base.restore_position(state)

    def reshard(self, process_index: int, process_count: int) -> int:
        """The root's shard moves, and every batching stage keeps the
        global batch: its local batch becomes ``batch x old / new``."""
        old = self.base.reshard(process_index, process_count)
        self.transformer.rescale(old, process_count)
        return old

    def data(self, train: bool) -> Iterator:
        return self.transformer(self.base.data(train))

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self.base, self.transformer >> transformer)


class DataSet:
    """Factory namespace."""

    @staticmethod
    def array(data: Sequence, distributed: bool = False,
              seed: int = 1) -> AbstractDataSet:
        if distributed:
            return DistributedDataSet(data, seed=seed)
        return LocalDataSet(data, seed=seed)

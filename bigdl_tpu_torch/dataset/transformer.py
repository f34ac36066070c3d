"""Transformers: composable iterator stages (port of
``bigdl_tpu/dataset/transformer.py``).  Compose with ``>>``:
``DataSet.array(samples) >> SampleToMiniBatch(20)``."""

from __future__ import annotations

from typing import Iterator, Optional

from bigdl_tpu_torch.dataset.sample import PaddingParam, batch_samples


class Transformer:
    """Iterator -> Iterator stage."""

    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    def chain(self, other: "Transformer") -> "ChainedTransformer":
        return self >> other

    def rescale(self, old_count: int, new_count: int) -> None:
        """The dataset under this stage went from ``old_count`` to
        ``new_count`` shards (an elastic resize); a batching stage keeps
        the global batch.  Others are unaffected."""


class ChainedTransformer(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def __call__(self, it):
        return self.second(self.first(it))

    def rescale(self, old_count: int, new_count: int) -> None:
        self.first.rescale(old_count, new_count)
        self.second.rescale(old_count, new_count)


class FnTransformer(Transformer):
    """Map a per-element function over the stream."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, it):
        return (self.fn(x) for x in it)


def rescaled_batch(batch_size: int, old_count: int, new_count: int) -> int:
    """The local batch that keeps ``batch_size x old_count`` rows a global
    batch over ``new_count`` shards."""
    total = int(batch_size) * int(old_count)
    if total % int(new_count):
        raise ValueError(
            f"a global batch of {total} rows does not split over "
            f"{new_count} processes")
    return total // int(new_count)


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size``, ragged features
    and labels padded by ``feature_padding``/``label_padding``; a short
    last batch is dropped unless ``drop_remainder=False``."""

    def __init__(self, batch_size: int,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 drop_remainder: bool = True):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_remainder = drop_remainder

    def rescale(self, old_count: int, new_count: int) -> None:
        self.batch_size = rescaled_batch(self.batch_size, old_count,
                                         new_count)

    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield batch_samples(buf, self.feature_padding,
                                    self.label_padding)
                buf = []
        if buf and not self.drop_remainder:
            yield batch_samples(buf, self.feature_padding,
                                self.label_padding)

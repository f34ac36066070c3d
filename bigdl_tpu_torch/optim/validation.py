"""Validation methods (port of ``bigdl_tpu/optim/validation.py``).

Each method's ``batch_stats(output, target) -> (value, count)`` is plain
tensor code on the output's device; ``value`` is a 0-d tensor, ``count`` a
Python int.  A :class:`ValidationResult` is an associative ``(value,
count)`` pair, so per-batch results add up across a validation pass.
:func:`validation_sums`, the loop of ``Optimizer.evaluate_with`` and of
``Evaluator``, keeps the running value on the card, in f64 (the reference
adds per-batch Python floats: the same f64 sums in the same order), and
the caller reads it back once a method at the end of the pass.
"""

from __future__ import annotations

import torch


class ValidationResult:
    """Associative (value, count) accumulator."""

    def __init__(self, value: float, count: float, fmt: str = "{:.6f}"):
        self.value = float(value)
        self.count = float(count)
        self.fmt = fmt

    @property
    def result(self) -> float:
        return self.value / max(self.count, 1e-12)

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.value + other.value,
                                self.count + other.count, self.fmt)

    def __repr__(self):
        return f"{self.fmt.format(self.result)} ({int(self.count)} samples)"


class ValidationMethod:
    name = "ValidationMethod"

    def batch_stats(self, output, target):
        """(summed value as a 0-d tensor, count) for one batch."""
        raise NotImplementedError

    def __call__(self, output, target) -> ValidationResult:
        v, c = self.batch_stats(output, target)
        return ValidationResult(float(v), float(c))

    def __repr__(self):
        return self.name


def _as_class_indices(target, output):
    """Class indices from (N,) indices, an (N, 1) column, or one-hot
    (N, C) when the class axis matches the output's."""
    if target.dim() == output.dim() and \
            target.shape[-1] == output.shape[-1] and output.shape[-1] > 1:
        return torch.argmax(target, dim=-1)
    if target.dim() == output.dim() and target.shape[-1] == 1:
        return target[..., 0]
    return target


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def batch_stats(self, output, target):
        pred = torch.argmax(output, dim=-1)
        target = _as_class_indices(target, output)
        return torch.sum(pred == target.to(pred.dtype)), target.shape[0]


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def batch_stats(self, output, target):
        # a stable descending sort: ties go to the lower index, as
        # lax.top_k gives them (torch.topk leaves their order open)
        top5 = torch.sort(output, dim=-1, descending=True,
                          stable=True).indices[..., :5]
        target = _as_class_indices(target, output)
        hit = torch.any(top5 == target.to(top5.dtype)[..., None], dim=-1)
        return torch.sum(hit), target.shape[0]


class Loss(ValidationMethod):
    """A criterion's value as a metric (CrossEntropy by default)."""
    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
        self.criterion = criterion or CrossEntropyCriterion()

    def batch_stats(self, output, target):
        n = output.shape[0] if hasattr(output, "shape") else 1
        return self.criterion.apply(output, target) * n, n


class MAE(ValidationMethod):
    """Mean absolute error, per sample over its non-batch axes."""
    name = "MAE"

    def batch_stats(self, output, target):
        err = torch.mean(torch.abs(output - target),
                         dim=tuple(range(1, output.dim())))
        return torch.sum(err), output.shape[0]


class HitRatio(ValidationMethod):
    """HR@k: scores over [positive, negatives...] a row; a hit when the
    positive (column 0) ranks in the top k."""
    name = "HitRatio"

    def __init__(self, k: int = 10):
        self.k = k

    def batch_stats(self, output, target=None):
        pos = output[:, 0:1]
        rank = torch.sum(output[:, 1:] > pos, dim=-1) + 1
        return torch.sum(rank <= self.k), output.shape[0]


class NDCG(ValidationMethod):
    """NDCG@k with the positive item at column 0."""
    name = "NDCG"

    def __init__(self, k: int = 10):
        self.k = k

    def batch_stats(self, output, target=None):
        pos = output[:, 0:1]
        rank = torch.sum(output[:, 1:] > pos, dim=-1) + 1
        gain = torch.where(rank <= self.k,
                           1.0 / torch.log2(rank.to(output.dtype) + 1.0),
                           torch.zeros((), dtype=output.dtype,
                                       device=output.device))
        return torch.sum(gain), output.shape[0]


class TreeNNAccuracy(ValidationMethod):
    """Accuracy of the root prediction of tree outputs (N, T, C), the
    root at t=0."""
    name = "TreeNNAccuracy"

    def batch_stats(self, output, target):
        pred = torch.argmax(output[:, 0], dim=-1)
        return torch.sum(pred == target.to(pred.dtype)), target.shape[0]


def validation_sums(net: torch.nn.Module, dataset, methods):
    """``dataset``'s batches through ``net`` in eval mode under
    ``torch.no_grad()``, on the device of ``net``'s parameters: ``(sums,
    counts)``, each ``{method name: ...}``, the sums f64 0-d tensors on
    that device.  Empty dicts when the dataset yields no batch."""
    import numpy as np

    from bigdl_tpu_torch.dataset.prefetch import tree_map
    from bigdl_tpu_torch.dataset.sample import MiniBatch
    device = next(net.parameters()).device
    to_dev = lambda a: (a if isinstance(a, torch.Tensor)  # noqa: E731
                        else torch.from_numpy(np.asarray(a))).to(device)
    sums: dict = {}
    counts: dict = {}
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            for batch in dataset.data(train=False):
                if not isinstance(batch, MiniBatch):
                    raise TypeError("validation dataset must yield "
                                    "MiniBatch (attach SampleToMiniBatch)")
                out = net(tree_map(to_dev, batch.input))
                tgt = tree_map(to_dev, batch.target)
                for m in methods:
                    v, c = m.batch_stats(out, tgt)
                    v = torch.as_tensor(v, device=device).double()
                    sums[m.name] = sums[m.name] + v \
                        if m.name in sums else v
                    counts[m.name] = counts.get(m.name, 0) + c
    finally:
        net.train(was_training)
    return sums, counts

"""Criteria (port of ``bigdl_tpu/nn/criterion.py``).

``apply(input, target) -> scalar`` is plain tensor code, differentiated by
autograd.  Class targets are 0-based integer tensors.  ``size_average``
(default True) averages over the batch, as in the reference.  A pair
input (``MarginRankingCriterion``, ``KLDCriterion``, ...) is a tuple of
two tensors.  Absolute values are :func:`~bigdl_tpu_torch.nn.shape_ops.
right_abs`, whose gradient at 0 is the reference's.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.shape_ops import right_abs


class Criterion:
    """Base class: ``forward(input, target)`` returns the loss;
    ``backward(input, target)`` returns d loss / d input."""

    size_average: bool = True

    def apply(self, input, target):
        raise NotImplementedError

    def forward(self, input, target):
        self.output = self.apply(input, target)
        return self.output

    def __call__(self, input, target):
        return self.forward(input, target)

    def backward(self, input, target):
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(self.apply(x, target), x)
        return self.grad_input

    def _reduce(self, losses):
        """Mean when ``size_average`` (the reference default), else sum."""
        return torch.mean(losses) if self.size_average else torch.sum(losses)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (``logits=True``:
    over raw scores, log-softmax applied first), with optional class
    ``weights`` and an ``ignore_index`` whose targets count nothing.  The
    mean divides by the summed weights of the counted targets."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True, logits: bool = False,
                 ignore_index: int = -100):
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average
        self.logits = logits
        self.ignore_index = ignore_index

    def apply(self, input, target):
        logp = torch.log_softmax(input, dim=-1) if self.logits else input
        t = target.long()
        valid = t != self.ignore_index
        t_safe = torch.where(valid, t, torch.zeros_like(t))
        picked = torch.gather(logp, -1, t_safe[..., None])[..., 0]
        if self.weights is not None:
            w = self.weights.to(device=logp.device, dtype=picked.dtype)[t_safe]
        else:
            w = torch.ones_like(picked)
        w = torch.where(valid, w, torch.zeros_like(w))
        total = -torch.sum(w * picked)
        if self.size_average:
            return total / torch.clamp(torch.sum(w), min=1e-8)
        return total


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        self._nll = ClassNLLCriterion(weights, size_average, logits=True)
        self.size_average = size_average

    def apply(self, input, target):
        return self._nll.apply(input, target)


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep of (N, T, ...) input: the
    per-step losses are summed over T, then divided by T iff
    ``size_average`` (default False).  Folding (N, T) into one batch, a
    batch-averaging inner criterion already yields ``sum_t(loss_t) / T``
    and a summing one ``sum_t(loss_t)``; the rule below undoes or keeps
    that division."""

    def __init__(self, critrn: Criterion, size_average: bool = False):
        self.critrn = critrn
        self.size_average = size_average

    def apply(self, input, target):
        T = input.shape[1]
        x = input.reshape((-1,) + tuple(input.shape[2:]))
        t = target.reshape((-1,) + tuple(target.shape[2:]))
        loss = self.critrn.apply(x, t)
        if getattr(self.critrn, "size_average", True):
            return loss if self.size_average else loss * T
        return loss / T if self.size_average else loss


class MSECriterion(Criterion):
    """Squared error, averaged over every element (``size_average``) or
    summed."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce((input - target) ** 2)


class BCECriterion(Criterion):
    """Binary cross entropy on probabilities (reference
    ``BCECriterion.scala``), in f32; the input is clamped to ``[eps, 1 -
    eps]`` with the f32 eps (1 - 1e-12 is 1.0 in f32, and a saturated
    sigmoid would give log(0))."""

    def __init__(self, weights: Optional[torch.Tensor] = None,
                 size_average: bool = True):
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.size_average = size_average

    def apply(self, input, target):
        eps = torch.finfo(torch.promote_types(input.dtype,
                                              torch.float32)).eps
        x = torch.clamp(input.float(), eps, 1.0 - eps)
        loss = -(target * torch.log(x) + (1.0 - target) * torch.log1p(-x))
        if self.weights is not None:
            loss = loss * self.weights.to(loss.device)
        return self._reduce(loss)


class BCEWithLogitsCriterion(Criterion):
    """Binary cross entropy on logits, in the stable form
    ``max(x, 0) - x * t + log1p(exp(-|x|))``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        loss = torch.clamp(input, min=0) - input * target + torch.log1p(
            torch.exp(-input.abs()))
        return self._reduce(loss)


class AbsCriterion(Criterion):
    """``|input - target|``, averaged (``size_average``) or summed."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce(right_abs(input - target))


class SmoothL1Criterion(Criterion):
    """Huber loss with delta 1."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        d = torch.abs(input - target)
        return self._reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5))


class DistKLDivCriterion(Criterion):
    """KL(target || input) with ``input`` log-probabilities: summed, then
    divided by the batch size when ``size_average``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        t = target.to(input.dtype)
        loss = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-12))
                                       - input), torch.zeros_like(input))
        total = torch.sum(loss)
        return total / input.shape[0] if self.size_average else total


class KLDCriterion(Criterion):
    """The VAE latent's KL term: input ``(mean, log_var)``, target unused;
    summed over the latent, averaged over the batch."""

    def apply(self, input, target=None):
        mean, log_var = input
        kl = 0.5 * torch.sum(mean ** 2 + torch.exp(log_var) - 1.0 - log_var,
                             -1)
        return torch.mean(kl)


class GaussianCriterion(Criterion):
    """Negative log-likelihood of ``target`` under a diagonal Gaussian,
    input ``(mean, log_var)``; summed, divided by the batch size."""

    def apply(self, input, target):
        mean, log_var = input
        nll = 0.5 * (math.log(2 * math.pi) + log_var
                     + (target - mean) ** 2 / torch.exp(log_var))
        return torch.sum(nll) / target.shape[0]


class MarginCriterion(Criterion):
    """Hinge ``max(0, margin - input * target)``, target in {-1, 1};
    squared when ``squared``."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def apply(self, input, target):
        loss = torch.clamp(self.margin - input * target, min=0.0)
        if self.squared:
            loss = loss * loss
        return self._reduce(loss)


class MarginRankingCriterion(Criterion):
    """``max(0, -target * (x1 - x2) + margin)``, input ``(x1, x2)``,
    target +-1."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        return self._reduce(torch.clamp(-target * (x1 - x2) + self.margin,
                                        min=0.0))


class CosineEmbeddingCriterion(Criterion):
    """Input ``(x1, x2)``: ``1 - cos`` where target is 1, ``max(0, cos -
    margin)`` where it is -1."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        den = torch.clamp(torch.linalg.vector_norm(x1, dim=-1)
                          * torch.linalg.vector_norm(x2, dim=-1), min=1e-12)
        cos = torch.sum(x1 * x2, -1) / den
        return self._reduce(torch.where(
            target > 0, 1.0 - cos, torch.clamp(cos - self.margin, min=0.0)))


class HingeEmbeddingCriterion(Criterion):
    """``input`` where target is 1, ``max(0, margin - input)`` where it is
    -1."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce(torch.where(
            target > 0, input, torch.clamp(self.margin - input, min=0.0)))


class SoftMarginCriterion(Criterion):
    """``log(1 + exp(-input * target))``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce(torch.log1p(torch.exp(-input * target)))


class L1Cost(Criterion):
    """``sum |input|``; the target is ignored."""

    def apply(self, input, target=None):
        return torch.sum(right_abs(input))


class DiceCoefficientCriterion(Criterion):
    """``1 - (2 sum(x t) + eps) / (sum x + sum t + eps)`` per sample,
    averaged over the batch."""

    def __init__(self, epsilon: float = 1.0):
        self.epsilon = epsilon

    def apply(self, input, target):
        axes = tuple(range(1, input.dim()))
        num = 2.0 * torch.sum(input * target, axes) + self.epsilon
        den = torch.sum(input, axes) + torch.sum(target, axes) + self.epsilon
        return torch.mean(1.0 - num / den)


class MultiLabelSoftMarginCriterion(Criterion):
    """Per-label logistic loss on raw scores, targets in {0, 1}."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce(-(target * F.logsigmoid(input)
                              + (1 - target) * F.logsigmoid(-input)))


class MultiCriterion(Criterion):
    """Weighted sum of criteria on the same ``(input, target)``."""

    def __init__(self):
        self.criterions: list = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append((criterion, weight))
        return self

    def apply(self, input, target):
        return sum(w * c.apply(input, target) for c, w in self.criterions)


class ParallelCriterion(Criterion):
    """Weighted sum of the i-th criterion on ``(input[i], target[i])``
    (``target`` itself for each when ``repeat_target``)."""

    def __init__(self, repeat_target: bool = False):
        self.criterions: list = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append((criterion, weight))
        return self

    def apply(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(self.criterions):
            t = target if self.repeat_target else target[i]
            total = total + w * c.apply(input[i], t)
        return total


class PGCriterion(Criterion):
    """Policy gradient: ``-log(input) * target`` (input probabilities,
    target the rewards), summed unless ``size_average``."""

    def __init__(self, size_average: bool = False):
        self.size_average = size_average

    def apply(self, input, target):
        return self._reduce(-torch.log(torch.clamp(input, min=1e-12))
                            * target)


class MultiLabelMarginCriterion(Criterion):
    """Multi-class multi-label hinge: targets are each row's 0-based class
    indices, padded with -1; for each target k and each class j that is
    not a target, ``max(0, 1 - (x[k] - x[j]))``, summed over the row and
    divided by the class count."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def apply(self, input, target):
        t = target.long()
        valid = t >= 0
        t_safe = torch.where(valid, t, torch.zeros_like(t))
        tgt_scores = torch.gather(input, -1, t_safe)
        # counted, so a padding slot (t_safe 0, not valid) cannot unmark a
        # genuine class-0 target
        hits = torch.zeros(input.shape, dtype=torch.int64,
                           device=input.device).scatter_add_(
            1, t_safe, valid.long())
        is_target = hits > 0
        margins = 1.0 - (tgt_scores[:, :, None] - input[:, None, :])
        keep = valid[:, :, None] & ~is_target[:, None, :]
        margins = torch.where(keep, torch.clamp(margins, min=0.0),
                              torch.zeros_like(margins))
        return self._reduce(torch.sum(margins, (1, 2)) / input.shape[-1])


class SoftmaxWithCriterion(Criterion):
    """Caffe's softmax loss on NCHW score maps, target ``(N, H, W)`` class
    ids; ``ignore_label`` pixels count nothing; ``normalize_mode``
    ``"VALID"`` divides by the counted pixels, ``"BATCH_SIZE"`` by N,
    anything else sums."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def apply(self, input, target):
        logp = torch.log_softmax(input, 1)
        t = target.long()
        valid = torch.ones_like(t, dtype=torch.bool) \
            if self.ignore_label is None else t != self.ignore_label
        t_safe = torch.where(valid, t, torch.zeros_like(t))
        picked = torch.gather(logp, 1, t_safe[:, None])[:, 0]
        total = -torch.sum(torch.where(valid, picked,
                                       torch.zeros_like(picked)))
        if self.normalize_mode == "VALID":
            return total / torch.clamp(torch.sum(valid), min=1)
        if self.normalize_mode == "BATCH_SIZE":
            return total / input.shape[0]
        return total


class CosineDistanceCriterion(Criterion):
    """``1 - cos(input, target)`` per sample (each flattened)."""

    def __init__(self, size_average: bool = True, eps: float = 1e-12):
        self.size_average = size_average
        self.eps = eps

    def apply(self, input, target):
        x = input.reshape(input.shape[0], -1)
        y = target.reshape(target.shape[0], -1)
        num = torch.sum(x * y, -1)
        den = torch.linalg.vector_norm(x, dim=-1) \
            * torch.linalg.vector_norm(y, dim=-1)
        return self._reduce(1.0 - num / torch.clamp(den, min=self.eps))


class CosineProximityCriterion(Criterion):
    """Keras ``cosine_proximity``: minus the mean cosine similarity of the
    L2-normalized samples."""

    def __init__(self, eps: float = 1e-12):
        self.eps = eps

    def apply(self, input, target):
        x = input.reshape(input.shape[0], -1)
        y = target.reshape(target.shape[0], -1)
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                      keepdim=True),
                             min=self.eps)
        yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1,
                                                      keepdim=True),
                             min=self.eps)
        return -torch.mean(torch.sum(xn * yn, -1))


class DotProductCriterion(Criterion):
    """``sum(input * target)``; divided by the batch size for a 2-D input
    when ``size_average`` (the gradient is the target: a surrogate
    loss)."""

    def __init__(self, size_average: bool = False):
        self.size_average = size_average

    def apply(self, input, target):
        dot = torch.sum(input * target)
        if self.size_average and input.dim() == 2:
            return dot / input.shape[0]
        return dot


class KullbackLeiblerDivergenceCriterion(Criterion):
    """Keras ``kld`` on probabilities, both clipped to ``[eps, 1]``:
    per-sample ``sum y log(y / p)``, averaged."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def apply(self, input, target):
        y = torch.clamp(target, self.eps, 1.0)
        p = torch.clamp(input, self.eps, 1.0)
        return torch.mean(torch.sum((y * torch.log(y / p)).reshape(
            input.shape[0], -1), -1))


class L1HingeEmbeddingCriterion(Criterion):
    """Input ``(x1, x2)``: their L1 distance where the label is 1,
    ``max(0, margin - distance)`` where it is -1."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        x1, x2 = input
        d = torch.sum(right_abs(x1 - x2).reshape(x1.shape[0], -1), -1)
        y = target.reshape(-1)
        return self._reduce(torch.where(
            y > 0, d, torch.clamp(self.margin - d, min=0.0)))


class MeanAbsolutePercentageCriterion(Criterion):
    """Keras ``mape``: ``100 * mean(|t - x| / max(|t|, eps))``."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def apply(self, input, target):
        diff = right_abs(target - input) / torch.clamp(torch.abs(target),
                                                       min=self.eps)
        return 100.0 * torch.mean(diff)


class MeanSquaredLogarithmicCriterion(Criterion):
    """Keras ``msle``: ``mean((log(max(x, eps) + 1) - log(max(t, eps) +
    1))^2)``."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def apply(self, input, target):
        a = torch.log(torch.clamp(input, min=self.eps) + 1.0)
        b = torch.log(torch.clamp(target, min=self.eps) + 1.0)
        return torch.mean((a - b) ** 2)


class MultiMarginCriterion(Criterion):
    """Multi-class margin loss: per row ``sum_{j != y} max(0, margin -
    x[y] + x[j])^p / dim`` (p 1 or 2), each row weighted by its class's
    weight when ``weights`` is given."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        if p not in (1, 2):
            raise ValueError("MultiMarginCriterion supports p=1 or 2")
        self.p = p
        self.weights = None if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32)
        self.margin = margin
        self.size_average = size_average

    def apply(self, input, target):
        t = target.long().reshape(-1)
        x_y = torch.gather(input, -1, t[:, None])
        m = torch.clamp(self.margin - x_y + input, min=0.0)
        if self.p == 2:
            m = m * m
        if self.weights is not None:
            m = m * self.weights.to(device=m.device, dtype=m.dtype)[t][:, None]
        # the target class's own column counts nothing
        m = m * (1.0 - F.one_hot(t, input.shape[-1]).to(input.dtype))
        return self._reduce(torch.sum(m, -1) / input.shape[-1])


class PoissonCriterion(Criterion):
    """Keras ``poisson``: ``mean(x - t * log(max(x, eps)))``."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def apply(self, input, target):
        return torch.mean(input - target * torch.log(
            torch.clamp(input, min=self.eps)))


def _regsplex(n: int) -> np.ndarray:
    """The n+1 vertices of a regular n-simplex as rows of unit norm whose
    mutual dot products are equal; in float64 on the host (the norm
    recurrence loses accuracy in f32)."""
    a = np.zeros((n + 1, n), dtype=np.float64)
    for k in range(n):
        prior = np.linalg.norm(a[k, :k])
        a[k, k] = 1.0 if k == 0 else np.sqrt(1.0 - prior * prior)
        c = (a[k, k] ** 2 - 1.0 - 1.0 / n) / a[k, k]
        a[k + 1:, k] = c
    return a


class ClassSimplexCriterion(Criterion):
    """MSE against each class's vertex of a regular simplex (``n_classes``
    points in ``n_classes - 1`` dimensions, padded with a 0 column to the
    input's width), averaged over every element."""

    def __init__(self, n_classes: int):
        if n_classes < 2:
            raise ValueError("n_classes must be > 1")
        self.n_classes = n_classes
        self.simplex = torch.from_numpy(
            _regsplex(n_classes - 1).astype(np.float32))

    def apply(self, input, target):
        t = target.long().reshape(-1)
        vertices = self.simplex.to(device=input.device, dtype=input.dtype)[t]
        emb = F.pad(vertices, (0, 1))
        return torch.mean((input - emb) ** 2)


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's box loss: ``d = (x - gt) * w_in``, ``0.5 sigma^2 d^2``
    where ``|d| < 1 / sigma^2`` and ``|d| - 0.5 / sigma^2`` elsewhere,
    times ``w_out``, summed and divided by ``num`` (if > 0).  Target
    ``gt``, ``(gt,)`` or ``(gt, w_in, w_out)``."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        self.sigma2 = sigma * sigma
        self.num = num

    def apply(self, input, target):
        if isinstance(target, (tuple, list)):
            if len(target) == 3:
                gt, w_in, w_out = target
            elif len(target) == 1:
                gt, w_in, w_out = target[0], None, None
            else:
                raise ValueError(
                    "target must be gt or (gt,) or (gt, w_in, w_out); "
                    f"got {len(target)} elements")
        else:
            gt, w_in, w_out = target, None, None
        d = input - gt
        if w_in is not None:
            d = d * w_in
        ad = torch.abs(d)
        per = torch.where(ad < 1.0 / self.sigma2, 0.5 * self.sigma2 * d * d,
                          ad - 0.5 / self.sigma2)
        if w_out is not None:
            per = per * w_out
        total = torch.sum(per)
        return total / self.num if self.num > 0 else total


class TimeDistributedMaskCriterion(Criterion):
    """A criterion at every time step of ``(N, T, ...)`` input, each step
    on its own as a batch of one (``torch.func.vmap``: a weighted inner
    criterion that averages divides by that step's own weight); steps
    whose target equals ``padding_value`` count nothing, and the mean runs
    over the other steps."""

    def __init__(self, criterion: Criterion, padding_value: int = 0):
        self.criterion = criterion
        self.padding_value = padding_value

    def apply(self, input, target):
        N, T = target.shape[0], target.shape[1]
        flat_in = input.reshape((N * T,) + tuple(input.shape[2:]))
        flat_t = target.reshape((N * T,) + tuple(target.shape[2:]))
        valid = (flat_t != self.padding_value).reshape(N * T, -1).all(-1)
        inner = self.criterion
        per = torch.func.vmap(
            lambda x, t: inner.apply(x[None], t[None]))(flat_in, flat_t)
        total = torch.sum(torch.where(valid, per, torch.zeros_like(per)))
        return total / torch.clamp(torch.sum(valid), min=1)


class TransformerCriterion(Criterion):
    """Run ``input`` and/or ``target`` through a module each (in eval mode,
    on the module's current weights, copied to the input's device for the
    call), then ``criterion`` on the results (perceptual losses)."""

    def __init__(self, criterion: Criterion, input_transformer=None,
                 target_transformer=None):
        self.criterion = criterion
        self.input_transformer = input_transformer
        self.target_transformer = target_transformer

    @staticmethod
    def _run(mod, x):
        if mod is None:
            return x
        tensors = {k: v.to(x.device) for k, v in
                   itertools.chain(mod.named_parameters(),
                                   mod.named_buffers())}
        was_training = mod.training
        mod.eval()
        try:
            return torch.func.functional_call(mod, tensors, (x,))
        finally:
            mod.train(was_training)

    def apply(self, input, target):
        return self.criterion.apply(self._run(self.input_transformer, input),
                                    self._run(self.target_transformer,
                                              target))


class CategoricalCrossEntropy(Criterion):
    """Keras ``categorical_crossentropy``: probabilities in (log
    probabilities when ``log_prob_input``), one-hot or soft targets of the
    input's rank, or integer class targets; averaged over the samples."""

    def __init__(self, log_prob_input: bool = False, eps: float = 1e-7):
        self.log_prob_input = log_prob_input
        self.eps = eps

    def apply(self, input, target):
        logp = input if self.log_prob_input \
            else torch.log(torch.clamp(input, self.eps, 1.0))
        if target.dim() == input.dim():
            return -torch.mean(torch.sum(target * logp, -1))
        picked = torch.gather(logp, -1, target.long()[..., None])[..., 0]
        return -torch.mean(picked)

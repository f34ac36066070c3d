"""Table-op, distance and similarity, gating and stochastic
regularization layers (port of ``bigdl_tpu/nn/tensor_extras.py``).
Tables are Python tuples or lists.

The penalty layers (``L1Penalty``, ``NegativeEntropyPenalty``,
``ActivityRegularization``) are the identity in ``forward`` and expose
``penalty(x)`` to add to the loss, as the reference's do.  The stochastic
ones (``GaussianDropout``, ``GaussianNoise``, ``GaussianSampler``) draw
from ``self.generator``, a ``torch.Generator`` on the input's device that
``LocalOptimizer`` sets for its training copy.  ``Bottle`` and
``MapTable`` hold their inner module's tree as their own
(:class:`~bigdl_tpu_torch.nn.module.Wrapper`), as the reference's do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module, Stochastic, Wrapper
from bigdl_tpu_torch.nn.shape_ops import right_abs


def _param(*shape):
    return torch.nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Maxout(Module):
    """A Linear layer of ``pool`` pieces an output, then the max over the
    pieces: weight (pool*out, in), its rows grouped (pool, out); bias
    (pool*out, zeros)."""

    def __init__(self, input_size: int, output_size: int, pool: int,
                 with_bias: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.pool = pool
        self.with_bias = with_bias
        self.weight_init = weight_init or RandomUniform()
        self.weight = _param(pool * output_size, input_size)
        self.bias = _param(pool * output_size) if with_bias else None

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.input_size,
            self.output_size))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        y = y.reshape(y.shape[0], self.pool, self.output_size)
        return torch.amax(y, dim=1)  # ties share the gradient, as jnp.max


class Highway(Module):
    """Highway block ``t * g(x W^T + b) + (1 - t) * x`` with the gate
    ``t = sigmoid(x Wg^T + bg)``; ``g`` is ``activation`` (tanh by
    default).  Biases start at zero."""

    def __init__(self, size: int, with_bias: bool = True, activation=None,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.size = size
        self.with_bias = with_bias
        self.activation = activation or torch.tanh
        self.weight_init = weight_init or RandomUniform()
        self.gate_weight = _param(size, size)
        self.weight = _param(size, size)
        self.gate_bias = _param(size) if with_bias else None
        self.bias = _param(size) if with_bias else None

    def reset_parameters(self, generator):
        for w in (self.gate_weight, self.weight):
            w.data.copy_(self.weight_init.init(generator, w.shape,
                                               self.size, self.size))
        if self.with_bias:
            self.gate_bias.data.zero_()
            self.bias.data.zero_()

    def forward(self, x):
        t = x @ self.gate_weight.T
        h = x @ self.weight.T
        if self.with_bias:
            t = t + self.gate_bias
            h = h + self.bias
        t = torch.sigmoid(t)
        return t * self.activation(h) + (1 - t) * x


class CAveTable(Module):
    """Elementwise average of a table's entries."""

    def forward(self, x):
        return sum(x) / len(x)


# ------------------------------------------------------------- table math
class MM(Module):
    """Batched matrix product of a 2-table, either side transposed."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False,
                 name=None):
        super().__init__(name)
        self.trans_a = trans_a
        self.trans_b = trans_b

    def forward(self, x):
        a, b = x
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Batched matrix-vector product of a (matrix, vector) table."""

    def __init__(self, trans: bool = False, name=None):
        super().__init__(name)
        self.trans = trans

    def forward(self, x):
        m, v = x
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(Module):
    """Row-wise dot product of a 2-table."""

    def forward(self, x):
        a, b = x
        return (a * b).sum(-1)


class CrossProduct(Module):
    """Every pairwise dot product of a table's entries, (N, K(K-1)/2) in
    (i < j) order."""

    def forward(self, x):
        outs = [(x[i] * x[j]).sum(-1)
                for i in range(len(x)) for j in range(i + 1, len(x))]
        return torch.stack(outs, -1)


class PairwiseDistance(Module):
    """The ``norm``-norm distance of a 2-table's rows."""

    def __init__(self, norm: int = 2, name=None):
        super().__init__(name)
        self.norm = norm

    def forward(self, x):
        a, b = x
        return (right_abs(a - b) ** self.norm).sum(-1) ** (1.0 / self.norm)


def _norm_at_least(x, eps=1e-12, keepdim=False):
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim),
                       min=eps)


class CosineDistance(Module):
    """The cosine similarity of a 2-table's rows (a similarity despite the
    name, as in Torch)."""

    def forward(self, x):
        a, b = x
        return (a * b).sum(-1) / (_norm_at_least(a) * _norm_at_least(b))


# --------------------------------------------------- parameterized distances
class Bilinear(Module):
    """``y_o = x1^T W_o x2 + b_o`` over a 2-table: ``weight`` (out, in1,
    in2), ``bias`` (out, zeros)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.in1, self.in2, self.out = input_size1, input_size2, output_size
        self.bias_res = bias_res
        self.weight_init = weight_init or RandomUniform()
        self.weight = _param(output_size, input_size1, input_size2)
        self.bias = _param(output_size) if bias_res else None

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.in1 * self.in2, self.out))
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x):
        x1, x2 = x
        y = torch.einsum("ni,oij,nj->no", x1, self.weight, x2)
        if self.bias is not None:
            y = y + self.bias
        return y


class Cosine(Module):
    """Cosine similarity of the input's rows with each row of ``weight``
    (out, in)."""

    def __init__(self, input_size: int, output_size: int,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.weight_init = weight_init or RandomUniform()
        self.weight = _param(output_size, input_size)

    def reset_parameters(self, generator):
        self.weight.data.copy_(self.weight_init.init(
            generator, self.weight.shape, self.input_size,
            self.output_size))

    def forward(self, x):
        w = self.weight
        return (x @ w.T) / _norm_at_least(x, keepdim=True) \
            / _norm_at_least(w)


class Euclidean(Module):
    """The L2 distance of the input's rows to each row of ``weight`` (out,
    in)."""

    def __init__(self, input_size: int, output_size: int,
                 weight_init: Optional[InitializationMethod] = None,
                 name=None):
        super().__init__(name)
        self.input_size = input_size
        self.output_size = output_size
        self.weight_init = weight_init or RandomUniform()
        self.weight = _param(output_size, input_size)

    reset_parameters = Cosine.reset_parameters

    def forward(self, x):
        diff = x[:, None, :] - self.weight[None]
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-24))


class Add(Module):
    """A learnable bias (``input_size``, zeros)."""

    def __init__(self, input_size: int, name=None):
        super().__init__(name)
        self.input_size = input_size
        self.bias = _param(input_size)

    def reset_parameters(self, generator):
        self.bias.data.zero_()

    def forward(self, x):
        return x + self.bias


class Mul(Module):
    """One learnable scalar gain, ``weight`` of shape () at 1."""

    def __init__(self, name=None):
        super().__init__(name)
        self.weight = torch.nn.Parameter(torch.ones(()), requires_grad=False)

    def reset_parameters(self, generator):
        self.weight.data.fill_(1.0)

    def forward(self, x):
        return x * self.weight


# ------------------------------------------------------------ table utils
class MixtureTable(Module):
    """Blend experts by a gater: (gater (N, K), experts) to ``sum_k g_k
    e_k``; the experts a K-table of (N, ...) or one (N, K, ...)."""

    def forward(self, x):
        gater, experts = x
        if isinstance(experts, (list, tuple)):
            experts = torch.stack(tuple(experts), 1)
        g = gater.reshape(tuple(gater.shape) + (1,) * (experts.dim() - 2))
        return (g * experts).sum(1)


class MaskedSelect(Module):
    """The elements of ``x`` where ``mask`` is not 0, flattened (a
    data-dependent shape)."""

    def forward(self, x):
        t, mask = x
        return t[mask.bool()]


class Reverse(Module):
    """Flip along ``dim`` (0-based)."""

    def __init__(self, dim: int = 0, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return torch.flip(x, (self.dim,))


class Tile(Module):
    """Repeat ``copies`` times along ``dim``."""

    def __init__(self, dim: int = 0, copies: int = 2, name=None):
        super().__init__(name)
        self.dim = dim
        self.copies = copies

    def forward(self, x):
        reps = [1] * x.dim()
        reps[self.dim] = self.copies
        return x.repeat(*reps)


class Negative(Module):
    """``-x``."""

    def forward(self, x):
        return -x


class InferReshape(Module):
    """Reshape to ``size``, where 0 copies the input's size at that place
    and -1 is inferred; with ``batch_mode`` the batch axis is kept in
    front and ``size`` describes the rest."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False,
                 name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def forward(self, x):
        in_shape = x.shape[1:] if self.batch_mode else x.shape
        out = [in_shape[i] if s == 0 else s for i, s in enumerate(self.size)]
        if self.batch_mode:
            out = [x.shape[0]] + out
        return x.reshape(tuple(out))


class NarrowTable(Module):
    """``length`` entries of a table from ``offset`` (0-based); one entry
    comes back alone."""

    def __init__(self, offset: int, length: int = 1, name=None):
        super().__init__(name)
        self.offset = offset
        self.length = length

    def forward(self, x):
        out = tuple(x[self.offset:self.offset + self.length])
        return out[0] if self.length == 1 else out


class BifurcateSplitTable(Module):
    """Split a tensor in two halves along ``dim`` (the second one longer
    for an odd size)."""

    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        half = x.shape[self.dim] // 2
        return (x.narrow(self.dim, 0, half),
                x.narrow(self.dim, half, x.shape[self.dim] - half))


class Bottle(Wrapper):
    """Apply ``module`` to the input with its leading axes flattened into
    one, then restore them: with ``n_input_dims`` 2, (N, T, C) runs as
    (N*T, C)."""

    def __init__(self, module: Module, n_input_dims: int = 2, name=None):
        super().__init__(module, name)
        self.n_input_dims = n_input_dims

    def forward(self, x):
        lead = tuple(x.shape[:-(self.n_input_dims - 1)]) \
            if self.n_input_dims > 1 else tuple(x.shape)
        y = self.inner(x.reshape((-1,) + tuple(x.shape[len(lead):])))
        return y.reshape(lead + tuple(y.shape[1:]))


class MapTable(Wrapper):
    """Apply one module (one set of weights) to every entry of a table."""

    def __init__(self, module: Module, name=None):
        super().__init__(module, name)

    def forward(self, x):
        return tuple(self.inner(e) for e in x)


# --------------------------------------------------- gradient / stochastic
class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, the_lambda):
        ctx.the_lambda = the_lambda
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.the_lambda * g, None


class GradientReversal(Module):
    """The identity forward, ``-lambda`` times the gradient backward
    (domain-adversarial training)."""

    def __init__(self, the_lambda: float = 1.0, name=None):
        super().__init__(name)
        self.the_lambda = the_lambda

    def forward(self, x):
        return _Reverse.apply(x, self.the_lambda)


def _normal(layer: Stochastic, like):
    if layer.generator is None:
        raise ValueError(f"{layer.name} needs a generator")
    return torch.randn(like.shape, generator=layer.generator,
                       device=like.device).to(like.dtype)


class GaussianDropout(Stochastic):
    """Multiplicative N(1, rate / (1 - rate)) noise in training mode."""

    def __init__(self, rate: float, name=None):
        super().__init__(name)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"rate must be in [0, 1), got {rate}")
        self.rate = rate

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * _normal(self, x))


class GaussianNoise(Stochastic):
    """Additive N(0, stddev) noise in training mode."""

    def __init__(self, stddev: float, name=None):
        super().__init__(name)
        self.stddev = stddev

    def forward(self, x):
        if not self.training:
            return x
        return x + self.stddev * _normal(self, x)


class GaussianSampler(Stochastic):
    """The VAE reparameterization: (mean, log_var) to ``mean +
    exp(log_var / 2) * eps``, eps ~ N(0, 1), in every mode."""

    def forward(self, x):
        mean, log_var = x
        return mean + torch.exp(log_var * 0.5) * _normal(self, mean)


# ------------------------------------------------------- penalty layers
class L1Penalty(Module):
    """The identity, with an L1 activity penalty: ``penalty(x)``, averaged
    over the batch with ``size_average``."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 name=None):
        super().__init__(name)
        self.l1weight = l1weight
        self.size_average = size_average

    def penalty(self, x):
        p = self.l1weight * right_abs(x).sum()
        return p / x.shape[0] if self.size_average else p

    def forward(self, x):
        return x


class NegativeEntropyPenalty(Module):
    """The identity, with a ``beta * sum(p log p)`` penalty (the negative
    entropy) that rewards diverse distributions."""

    def __init__(self, beta: float = 0.01, name=None):
        super().__init__(name)
        self.beta = beta

    def penalty(self, x):
        return self.beta * (x * torch.log(x + 1e-12)).sum()

    def forward(self, x):
        return x


class ActivityRegularization(Module):
    """The identity, with L1 and L2 activity penalties."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0, name=None):
        super().__init__(name)
        self.l1 = l1
        self.l2 = l2

    def penalty(self, x):
        return self.l1 * right_abs(x).sum() + self.l2 * (x * x).sum()

    def forward(self, x):
        return x


class BinaryThreshold(Module):
    """1 where ``x > th``, else 0, in ``x``'s dtype."""

    def __init__(self, th: float = 1e-6, name=None):
        super().__init__(name)
        self.th = th

    def forward(self, x):
        return (x > self.th).to(x.dtype)

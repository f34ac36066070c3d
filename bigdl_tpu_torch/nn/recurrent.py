"""Recurrent stack (port of ``bigdl_tpu/nn/recurrent.py``): the cells
``RnnCell``, ``LSTM``, ``LSTMPeephole``, ``GRU``, ``ConvLSTMPeephole``,
``ConvLSTMPeephole3D`` and ``MultiRNNCell``, and the wrappers
``Recurrent``, ``BiRecurrent``, ``RecurrentDecoder`` and
``TimeDistributed``.

Layout is batch-major ``(N, T, features)`` at every public face, as in the
reference.  Where the reference scans a step body with ``lax.scan``,
:class:`Recurrent` runs a Python loop over T; autograd records each step
and sums the gradients of the shared weights over them.

The input-side projection has no sequential dependency, so a cell may
hoist it out of the loop (:meth:`Cell.hoist`): one ``(T*N, D) @ (D, G)``
product for the whole sequence, leaving only the recurrent product inside
the loop.  Loop-invariant tensors a hoisted step needs (the LSTM's
transposed recurrent weight ``w_t``) come from :meth:`Cell.loop_invariants`,
computed once per forward.

The LSTM's hoisted step is the fused cell of ``ops/lstm_cell.py``: the
Hopper kernels for a CUDA tensor, their plain versions for a CPU tensor.
As in the reference, :class:`MultiRNNCell` sends only layer 0 through the
hoisted step (and so through the kernel); deeper layers consume in-loop
outputs and run :meth:`LSTM.step`, one ``[x, h] @ W.T + b`` product and
the plain gate chain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.initialization import RandomUniform
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.lstm_cell import lstm_cell


def _uniform(generator, shape, fan_in):
    return RandomUniform().init(generator, shape, fan_in, fan_in)


def _param(*shape):
    return torch.nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Cell(Module):
    """Recurrent cell contract: ``step(x_t, hidden) -> (y_t, hidden)``
    plus ``initial_hidden(batch, like)``; optionally ``hoist``,
    ``loop_invariants`` and ``step_hoisted``.  Called standalone, a cell
    acts on one timestep: ``cell((x_t, hidden)) -> (y_t, hidden)``."""

    hidden_size: int

    def initial_hidden(self, batch_size: int, like: torch.Tensor):
        """Zero state for ``batch_size`` rows, on ``like``'s device and
        (when floating) in its dtype."""
        raise NotImplementedError

    def step(self, x_t, hidden):
        raise NotImplementedError

    def hoist(self, xs):
        """The input projections of a (T, N, ...) sequence, indexable by
        step, or None when this cell has no hoistable form (default)."""
        return None

    def loop_invariants(self):
        """Tensors every hoisted step reads, computed once per forward."""
        return None

    def step_hoisted(self, zx_t, hidden, invariants):
        """``step`` consuming a :meth:`hoist` slice instead of x_t."""
        raise NotImplementedError

    def forward(self, input):
        x_t, hidden = input
        return self.step(x_t, hidden)


def _zeros(batch_size, H, like):
    dtype = like.dtype if like.is_floating_point() else torch.float32
    return torch.zeros(batch_size, H, dtype=dtype, device=like.device)


class RnnCell(Cell):
    """Elman RNN: ``h' = act(x W_ih^T + h W_hh^T + b)`` (default tanh)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.w_ih = _param(hidden_size, input_size)
        self.w_hh = _param(hidden_size, hidden_size)
        self.bias = _param(hidden_size)

    def reset_parameters(self, generator):
        fan = self.input_size + self.hidden_size
        for p in (self.w_ih, self.w_hh, self.bias):
            p.data.copy_(_uniform(generator, p.shape, fan))

    def initial_hidden(self, batch_size, like):
        return _zeros(batch_size, self.hidden_size, like)

    def step(self, x_t, h):
        h_new = self.activation(x_t @ self.w_ih.T + h @ self.w_hh.T
                                + self.bias)
        return h_new, h_new

    def hoist(self, xs):
        return xs @ self.w_ih.T + self.bias

    def step_hoisted(self, zx_t, h, invariants):
        h_new = self.activation(zx_t + h @ self.w_hh.T)
        return h_new, h_new


class LSTM(Cell):
    """LSTM cell: gates i|f|g|o from one projection of ``[x, h]``; weight
    (4H, D+H), bias (4H).  ``forget_bias`` is added inside the sigmoid of
    f.  The hoisted step is the fused cell (module docstring)."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 0.0, name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.forget_bias = forget_bias
        self.weight = _param(4 * hidden_size, input_size + hidden_size)
        self.bias = _param(4 * hidden_size)

    def reset_parameters(self, generator):
        fan = self.input_size + self.hidden_size
        self.weight.data.copy_(_uniform(generator, self.weight.shape, fan))
        self.bias.data.copy_(_uniform(generator, self.bias.shape, fan))

    def initial_hidden(self, batch_size, like):
        return (_zeros(batch_size, self.hidden_size, like),
                _zeros(batch_size, self.hidden_size, like))

    def step(self, x_t, hidden):
        h, c = hidden
        z = torch.addmm(self.bias, torch.cat([x_t, h], dim=-1),
                        self.weight.T)
        return self._gates(z, c)

    def _gates(self, z, c):
        i, f, g, o = z.chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + self.forget_bias)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def hoist(self, xs):
        T, N = xs.shape[:2]
        zx = torch.addmm(self.bias, xs.reshape(T * N, -1),
                         self.weight[:, :self.input_size].T)
        return zx.reshape(T, N, -1)

    def loop_invariants(self):
        # (H, 4H) transposed recurrent slice, made contiguous once per
        # forward; autograd sums its gradient over the steps
        return self.weight[:, self.input_size:].T.contiguous()

    def step_hoisted(self, zx_t, hidden, w_t):
        h, c = hidden
        h_new, c_new = lstm_cell(zx_t, h, c, w_t,
                                 forget_bias=self.forget_bias)
        return h_new, (h_new, c_new)


class LSTMPeephole(Cell):
    """LSTM with peephole connections: ``weight`` (4H, D+H), ``bias``
    (4H) and ``peep`` (3, H), whose rows add ``c`` into the input and
    forget gates and the new ``c`` into the output gate."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        H, D = hidden_size, input_size
        self.weight = _param(4 * H, D + H)
        self.bias = _param(4 * H)
        self.peep = _param(3, H)

    def reset_parameters(self, generator):
        fan = self.input_size + self.hidden_size
        for p in (self.weight, self.bias, self.peep):
            p.data.copy_(_uniform(generator, p.shape, fan))

    def initial_hidden(self, batch_size, like):
        return (_zeros(batch_size, self.hidden_size, like),
                _zeros(batch_size, self.hidden_size, like))

    def step(self, x_t, hidden):
        h, c = hidden
        z = torch.addmm(self.bias, torch.cat([x_t, h], dim=-1),
                        self.weight.T)
        i, f, g, o = z.chunk(4, dim=-1)
        p = self.peep
        i = torch.sigmoid(i + p[0] * c)
        f = torch.sigmoid(f + p[1] * c)
        g = torch.tanh(g)
        c_new = f * c + i * g
        o = torch.sigmoid(o + p[2] * c_new)
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRU(Cell):
    """GRU cell, the reset gate applied to h before the candidate
    projection: ``w_gates`` (2H, D+H) and ``b_gates`` (2H) give r|u,
    ``w_cand`` (H, D+H) and ``b_cand`` (H) the candidate."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        H, D = hidden_size, input_size
        self.w_gates = _param(2 * H, D + H)
        self.b_gates = _param(2 * H)
        self.w_cand = _param(H, D + H)
        self.b_cand = _param(H)

    def reset_parameters(self, generator):
        fan = self.input_size + self.hidden_size
        for p in (self.w_gates, self.b_gates, self.w_cand, self.b_cand):
            p.data.copy_(_uniform(generator, p.shape, fan))

    def initial_hidden(self, batch_size, like):
        return _zeros(batch_size, self.hidden_size, like)

    def step(self, x_t, h):
        z = torch.cat([x_t, h], dim=-1) @ self.w_gates.T + self.b_gates
        r, u = torch.sigmoid(z).chunk(2, dim=-1)
        cand = torch.tanh(torch.cat([x_t, r * h], dim=-1) @ self.w_cand.T
                          + self.b_cand)
        h_new = u * h + (1 - u) * cand
        return h_new, h_new

    def hoist(self, xs):
        # the gates' and the candidate's input projections side by side
        # on the last axis: (T, N, 2H) | (T, N, H)
        D = self.input_size
        return torch.cat([xs @ self.w_gates[:, :D].T + self.b_gates,
                          xs @ self.w_cand[:, :D].T + self.b_cand], dim=-1)

    def step_hoisted(self, zx_t, h, invariants):
        H, D = self.hidden_size, self.input_size
        zg, zc = zx_t[..., :2 * H], zx_t[..., 2 * H:]
        z = zg + h @ self.w_gates[:, D:].T
        r, u = torch.sigmoid(z).chunk(2, dim=-1)
        cand = torch.tanh(zc + (r * h) @ self.w_cand[:, D:].T)
        h_new = u * h + (1 - u) * cand
        return h_new, h_new


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM over NCHW feature maps: a stride-1 SAME
    convolution of ``[x_t, h]`` (``weight`` (4 C_out, C_in + C_out, K, K),
    ``bias`` (4 C_out)) gives the i|f|g|o gate maps; with ``with_peephole``
    (the default, the reference's) ``peep`` (3, C_out) adds ``c``
    per channel into the input and forget gates and the new ``c`` into the
    output gate.  ``spatial`` (H, W) sizes the initial state.  Weights are
    drawn weight, bias, then peep."""

    dims = 2

    def __init__(self, input_size: int, output_size: int, kernel: int = 3,
                 spatial: Optional[Sequence[int]] = None,
                 with_peephole: bool = True, name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.output_size = input_size, output_size
        self.kernel = kernel
        self.spatial = None if spatial is None else tuple(spatial)
        self.hidden_size = output_size
        self.with_peephole = with_peephole
        taps = (kernel,) * self.dims
        self.weight = _param(4 * output_size, input_size + output_size, *taps)
        self.bias = _param(4 * output_size)
        if with_peephole:
            self.peep = _param(3, output_size)

    def reset_parameters(self, generator):
        fan = (self.input_size + self.output_size) * self.kernel ** self.dims
        ps = [self.weight, self.bias]
        if self.with_peephole:
            ps.append(self.peep)
        for p in ps:
            p.data.copy_(_uniform(generator, p.shape, fan))

    def initial_hidden(self, batch_size, like):
        if self.spatial is None:
            raise ValueError(f"{type(self).__name__} needs spatial= (its "
                             f"{self.dims} map sizes) for its initial state")
        dtype = like.dtype if like.is_floating_point() else torch.float32
        shape = (batch_size, self.output_size) + self.spatial
        return (torch.zeros(shape, dtype=dtype, device=like.device),
                torch.zeros(shape, dtype=dtype, device=like.device))

    def _conv(self, x):
        """Stride-1 SAME: (K-1)//2 before, the rest after, as XLA pads."""
        conv = F.conv2d if self.dims == 2 else F.conv3d
        lo = (self.kernel - 1) // 2
        hi = self.kernel - 1 - lo
        if hi != lo:
            x, lo = F.pad(x, (lo, hi) * self.dims), 0
        return conv(x, self.weight, self.bias, padding=lo)

    def step(self, x_t, hidden):
        h, c = hidden
        z = self._conv(torch.cat([x_t, h], dim=1))
        i, f, g, o = z.chunk(4, dim=1)
        if self.with_peephole:
            p = self.peep.reshape((3, 1, -1) + (1,) * self.dims)
            i = i + p[0] * c
            f = f + p[1] * c
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        if self.with_peephole:
            o = o + p[2] * c_new
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class ConvLSTMPeephole3D(ConvLSTMPeephole):
    """The volumetric twin of :class:`ConvLSTMPeephole` over NCDHW maps:
    ``weight`` (4 C_out, C_in + C_out, K, K, K), ``spatial`` (D, H, W)."""

    dims = 3


class MultiRNNCell(Cell):
    """Stack cells vertically; children are named ``"0"``, ``"1"``, ..."""

    def __init__(self, cells: Sequence[Cell], name: Optional[str] = None):
        super().__init__(name)
        for i, c in enumerate(cells):
            self.add_module(str(i), c)
        self.hidden_size = cells[-1].hidden_size

    @property
    def cells(self):
        return list(self._modules.values())

    def initial_hidden(self, batch_size, like):
        return tuple(c.initial_hidden(batch_size, like) for c in self.cells)

    def step(self, x_t, hidden):
        new_hidden = []
        out = x_t
        for c, h in zip(self.cells, hidden):
            out, h = c.step(out, h)
            new_hidden.append(h)
        return out, tuple(new_hidden)

    def hoist(self, xs):
        # only layer 0 sees the raw sequence; deeper layers consume
        # in-loop outputs, so their projections cannot move out
        return self.cells[0].hoist(xs)

    def loop_invariants(self):
        return self.cells[0].loop_invariants()

    def step_hoisted(self, zx_t, hidden, invariants):
        cells = self.cells
        out, h = cells[0].step_hoisted(zx_t, hidden[0], invariants)
        new_hidden = [h]
        for c, h in zip(cells[1:], hidden[1:]):
            out, h = c.step(out, h)
            new_hidden.append(h)
        return out, tuple(new_hidden)


class Recurrent(Module):
    """Run a cell over the time axis of (N, T, ...) and return the whole
    output sequence (N, T, H), hoisting the input projection when the cell
    has one."""

    def __init__(self, cell: Cell, reverse: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.cell = cell
        self.reverse = reverse

    def forward(self, x):
        hidden = self.cell.initial_hidden(x.shape[0], x)
        xs = x.transpose(0, 1)  # (T, N, ...)
        if self.reverse:
            xs = xs.flip(0)
        zx = self.cell.hoist(xs)
        ys = []
        if zx is not None:
            inv = self.cell.loop_invariants()
            for t in range(zx.shape[0]):
                y, hidden = self.cell.step_hoisted(zx[t], hidden, inv)
                ys.append(y)
        else:
            for t in range(xs.shape[0]):
                y, hidden = self.cell.step(xs[t], hidden)
                ys.append(y)
        ys = torch.stack(ys, dim=0)
        if self.reverse:
            ys = ys.flip(0)
        return ys.transpose(0, 1)


class BiRecurrent(Module):
    """Bidirectional wrapper: ``fwd`` runs ``cell_fwd`` over time, ``bwd``
    runs ``cell_bwd`` (a copy of ``cell_fwd`` by default) over reversed
    time; the outputs are concatenated on the feature axis (``merge=
    "concat"``) or added."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Optional[Cell] = None,
                 merge: str = "concat", name: Optional[str] = None):
        super().__init__(name)
        import copy
        self.fwd = Recurrent(cell_fwd)
        self.bwd = Recurrent(cell_bwd if cell_bwd is not None
                             else copy.deepcopy(cell_fwd), reverse=True)
        self.merge = merge

    def forward(self, x):
        yf, yb = self.fwd(x), self.bwd(x)
        if self.merge == "concat":
            return torch.cat([yf, yb], dim=-1)
        return yf + yb


class RecurrentDecoder(Module):
    """Decode ``seq_length`` steps, each step's output the next step's
    input: (N, features) in, (N, seq_length, features) out.  The cell's
    ``step`` runs every step (its output size must be its input size)."""

    def __init__(self, cell: Cell, seq_length: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.cell = cell
        self.seq_length = seq_length

    def forward(self, x):
        hidden = self.cell.initial_hidden(x.shape[0], x)
        ys = []
        for _ in range(self.seq_length):
            x, hidden = self.cell.step(x, hidden)
            ys.append(x)
        return torch.stack(ys, dim=1)


class TimeDistributed(Module):
    """Apply an inner module at every timestep of (N, T, ...) by folding
    time into the batch: one large call instead of T small ones."""

    def __init__(self, layer: Module, name: Optional[str] = None):
        super().__init__(name)
        self.layer = layer

    def forward(self, x):
        N, T = x.shape[:2]
        out = self.layer(x.reshape((N * T,) + tuple(x.shape[2:])))
        return out.reshape((N, T) + tuple(out.shape[1:]))

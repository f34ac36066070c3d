"""Post-training int8 quantization (port of ``bigdl_tpu/nn/quantized.py``).

Scheme, as in the reference:

- weights: symmetric per output channel (``scale_o = max|W_o| / 127``),
  computed with the reference's numpy math, so the int8 panels and scales
  are bitwise-equal to JAX's;
- activations, per layer ``mode`` (``Config.int8_activation_mode``
  default, ``quantize(model, mode=...)`` override): ``"weight_only"``
  keeps f32/bf16/f16 activations; ``"dynamic"`` quantizes them per tensor on
  the fly (``ops.int8_gemm.dyn_quantize``);
- f32 bias added after dequantization, in the same rounding as the scale.

Every ``n_group == 1`` convolution reduces onto the int8 GEMM on both
devices through im2col, in either format: an NHWC convolution keeps its
``weight_q`` OIHW and builds the same channel-major patch rows, in (n, ho,
wo) order, from the NCHW-indexed view of its input, so B4 gets the
operands the NCHW twin gives it and the rows come out NHWC as they are.
In dynamic mode the activation scale is taken over the conv's
whole input before im2col, as the reference's direct conv simulation
(``_apply_sim``) takes it.  Grouped convolutions keep that simulation.

The cells of ``Recurrent``/``BiRecurrent`` layers quantize too, where
their type is exactly ``LSTM``, ``GRU`` or ``RnnCell`` (a ``MultiRNNCell``
stack stays float, as in the reference): :class:`QuantizedLSTM`,
:class:`QuantizedGRU` and :class:`QuantizedRnnCell` keep int8 panels over
the concatenated ``[x_t, h]`` (the GRU two: gates, and the candidate,
whose ``h`` is reset before the product) and run every step's projection
through the int8 GEMM (kernel B4 on the card).  They have no hoisted
form, so ``Recurrent`` takes their ``step``; in dynamic mode each step's
activation scale is taken over its whole ``[x_t, h]``.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import (Linear, SpatialConvolution,
                                       conv_pads, from_nchw_view, nchw_view)
from bigdl_tpu_torch.nn.module import Container, Module
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, BiRecurrent, Cell,
                                          Recurrent, RnnCell, _zeros)
from bigdl_tpu_torch.ops.int8_gemm import (MODES, fma_f32, int8_gemm,
                                           int8_matmul, prepare_operands)


def _default_mode(mode: Optional[str]) -> str:
    """explicit arg > ``Config.int8_activation_mode`` (env
    ``BIGDL_TPU_INT8_ACTIVATION_MODE``) > "weight_only"."""
    if mode is None:
        from bigdl_tpu_torch.utils.config import get_config
        mode = get_config().int8_activation_mode
    if mode not in MODES:
        raise ValueError(
            f"int8 activation mode must be one of {MODES}, got {mode!r}")
    return mode


def _quantize_symmetric(w: np.ndarray, axis=None):
    """Return (int8 values, f32 scale) with symmetric range mapping."""
    amax = np.max(np.abs(w), axis=axis, keepdims=axis is not None)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.asarray(scale, np.float32)


def _tensor(v, dtype, device) -> torch.Tensor:
    """A contiguous copy of ``v`` (numpy array or tensor) as ``dtype`` on
    ``device`` (an NHWC layer's ``channels_last`` weight gives an OIHW
    panel in OIHW memory order)."""
    t = v.detach() if isinstance(v, torch.Tensor) \
        else torch.from_numpy(np.array(v))
    return t.to(device=device, dtype=dtype, copy=True).contiguous()


def _register_quantized(mod: Module, wq, ws, bias, device) -> None:
    """The int8 twin's buffers from numpy arrays or tensors (a model
    file's, or the quantizer's)."""
    mod.register_buffer("weight_q", _tensor(wq, torch.int8, device))
    mod.register_buffer("weight_scale", _tensor(ws, torch.float32, device))
    mod.register_buffer("bias", None if bias is None
                        else _tensor(bias, torch.float32, device))


class QuantizedLinear(Module):
    """int8 Linear: buffers ``weight_q`` (out, in) int8, ``weight_scale``
    (out, 1) f32 and an optional f32 ``bias``, each given as a numpy array
    or a tensor (``from_linear`` quantizes a float layer; the model-file
    loaders pass the stored tensors)."""

    def __init__(self, weight_q: np.ndarray, weight_scale: np.ndarray,
                 bias: Optional[torch.Tensor], name: Optional[str] = None,
                 mode: Optional[str] = None, device="cpu"):
        super().__init__(name)
        _register_quantized(self, weight_q, weight_scale, bias, device)
        self.mode = _default_mode(mode)

    @staticmethod
    def from_linear(m: Linear, mode: Optional[str] = None
                    ) -> "QuantizedLinear":
        w = m.weight.detach()
        wq, ws = _quantize_symmetric(w.cpu().numpy(), axis=1)
        return QuantizedLinear(wq, ws, m.bias, name=m.name, mode=mode,
                               device=w.device)

    def forward(self, x):
        return int8_matmul(x, self.weight_q, self.weight_scale, self.bias,
                           mode=self.mode)


def _im2col(x: torch.Tensor, kernel, stride, dilation) -> torch.Tensor:
    """(N*Ho*Wo, C*kh*kw) patch rows of an already padded NCHW ``x``, in
    (n, ho, wo) row order with channel-major features: the layout of
    ``F.unfold`` / ``lax.conv_general_dilated_patches``, matching
    ``OIHW.reshape(O, -1)``.  Built from strided views, so it takes int8
    as well as float."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    n, c = x.shape[:2]
    p = x.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    p = p[..., ::dh, ::dw]  # (N, C, Ho, Wo, kh, kw)
    ho, wo = p.shape[2:4]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * kh * kw), ho, wo


class QuantizedSpatialConvolution(Module):
    """int8 conv: buffers ``weight_q`` OIHW int8 (in both formats),
    ``weight_scale`` (O, 1, 1, 1) f32 and an optional f32 ``bias`` (numpy
    arrays or tensors), the geometry and the format taken from the float
    ``conv``."""

    def __init__(self, conv: SpatialConvolution, weight_q, weight_scale,
                 bias, name: Optional[str] = None,
                 mode: Optional[str] = None, device="cpu"):
        super().__init__(name or conv.name)
        self.kernel = conv.kernel
        self.stride = conv.stride
        self.pad = conv.pad
        self.dilation = conv.dilation
        self.n_group = conv.n_group
        self.format = conv.format
        _register_quantized(self, weight_q, weight_scale, bias, device)
        self.mode = _default_mode(mode)

    @staticmethod
    def from_conv(m: SpatialConvolution, mode: Optional[str] = None
                  ) -> "QuantizedSpatialConvolution":
        w = m.weight.detach()
        wq, ws = _quantize_symmetric(w.cpu().numpy(), axis=(1, 2, 3))
        return QuantizedSpatialConvolution(m, wq, ws, m.bias, mode=mode,
                                           device=w.device)

    def forward(self, x):
        x = nchw_view(x, self.format)
        if self.n_group != 1:
            return from_nchw_view(self._apply_sim(x), self.format)
        O = self.weight_q.shape[0]
        xin, scale_row = prepare_operands(x, self.weight_scale, self.mode)
        t, b, l, r = conv_pads(self, x.shape[2:])
        if t or b or l or r:
            xin = F.pad(xin, (l, r, t, b))
        rows, ho, wo = _im2col(xin, self.kernel, self.stride, self.dilation)
        y = int8_gemm(rows, self.weight_q.reshape(O, -1), scale_row,
                      self.bias).reshape(x.shape[0], ho, wo, O)
        return y if self.format == "NHWC" else y.permute(0, 3, 1, 2)

    def _apply_sim(self, x):
        """Grouped conv on the NCHW view ``x``: the reference's direct-conv
        simulation of the same quantized math.  The integer sum of dynamic
        mode is exact in float64; weight_only accumulates in f32, on an
        NCHW-contiguous input in both formats (a ``channels_last`` input
        would take another convolution algorithm, another sum order)."""
        xin, scale_row = prepare_operands(x, self.weight_scale, self.mode)
        t, b, l, r = conv_pads(self, x.shape[2:])
        xin = F.pad(xin, (l, r, t, b))
        dt = torch.float64 if self.mode == "dynamic" else torch.float32
        acc = F.conv2d(xin.to(dt).contiguous(), self.weight_q.to(dt),
                       stride=self.stride,
                       dilation=self.dilation, groups=self.n_group).float()
        bias = None if self.bias is None else self.bias[None, :, None, None]
        return fma_f32(acc, scale_row[None, :, None, None], bias)


# ------------------------------------------------------ quantized recurrent
class _QuantizedCellBase(Cell):
    """An int8 twin of a float cell: its int8 panels and f32 scales and
    biases are buffers (the reference keeps them on the object, its params
    empty), its projections go through :func:`int8_matmul`."""

    def __init__(self, cell: Cell, mode: Optional[str] = None):
        super().__init__(f"Quantized{type(cell).__name__}")
        self.input_size = cell.input_size
        self.hidden_size = cell.hidden_size
        self.mode = _default_mode(mode)

    def _panel(self, q: str, s: str, w: torch.Tensor) -> None:
        """Buffers ``q`` (int8) and ``s`` (its (out, 1) scales) from the
        float weight ``w``, on ``w``'s device."""
        wq, ws = _quantize_symmetric(w.detach().cpu().numpy(), axis=1)
        self.register_buffer(q, _tensor(wq, torch.int8, w.device))
        self.register_buffer(s, _tensor(ws, torch.float32, w.device))

    def _bias(self, name: str, b: torch.Tensor) -> None:
        self.register_buffer(name, _tensor(b, torch.float32, b.device))

    def _proj(self, x, wq, ws, bias):
        return int8_matmul(x, wq, ws, bias, mode=self.mode)

    def initial_hidden(self, batch_size, like):
        return _zeros(batch_size, self.hidden_size, like)


class QuantizedLSTM(_QuantizedCellBase):
    """int8 LSTM cell: one (4H, D+H) panel ``wq``/``ws`` and the f32
    ``bias``; gates i|f|g|o, the float cell's ``forget_bias`` kept."""

    def __init__(self, cell: LSTM, mode: Optional[str] = None):
        super().__init__(cell, mode)
        self.forget_bias = cell.forget_bias
        self._panel("wq", "ws", cell.weight)
        self._bias("bias", cell.bias)

    def initial_hidden(self, batch_size, like):
        return (super().initial_hidden(batch_size, like),
                super().initial_hidden(batch_size, like))

    def step(self, x_t, hidden):
        h, c = hidden
        z = self._proj(torch.cat([x_t, h], dim=-1), self.wq, self.ws,
                       self.bias)
        i, f, g, o = z.chunk(4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f + self.forget_bias)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class QuantizedGRU(_QuantizedCellBase):
    """int8 GRU cell: the gates' (2H, D+H) panel ``gq``/``gs`` with
    ``b_gates``, the candidate's (H, D+H) panel ``cq``/``cs`` with
    ``b_cand``; the reset applied to h before the candidate projection."""

    def __init__(self, cell: GRU, mode: Optional[str] = None):
        super().__init__(cell, mode)
        self._panel("gq", "gs", cell.w_gates)
        self._panel("cq", "cs", cell.w_cand)
        self._bias("b_gates", cell.b_gates)
        self._bias("b_cand", cell.b_cand)

    def step(self, x_t, h):
        z = self._proj(torch.cat([x_t, h], dim=-1), self.gq, self.gs,
                       self.b_gates)
        r, u = torch.sigmoid(z).chunk(2, dim=-1)
        cand = torch.tanh(self._proj(torch.cat([x_t, r * h], dim=-1),
                                     self.cq, self.cs, self.b_cand))
        h_new = u * h + (1 - u) * cand
        return h_new, h_new


class QuantizedRnnCell(_QuantizedCellBase):
    """int8 Elman cell: one (H, D+H) panel of ``[w_ih, w_hh]`` and the
    f32 ``bias``, the float cell's activation."""

    def __init__(self, cell: RnnCell, mode: Optional[str] = None):
        super().__init__(cell, mode)
        self.activation = cell.activation
        self._panel("wq", "ws", torch.cat([cell.w_ih, cell.w_hh], dim=1))
        self._bias("bias", cell.bias)

    def step(self, x_t, h):
        h_new = self.activation(self._proj(torch.cat([x_t, h], dim=-1),
                                           self.wq, self.ws, self.bias))
        return h_new, h_new


_QUANTIZED_CELLS = {LSTM: QuantizedLSTM, GRU: QuantizedGRU,
                    RnnCell: QuantizedRnnCell}


def quantize(model: Module, mode: Optional[str] = None) -> Module:
    """Post-training quantization: returns a NEW module tree in eval mode
    in which every Linear and SpatialConvolution is its int8 twin, so is
    the cell of every ``Recurrent`` (a ``BiRecurrent``'s two included)
    whose type is exactly ``LSTM``, ``GRU`` or ``RnnCell``, and every
    other layer a copy (a ``MultiRNNCell`` and the inside of a
    ``TimeDistributed`` stay float, as in the reference); the original is
    untouched.  ``mode`` is stamped on every converted layer and cell
    (None = the config default).  Idempotent: already-quantized layers are
    copied as they are."""
    mode = _default_mode(mode)

    def convert(m: Module) -> Module:
        if isinstance(m, (Container, BiRecurrent)):
            out = copy.copy(m)
            out._modules = {k: convert(c) for k, c in m._modules.items()}
            return out
        if isinstance(m, Recurrent):
            make = _QUANTIZED_CELLS.get(type(m.cell))
            if make is None:
                return copy.deepcopy(m)
            out = copy.copy(m)
            out._modules = {"cell": make(m.cell, mode)}
            return out
        if isinstance(m, Linear):
            return QuantizedLinear.from_linear(m, mode)
        if type(m) is SpatialConvolution:
            return QuantizedSpatialConvolution.from_conv(m, mode)
        return copy.deepcopy(m)

    return convert(model).eval()


def is_quantized(model: torch.nn.Module) -> bool:
    """Whether any int8 twin, layer or cell, is in the tree (the
    ``weights_dtype`` tag)."""
    return any(isinstance(m, (QuantizedLinear, QuantizedSpatialConvolution,
                              _QuantizedCellBase))
               for m in model.modules())

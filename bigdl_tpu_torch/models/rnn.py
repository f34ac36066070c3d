"""Recurrent language models (port of ``bigdl_tpu/models/rnn.py``).

The reference's ``scan_unroll`` and ``kernel_impl`` knobs are TPU facts and
are not ported: the time loop is a Python loop, and layer 0's LSTM step
always goes through the fused cell (``ops/lstm_cell.py``).
"""

from __future__ import annotations

from bigdl_tpu_torch.nn.activations import LogSoftMax
from bigdl_tpu_torch.nn.layers import Dropout, Linear, LookupTable
from bigdl_tpu_torch.nn.module import Sequential
from bigdl_tpu_torch.nn.recurrent import (LSTM, MultiRNNCell, Recurrent,
                                          RnnCell, TimeDistributed)


def simple_rnn(input_size: int = 128, hidden_size: int = 40,
               output_size: int = 128) -> Sequential:
    """Char-level RNN: one-hot input (N, T, input_size) -> Recurrent(RnnCell)
    -> per-step Linear -> LogSoftMax."""
    return Sequential(Recurrent(RnnCell(input_size, hidden_size)),
                      TimeDistributed(Linear(hidden_size, output_size)),
                      LogSoftMax(), name="SimpleRNN")


def ptb_model(vocab_size: int = 10000, embed_dim: int = 200,
              hidden_size: int = 200, num_layers: int = 2,
              dropout: float = 0.0) -> Sequential:
    """PTB word LM: embedding -> stacked LSTM -> per-step Linear ->
    LogSoftMax.  Input: int tokens (N, T); output log-probabilities
    (N, T, vocab_size).  Dropout layers are added only when ``dropout > 0``,
    so the child indices match the reference's for the same arguments."""
    cells = [LSTM(embed_dim if i == 0 else hidden_size, hidden_size)
             for i in range(num_layers)]
    m = Sequential(LookupTable(vocab_size, embed_dim), name="PTBModel")
    if dropout > 0:
        m.add(Dropout(dropout))
    m.add(Recurrent(MultiRNNCell(cells)))
    if dropout > 0:
        m.add(Dropout(dropout))
    m.add(TimeDistributed(Linear(hidden_size, vocab_size)))
    m.add(LogSoftMax())
    return m

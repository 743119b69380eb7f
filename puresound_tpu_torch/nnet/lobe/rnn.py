"""The LSTM (counterpart of puresound_tpu/nnet/lobe/rnn.py:63-228).

One module holds torch nn.LSTM's single-layer parameters
(`weight_ih_l0` [4H, C], `weight_hh_l0` [4H, H], `bias_ih_l0`,
`bias_hh_l0`; gate order i, f, g, o) and the cell methods of the JAX
`LSTMCellParams` (`input_proj`, `gates_step`, `step`, `scan`). Every scan
goes through `ops.lstm_train_kernel.lstm_scan_train_fp`: the CUDA kernel
(forward and backward) for CUDA tensors, its plain version for CPU tensors.
JAX's routing conditions are TPU facts and are dropped here: the >= 256-row
crossover measured on a v5e (`rnn.py:98-102`), the `% 8` alignment and the
`PURESOUND_FUSED_SCAN` switch. The single-step methods stay for streaming.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.lstm_train_kernel import lstm_scan_train_fp
from ...utils.init import generator_or_default, uniform


class LSTM(nn.Module):
    """Single-layer uni-directional LSTM, batch-first.

    forward(x [B, T, C], init=None) -> (y [B, T, H], (h [1, B, H], c [1, B, H]))
    """

    def __init__(self, in_features: int, hidden: int,
                 bidirectional: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if bidirectional:
            raise NotImplementedError(
                "bidirectional LSTM is not ported yet (ROADMAP queue 1: "
                "non-causal SkiM / the rest of the TSE zoo)")
        self.in_features, self.hidden = in_features, hidden
        g = generator_or_default(generator)
        k = 1.0 / math.sqrt(hidden)
        fk = dict(device=device, dtype=dtype)
        self.weight_ih_l0 = uniform((4 * hidden, in_features), k, g, **fk)
        self.weight_hh_l0 = uniform((4 * hidden, hidden), k, g, **fk)
        self.bias_ih_l0 = uniform((4 * hidden,), k, g, **fk)
        self.bias_hh_l0 = uniform((4 * hidden,), k, g, **fk)

    def input_proj(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., C] -> [..., 4H] (both biases folded in)."""
        return (x @ self.weight_ih_l0.T.to(x.dtype) + self.bias_ih_l0.to(x.dtype)
                + self.bias_hh_l0.to(x.dtype))

    def gates_step(self, xp_t, h, c):
        """One recurrence step from a pre-projected input; all [B, *]."""
        gates = xp_t + h @ self.weight_hh_l0.T.to(h.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new

    def cell_step(self, x_t, h, c):
        """One step from a raw input x_t [B, C]; h, c [B, H]."""
        return self.gates_step(self.input_proj(x_t), h, c)

    def scan(self, x, h0, c0, reverse: bool = False):
        """x [B, T, C], h0/c0 [B, H] -> (y [B, T, H], (hT, cT))."""
        y, hT, cT = lstm_scan_train_fp(
            x, h0, c0, self.weight_ih_l0.T, self.bias_ih_l0 + self.bias_hh_l0,
            self.weight_hh_l0.T, reverse)
        return y, (hT, cT)

    def forward(self, x: torch.Tensor,
                init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if init is None:
            h0 = x.new_zeros((1, x.shape[0], self.hidden))
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = init
        y, (h, c) = self.scan(x, h0[0], c0[0])
        return y, (h[None], c[None])

    def step(self, x_t, h, c):
        """Single-frame step. x_t [B, C], h/c [1, B, H]."""
        h1, c1 = self.cell_step(x_t, h[0], c[0])
        return h1, (h1[None], c1[None])

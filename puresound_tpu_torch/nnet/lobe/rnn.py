"""The LSTM and SingleRNN (counterpart of puresound_tpu/nnet/lobe/rnn.py:63-346).

`LSTM` holds torch nn.LSTM's single-layer parameters (`weight_ih_l0`
[4H, C], `weight_hh_l0` [4H, H], `bias_ih_l0`, `bias_hh_l0`; gate order
i, f, g, o; a bidirectional LSTM adds the `*_reverse` set) and the cell
methods of the JAX `LSTMCellParams` (`input_proj`, `gates_step`, `step`,
`scan`, `scan_tm`). Every scan goes through a training LSTM kernel of
`ops.lstm_train_kernel` (the CUDA kernel, forward and backward, for CUDA
tensors; its plain version for CPU tensors): `lstm_scan_train_fp`, the
input projection inside the kernel, or, with `FUSED_PROJ_SCAN` off (JAX's
`PURESOUND_FUSED_PROJ=0`, read at import), `lstm_scan_train` on the
hoisted projection `input_proj(x)`. The time-major `scan_tm` takes their
`_tm` entries. JAX's other routing conditions are TPU facts and are
dropped here: the >= 256-row crossover measured on a v5e (`rnn.py:98-102`),
the `% 8` alignment and the `PURESOUND_FUSED_SCAN` switch; so where JAX's
`scan_tm` runs `lax.scan` (`rnn.py:157-166`) the port runs a kernel. The
single-step methods stay for streaming.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
from torch import nn

from ...ops.lstm_train_kernel import (lstm_scan_train, lstm_scan_train_fp,
                                      lstm_scan_train_fp_tm, lstm_scan_train_tm)
from ...utils.init import fan_in_bound, generator_or_default, uniform
from .dropout import Dropout

#: the input projection inside the scan kernel (JAX `rnn.py:47`); off, the
#: projection is hoisted out and the scan runs `lstm_scan_train`
FUSED_PROJ_SCAN = os.environ.get("PURESOUND_FUSED_PROJ", "1") != "0"


class Linear(nn.Module):
    """torch nn.Linear parameters ([out, in] weight), U(+-1/sqrt(in)) init."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        k = fan_in_bound(in_features)
        self.weight = uniform((out_features, in_features), k, g, device, dtype)
        self.bias = uniform((out_features,), k, g, device, dtype)

    def forward(self, x):
        return x @ self.weight.T.to(x.dtype) + self.bias.to(x.dtype)


class LSTM(nn.Module):
    """Single-layer LSTM, batch-first, optionally bidirectional.

    forward(x [B, T, C], init=None) -> (y [B, T, D*H], (h [D, B, H], c [D, B, H]))
    """

    def __init__(self, in_features: int, hidden: int,
                 bidirectional: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.hidden = in_features, hidden
        self.bidirectional = bidirectional
        g = generator_or_default(generator)
        k = 1.0 / math.sqrt(hidden)
        fk = dict(device=device, dtype=dtype)
        for sfx in ("", "_reverse") if bidirectional else ("",):
            setattr(self, f"weight_ih_l0{sfx}", uniform((4 * hidden, in_features), k, g, **fk))
            setattr(self, f"weight_hh_l0{sfx}", uniform((4 * hidden, hidden), k, g, **fk))
            setattr(self, f"bias_ih_l0{sfx}", uniform((4 * hidden,), k, g, **fk))
            setattr(self, f"bias_hh_l0{sfx}", uniform((4 * hidden,), k, g, **fk))

    @property
    def num_directions(self) -> int:
        return 2 if self.bidirectional else 1

    def direction(self, reverse: bool = False):
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one direction."""
        sfx = "_reverse" if reverse else ""
        if reverse and not self.bidirectional:
            raise ValueError("a uni-directional LSTM has no reverse direction")
        return tuple(getattr(self, f"{n}_l0{sfx}")
                     for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def input_proj(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """x [..., C] -> [..., 4H] (both biases folded in)."""
        w_ih, _, b_ih, b_hh = self.direction(reverse)
        return x @ w_ih.T.to(x.dtype) + b_ih.to(x.dtype) + b_hh.to(x.dtype)

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

    def _scan(self, x, h0, c0, reverse, direction, time_major):
        w_ih, w_hh, b_ih, b_hh = self.direction(direction)
        if FUSED_PROJ_SCAN:
            fn = lstm_scan_train_fp_tm if time_major else lstm_scan_train_fp
            y, hT, cT = fn(x, h0, c0, w_ih.T, b_ih + b_hh, w_hh.T, reverse)
        else:
            fn = lstm_scan_train_tm if time_major else lstm_scan_train
            y, hT, cT = fn(self.input_proj(x, direction), h0, c0, w_hh.T,
                           reverse)
        return y, (hT, cT)

    def scan(self, x, h0, c0, reverse: bool = False, direction: bool = False):
        """x [B, T, C], h0/c0 [B, H] -> (y [B, T, H], (hT, cT)), scanning T
        backwards under `reverse` (y stays input-aligned) with the
        parameters of direction `direction` (True: the `_reverse` set)."""
        return self._scan(x, h0, c0, reverse, direction, time_major=False)

    def scan_tm(self, x_t, h0, c0, reverse: bool = False, direction: bool = False):
        """Time-major `scan`: x_t [T, B, C] -> (y_t [T, B, H], (hT, cT))
        (JAX `rnn.py:138-166`)."""
        return self._scan(x_t, h0, c0, reverse, direction, time_major=True)

    def _run(self, x, init, time_major):
        scan = self.scan_tm if time_major else self.scan
        if init is None:
            h0 = x.new_zeros((self.num_directions, x.shape[1 if time_major else 0],
                              self.hidden))
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = init
        y, (h, c) = scan(x, h0[0], c0[0])
        if not self.bidirectional:
            return y, (h[None], c[None])
        y_b, (hb, cb) = scan(x, h0[1], c0[1], reverse=True, direction=True)
        return (torch.cat([y, y_b], dim=-1),
                (torch.stack([h, hb]), torch.stack([c, cb])))

    def forward(self, x: torch.Tensor,
                init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        return self._run(x, init, time_major=False)

    def call_tm(self, x_t: torch.Tensor,
                init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Time-major forward: x_t [T, B, C] -> (y_t [T, B, D*H], (h, c))
        (JAX `rnn.py:204`)."""
        return self._run(x_t, init, time_major=True)

    def step(self, x_t, h, c):
        """Single-frame step (uni-directional). x_t [B, C], h/c [1, B, H]."""
        if self.bidirectional:
            raise ValueError("step() is only defined for a uni-directional LSTM")
        h1, c1 = self.cell_step(x_t, h[0], c[0])
        return h1, (h1[None], c1[None])


class SingleRNN(nn.Module):
    """1-layer LSTM + dropout + linear projection back to the input size,
    [N, C, T] in and out (JAX `rnn.py:289`; PureSound's `rnn` / `proj`)."""

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int,
                 bidirectional: bool = False, dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rt = rnn_type.upper()
        if rt in ("GRU", "RNN"):
            raise NotImplementedError(
                f"SingleRNN {rt} is not ported yet (ROADMAP queue 1 item 5b(iii): "
                "the UnetTcn models)")
        if rt != "LSTM":
            raise ValueError(f"unsupported rnn type {rnn_type}")
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size, self.bidirectional = hidden_size, bidirectional
        self.rnn = LSTM(input_size, hidden_size, bidirectional, generator=g, **fk)
        D = 2 if bidirectional else 1
        self.proj = Linear(D * hidden_size, input_size, generator=g, **fk)
        self.drop = Dropout(dropout, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, T] -> [N, C, T]."""
        y, _ = self.rnn(x.transpose(1, 2))
        return self.proj(self.drop(y)).transpose(1, 2)

    def step(self, x_t, h, c):
        """Streaming single-frame step (uni-directional): x_t [B, C],
        h/c [1, B, H] -> (y [B, C], h', c')."""
        y, (h, c) = self.rnn.step(x_t, h, c)
        return self.proj(y), h, c

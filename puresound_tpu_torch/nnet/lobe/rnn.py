"""The LSTM, GRU and Elman RNN, SingleRNN and the FSMN layers (counterpart of
puresound_tpu/nnet/lobe/rnn.py:63-502).

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

`GRU` and `RNN` hold torch nn.GRU's / nn.RNN's parameters (gate order r, z,
n; the n gate's r * (W_hn h + b_hn)) and scan in plain PyTorch, as JAX's
`lax.scan` (they have no Pallas kernel there). `FSMN` / `ConditionFSMN`
(`rnn.py:349-502`): a 1x1 projection, a depthwise context conv over
(l_context, r_context) frames, the memory handed from layer to layer, and a
projection out with norm, ReLU and dropout; `step_chunk` streams a causal
one with its last l_context projected frames carried.
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
from .cnn import Conv1d
from .dropout import Dropout
from .norm import get_norm

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


class _StepRNN(nn.Module):
    """A single-layer, batch-first GRU or Elman RNN with torch's parameter
    names (`weight_ih_l0` [G*H, C], `weight_hh_l0` [G*H, H], `bias_ih_l0`,
    `bias_hh_l0`, the `*_reverse` set when bidirectional), scanned step by
    step. forward(x [B, T, C], h0 [D, B, H] or None) -> (y [B, T, D*H],
    h [D, B, H])."""

    n_gates = 1

    def __init__(self, in_features: int, hidden: int, bidirectional: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.hidden = in_features, hidden
        self.bidirectional = bidirectional
        g = generator_or_default(generator)
        k, G = 1.0 / math.sqrt(hidden), self.n_gates
        fk = dict(device=device, dtype=dtype)
        for sfx in ("", "_reverse") if bidirectional else ("",):
            setattr(self, f"weight_ih_l0{sfx}", uniform((G * hidden, in_features), k, g, **fk))
            setattr(self, f"weight_hh_l0{sfx}", uniform((G * hidden, hidden), k, g, **fk))
            setattr(self, f"bias_ih_l0{sfx}", uniform((G * hidden,), k, g, **fk))
            setattr(self, f"bias_hh_l0{sfx}", uniform((G * hidden,), k, g, **fk))

    def direction(self, reverse: bool = False):
        """(weight_ih, weight_hh, bias_ih, bias_hh) of one direction."""
        sfx = "_reverse" if reverse else ""
        return tuple(getattr(self, f"{n}_l0{sfx}")
                     for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))

    def scan(self, x, h0, reverse: bool = False, direction: bool = False):
        """x [B, T, C], h0 [B, H] -> (y [B, T, H], hT), backwards in time
        under `reverse` (y stays input-aligned), with the `_reverse`
        parameters under `direction`."""
        w_ih, w_hh, b_ih, b_hh = (w.to(x.dtype) for w in self.direction(direction))
        xp = self._input_proj(x, w_ih, b_ih, b_hh)
        T = x.shape[1]
        ys, h = [None] * T, h0
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            h = self._cell(xp[:, t], h, w_hh, b_hh)
            ys[t] = h
        return torch.stack(ys, dim=1), h

    def forward(self, x: torch.Tensor, h0: Optional[torch.Tensor] = None):
        D = 2 if self.bidirectional else 1
        if h0 is None:
            h0 = x.new_zeros((D, x.shape[0], self.hidden))
        y, h = self.scan(x, h0[0])
        if not self.bidirectional:
            return y, h[None]
        y_b, hb = self.scan(x, h0[1], reverse=True, direction=True)
        return torch.cat([y, y_b], dim=-1), torch.stack([h, hb])


class GRU(_StepRNN):
    """torch nn.GRU (JAX `GRUCellParams`, `rnn.py:231-259`): r, z, n =
    the three gates; n = tanh(x_n + r * (W_hn h + b_hn));
    h' = (1 - z) * n + z * h."""

    n_gates = 3

    @staticmethod
    def _input_proj(x, w_ih, b_ih, b_hh):
        return x @ w_ih.T + b_ih

    @staticmethod
    def _cell(xt, h, w_hh, b_hh):
        xr, xz, xn = xt.chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh.T + b_hh).chunk(3, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h


class RNN(_StepRNN):
    """torch nn.RNN with tanh (JAX `VanillaRNNCellParams`, `rnn.py:262-283`):
    h' = tanh(W_ih x + b_ih + b_hh + W_hh h)."""

    @staticmethod
    def _input_proj(x, w_ih, b_ih, b_hh):
        return x @ w_ih.T + b_ih + b_hh

    @staticmethod
    def _cell(xt, h, w_hh, b_hh):
        return torch.tanh(xt + h @ w_hh.T)


class SingleRNN(nn.Module):
    """1-layer LSTM, GRU or RNN + dropout + linear projection back to the
    input size, [N, C, T] in and out (JAX `rnn.py:289`; PureSound's `rnn` /
    `proj`)."""

    def __init__(self, rnn_type: str, input_size: int, hidden_size: int,
                 bidirectional: bool = False, dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        rt = rnn_type.upper()
        cells = {"LSTM": LSTM, "GRU": GRU, "RNN": RNN}
        if rt not in cells:
            raise ValueError(f"unsupported rnn type {rnn_type}")
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.rnn_type, self.hidden_size, self.bidirectional = rt, hidden_size, bidirectional
        self.rnn = cells[rt](input_size, hidden_size, bidirectional, generator=g, **fk)
        D = 2 if bidirectional else 1
        self.proj = Linear(D * hidden_size, input_size, generator=g, **fk)
        self.drop = Dropout(dropout, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, C, T] -> [N, C, T]."""
        y, _ = self.rnn(x.transpose(1, 2))
        return self.proj(self.drop(y)).transpose(1, 2)

    def step(self, x_t, h, c):
        """Streaming single-frame step (a uni-directional LSTM): x_t [B, C],
        h/c [1, B, H] -> (y [B, C], h', c')."""
        if self.rnn_type != "LSTM":
            raise ValueError("step() is only defined for a uni-directional LSTM")
        y, (h, c) = self.rnn.step(x_t, h, c)
        return self.proj(y), h, c


class FSMN(nn.Module):
    """Feedforward sequential memory layer (JAX `rnn.py:349-433`):
    (x [N, C, T], memory [N, P, T] or None) -> (out [N, O, T], memory').
    proj = in_proj(x); memory' = proj + ctx_conv(proj padded (l, r)) (+
    memory); out = dropout(ReLU(norm(out_proj(memory')))). PureSound-style
    names: `in_proj` (1x1, no bias), `ctx_conv` (depthwise, no bias),
    `out_proj`, `out_norm`."""

    def __init__(self, input_dim: int, output_dim: int, project_dim: int,
                 l_context: int, r_context: int, dilation: int = 1, dropout: float = 0.0,
                 norm_type: str = "bN1d", *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.project_dim, self.l_context, self.r_context = project_dim, l_context, r_context
        self.dilation = dilation
        self.in_proj = Conv1d(input_dim, project_dim, 1, bias=False, generator=g, **fk)
        self.ctx_conv = Conv1d(project_dim, project_dim, l_context + r_context + 1,
                               dilation=dilation, groups=project_dim, bias=False,
                               generator=g, **fk)
        self.out_proj = Conv1d(project_dim, output_dim, 1, generator=g, **fk)
        self.out_norm = get_norm(norm_type)(output_dim, **fk)
        self.drop = Dropout(dropout, generator=g)

    def _mix(self, proj, ctx, embed):
        """The projection with its context (ConditionFSMN conditions here)."""
        return proj + ctx

    def _out(self, proj):
        return self.drop(torch.relu(self.out_norm(self.out_proj(proj))))

    def _run(self, x, embed, memory):
        proj = self.in_proj(x)
        ctx = self.ctx_conv(nn.functional.pad(proj, (self.l_context, self.r_context)))
        proj = self._mix(proj, ctx, embed)
        if memory is not None:
            proj = proj + memory
        return self._out(proj), proj

    def forward(self, x: torch.Tensor, memory: Optional[torch.Tensor] = None):
        return self._run(x, None, memory)

    # -------------------------------------------------------------- streaming
    @property
    def ctx_frames(self) -> int:
        return self.l_context

    def init_ctx(self, batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
        """The carried ring of l_context projected frames (a causal FSMN
        only: r_context 0, dilation 1)."""
        if self.r_context or self.dilation != 1:
            raise ValueError("streaming needs a causal FSMN (r_context 0, dilation 1)")
        if device is None:
            device = self.in_proj.weight.device
        return torch.zeros((batch, self.project_dim, self.l_context), dtype=dtype,
                           device=device)

    def step_chunk(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                   ring: torch.Tensor, embed: Optional[torch.Tensor] = None):
        """One streaming chunk: (x [B, C, K], the memory of the layer before
        in this chunk, the carried ring) -> (out [B, O, K], memory', ring').
        The memory chains across layers, frame by frame; only the ring
        carries time."""
        proj = self.in_proj(x)
        full = torch.cat([ring, proj], dim=-1)
        proj = self._mix(proj, self.ctx_conv(full), embed)
        if memory is not None:
            proj = proj + memory
        return self._out(proj), proj, full[..., full.shape[-1] - self.l_context:]


class ConditionFSMN(FSMN):
    """FSMN with the speaker embedding (JAX `rnn.py:436-502`): concatenated
    to the context and projected (`embed_proj`, [P, P + E, 1]), or FiLM on
    both the projection and the context (`cond_scale` / `cond_bias`, [P, E,
    1]). forward(x, embed [N, E], memory=None)."""

    def __init__(self, input_dim: int, output_dim: int, project_dim: int,
                 l_context: int, r_context: int, dilation: int = 1, dropout: float = 0.0,
                 norm_type: str = "bN1d", embed_dim: int = 0, use_film: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        g = generator_or_default(generator)
        super().__init__(input_dim, output_dim, project_dim, l_context, r_context,
                         dilation, dropout, norm_type, device=device, dtype=dtype,
                         generator=g)
        fk = dict(device=device, dtype=dtype, generator=g)
        self.use_film = use_film
        if use_film:
            self.cond_scale = Conv1d(embed_dim, project_dim, 1, bias=False, **fk)
            self.cond_bias = Conv1d(embed_dim, project_dim, 1, bias=False, **fk)
        else:
            self.embed_proj = Conv1d(project_dim + embed_dim, project_dim, 1, bias=False,
                                     **fk)

    def _mix(self, proj, ctx, embed):
        e = embed[:, :, None].to(proj.dtype)
        if not self.use_film:
            cond = torch.cat([ctx, e.expand(-1, -1, ctx.shape[-1])], dim=1)
            return proj + ctx + self.embed_proj(cond)
        scale, bias = self.cond_scale(e), self.cond_bias(e)
        return (scale * proj + bias) + (scale * ctx + bias)

    def forward(self, x: torch.Tensor, embed: torch.Tensor,
                memory: Optional[torch.Tensor] = None):
        return self._run(x, embed, memory)

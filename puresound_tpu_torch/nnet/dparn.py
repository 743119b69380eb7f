"""DPARN: DPCRN with the intra (frequency) LSTM replaced by self-attention
(counterpart of puresound_tpu/nnet/dparn.py:19-221).

`DPARNblock2D` runs, on [N, CH, F, T], two `MhaSelfAttenLayer`s over the
frequency tokens of each frame (positions on the first), an FC and a
LayerNorm with a residual, then an inter LSTM over time per frequency bin
with its projection, LayerNorm and residual. Its streaming `step_chunk`
carries the inter LSTM's (h, c); `attn_kernel=True` runs the whole intra
pass through `ops.dparn_attention_kernel.dparn_intra_pass` and `fused=True`
the inter recurrence through `ops.lstm_scan_kernel.lstm_scan`.
`DPARN.center_kernel_chunk` runs the six stride-1 inner layers through
`ops.masker_kernel.dparn_center_chunk`. `DPARN_Mout` is the SIMO
separator of DSS: `multi_output` M masks, [N, M, C, T], from the last up
layer's M-fold channels; it streams on every route of `DPARN`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.dparn_attention_kernel import dparn_intra_pass
from ..ops.lstm_scan_kernel import lstm_scan
from ..ops.masker_kernel import dparn_center_chunk
from ..utils.init import generator_or_default
from .dual_path_streaming import DualPathStreaming
from .lobe.attention import MhaSelfAttenLayer
from .lobe.norm import LayerNormLast
from .lobe.rnn import Linear, SingleRNN
from .lobe.trivial import spectral_compression
from .unet import Unet


class DPARNblock2D(nn.Module):
    """Intra: 2 x MHA self-attention over frequency + FC + LayerNorm; inter:
    a uni-directional LSTM over time (PureSound's `intra_atten1/2`,
    `intra_fc`, `intra_norm`, `inter_rnn`, `inter_norm`)."""

    def __init__(self, input_size: int, hidden_size: int, nhead: int,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size, self.nhead = hidden_size, nhead
        self.intra_atten1 = MhaSelfAttenLayer(input_size, hidden_size, nhead, dropout,
                                              position_encoding=True, generator=g, **fk)
        self.intra_atten2 = MhaSelfAttenLayer(input_size, hidden_size, nhead, dropout,
                                              position_encoding=False, generator=g, **fk)
        self.intra_fc = Linear(input_size, input_size, generator=g, **fk)
        self.intra_norm = LayerNormLast(input_size, **fk)
        self.inter_rnn = SingleRNN("LSTM", input_size, hidden_size, bidirectional=False,
                                   dropout=dropout, generator=g, **fk)
        self.inter_norm = LayerNormLast(input_size, **fk)

    def _intra(self, rows: torch.Tensor) -> torch.Tensor:
        """The stock intra pass on rows [R, F, CH]."""
        h = self.intra_atten1(rows.transpose(1, 2), causal=False)
        h = self.intra_atten2(h, causal=False).transpose(1, 2)   # [R, F, CH]
        return self.intra_norm(self.intra_fc(h))

    def forward(self, x: torch.Tensor, intra_skip: bool = True,
                inter_skip: bool = True) -> torch.Tensor:
        N, CH, F, T = x.shape
        h = self._intra(x.permute(0, 3, 2, 1).reshape(N * T, F, CH))
        h = h.reshape(N, T, F, CH).permute(0, 3, 2, 1)
        if intra_skip:
            h = x + h
        y = h.permute(0, 2, 3, 1).reshape(N * F, T, CH)
        y = self.inter_rnn(y.transpose(1, 2))                    # [N*F, CH, T]
        y = self.inter_norm(y.transpose(1, 2))                   # [N*F, T, CH]
        y = y.reshape(N, F, T, CH).permute(0, 3, 1, 2)
        return h + y if inter_skip else y

    def attn_kernel_weights(self):
        """`dparn_intra_pass`'s 28 weights (JAX's flat order, [in, out]
        products)."""
        ws = []
        for att in (self.intra_atten1, self.intra_atten2):
            wq, wk, wv = att.self_atten.atten.in_proj_weight.chunk(3, dim=0)
            ff1, ff2 = att.feedforward[0], att.feedforward[3]
            ws += [wq.T, wk.T, wv.T, att.self_atten.atten.out_proj.weight.T,
                   att.norm1.weight, att.norm1.bias, ff1.weight.T, ff1.bias,
                   ff2.weight.T, ff2.bias, att.norm2.weight, att.norm2.bias]
        return ws + [self.intra_fc.weight.T, self.intra_fc.bias,
                     self.intra_norm.weight, self.intra_norm.bias]

    def step_chunk(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                   fused: bool = False, attn_kernel: bool = False):
        """Streaming chunk: x [B, CH, F, K], inter carries h / c [1, B, F, H]
        -> (y, h', c'). The frame-local intra pass runs over all K frames at
        once; only the inter LSTM scans (K steps)."""
        N, CH, F, K = x.shape
        rows = x.permute(0, 3, 2, 1).reshape(N * K, F, CH)
        if attn_kernel:
            # positions cast to the rows' dtype, as JAX does on this route
            pe = self.intra_atten1.pos.table(F, x.device).to(rows.dtype)
            dot_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
            out = dparn_intra_pass(rows, pe, self.attn_kernel_weights(), self.nhead,
                                   dot_dtype)
        else:
            out = self._intra(rows)
        x = x + out.reshape(N, K, F, CH).permute(0, 3, 2, 1)

        seq = x.permute(0, 2, 3, 1).reshape(N * F, K, CH)
        shape, dtype = h.shape, h.dtype
        # carries are stored at the serving dtype; the stock intra pass adds
        # float32 positions, so the scan runs at the sequence's dtype
        h = h.reshape(1, N * F, -1).to(seq.dtype)
        c = c.reshape(1, N * F, -1).to(seq.dtype)
        if fused:
            cell = self.inter_rnn.rnn
            y, hT, cT = lstm_scan(cell.input_proj(seq), h[0], c[0], cell.weight_hh_l0.T)
            h, c = hT[None], cT[None]
        else:
            y, (h, c) = self.inter_rnn.rnn(seq, (h, c))
        y = self.inter_norm(self.inter_rnn.proj(y))
        y = y.reshape(N, F, K, CH).permute(0, 3, 1, 2)
        return x + y, h.reshape(shape).to(dtype), c.reshape(shape).to(dtype)


class _DPARNBase(DualPathStreaming, Unet):
    """Unet + 2 x DPARNblock2D bottleneck; RI input, optional spectral
    compression."""

    def __init__(self, rnn_hidden: int = 128, nhead: int = 1,
                 spectral_compress: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 **unet_kw):
        g = generator_or_default(generator)
        super().__init__(device=device, dtype=dtype, generator=g, **unet_kw)
        self.rnn_hidden, self.nhead = rnn_hidden, nhead
        self.spectral_compress = spectral_compress
        ch = self._chans[-1]
        fk = dict(device=device, dtype=dtype, generator=g)
        self.dprnn_block1 = DPARNblock2D(ch, rnn_hidden, nhead, self.dropout, **fk)
        self.dprnn_block2 = DPARNblock2D(ch, rnn_hidden, nhead, self.dropout, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spectral_compress:
            x = spectral_compression(x, alpha=0.3, dim=1)
        x, skips = self._down(self._pack_input(x))
        x = self.dprnn_block2(self.dprnn_block1(x))
        return self._unpack_output(self._up(x, skips))

    # ------------------------------------------------- center-fused masker
    def _dparn_block_weights(self):
        """Both blocks' weights in `dparn_center_chunk`'s flat order: the 28
        attention weights, then the inter LSTM (w_ih [CH, 4H], w_hh [H, 4H],
        the summed bias), its projection ([H, CH], [CH]) and LayerNorm."""
        ws = []
        for blk in (self.dprnn_block1, self.dprnn_block2):
            w_ih, w_hh, b_ih, b_hh = blk.inter_rnn.rnn.direction(False)
            ws += blk.attn_kernel_weights()
            ws += [w_ih.T, w_hh.T, b_ih + b_hh, blk.inter_rnn.proj.weight.T,
                   blk.inter_rnn.proj.bias, blk.inter_norm.weight, blk.inter_norm.bias]
        return ws

    def center_kernel_chunk(self, x: torch.Tensor, state: dict,
                            int8_hh: bool = False, xscr_half: bool = False):
        """The six stride-1 inner layers with the DPARN bottleneck through
        `dparn_center_chunk`; the contract of DPCRN.center_kernel_chunk."""
        if int8_hh:
            raise ValueError("int8_hh is not supported on the DPARN kernel")
        Fb = self._stream_freqs()[-1]
        pe = self.dprnn_block1.intra_atten1.pos.table(Fb, x.device)   # float32
        dot_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        y, dc, u0h, u0s, u1h, u2h, h_out, c_out = dparn_center_chunk(
            x.permute(2, 3, 0, 1).contiguous(), pe, state["dc"], state["u0h"],
            state["u0s"], state["u1h"], state["u2h"], [state["h1"], state["h2"]],
            [state["c1"], state["c2"]], self._mk_conv_weights(),
            self._dparn_block_weights(), self.nhead, dot_dtype, xscr_half=xscr_half)
        return (y.permute(2, 3, 0, 1), dc, u0h, u0s, u1h, u2h,
                h_out[0], c_out[0], h_out[1], c_out[1])


class DPARN(_DPARNBase):
    """Single-output DPARN."""


class DPARN_Mout(_DPARNBase):
    """Multi-output DPARN for SIMO separation (set multi_output=M): masks
    [N, M, C, T] offline and [B, M, C, K] from `stream_frames`."""

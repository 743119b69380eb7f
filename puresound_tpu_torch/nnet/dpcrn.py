"""DPCRN: Unet + dual-path bottleneck (counterpart of puresound_tpu/nnet/dpcrn.py:21-209).

`DPRNNblock2D` runs, on [N, CH, F, T], an intra BiLSTM over frequency per
frame and an inter LSTM over time per frequency bin, each with its
projection, LayerNorm and residual. Its streaming `step_chunk` carries the
inter LSTM's (h, c); `fused=True` sends both recurrences through
`ops.lstm_scan_kernel.lstm_scan` (the input projections stay products
outside it). `DPCRN.bottleneck_kernel_chunk` runs both blocks through
`ops.dual_path_kernel.dual_path_chunk`, `DPCRN.center_kernel_chunk` the six
stride-1 inner layers through `ops.masker_kernel.center_chunk`.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.dual_path_kernel import NAMES as DP_NAMES
from ..ops.dual_path_kernel import dual_path_chunk
from ..ops.lstm_scan_kernel import lstm_scan
from ..ops.masker_kernel import center_chunk
from ..ops.quant import quantize_cols
from ..utils.init import generator_or_default
from .dual_path_streaming import DualPathStreaming
from .lobe.norm import LayerNormLast
from .lobe.rnn import SingleRNN
from .lobe.trivial import spectral_compression
from .unet import Unet


class DPRNNblock2D(nn.Module):
    """Dual-path block on [N, CH, F, T] (PureSound's `intra_rnn`,
    `intra_norm`, `inter_rnn`, `inter_norm`)."""

    def __init__(self, input_size: int, hidden_size: int, dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size = hidden_size
        self.intra_rnn = SingleRNN("LSTM", input_size, hidden_size, bidirectional=True,
                                   dropout=dropout, generator=g, **fk)
        self.intra_norm = LayerNormLast(input_size, **fk)
        self.inter_rnn = SingleRNN("LSTM", input_size, hidden_size, bidirectional=False,
                                   dropout=dropout, generator=g, **fk)
        self.inter_norm = LayerNormLast(input_size, **fk)

    def forward(self, x: torch.Tensor, intra_skip: bool = True,
                inter_skip: bool = True) -> torch.Tensor:
        N, CH, F, T = x.shape
        h = x.permute(0, 3, 2, 1).reshape(N * T, F, CH)
        h = self.intra_rnn(h.transpose(1, 2))                    # [N*T, CH, F]
        h = self.intra_norm(h.transpose(1, 2))                   # [N*T, F, CH]
        h = h.reshape(N, T, F, CH).permute(0, 3, 2, 1)
        if intra_skip:
            h = x + h
        y = h.permute(0, 2, 3, 1).reshape(N * F, T, CH)
        y = self.inter_rnn(y.transpose(1, 2))                    # [N*F, CH, T]
        y = self.inter_norm(y.transpose(1, 2))                   # [N*F, T, CH]
        y = y.reshape(N, F, T, CH).permute(0, 3, 1, 2)
        return h + y if inter_skip else y

    def step_chunk(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                   fused: bool = False):
        """Streaming chunk: x [B, CH, F, K], inter carries h / c [1, B, F, H]
        -> (y, h', c'). The frame-local intra pass runs over all K frames at
        once; only the inter LSTM scans (K steps)."""
        N, CH, F, K = x.shape
        hseq = x.permute(0, 3, 2, 1).reshape(N * K, F, CH)
        if fused:
            lstm = self.intra_rnn.rnn
            z = hseq.new_zeros((N * K, self.hidden_size))
            y_f, _, _ = lstm_scan(lstm.input_proj(hseq), z, z, lstm.weight_hh_l0.T)
            y_b, _, _ = lstm_scan(lstm.input_proj(hseq, reverse=True), z, z,
                                  lstm.weight_hh_l0_reverse.T, reverse=True)
            hseq = self.intra_norm(self.intra_rnn.proj(torch.cat([y_f, y_b], dim=-1)))
        else:
            hseq = self.intra_rnn(hseq.transpose(1, 2))
            hseq = self.intra_norm(hseq.transpose(1, 2))         # [N*K, F, CH]
        x = x + hseq.reshape(N, K, F, CH).permute(0, 3, 2, 1)

        seq = x.permute(0, 2, 3, 1).reshape(N * F, K, CH)
        shape, dtype = h.shape, h.dtype
        # the scan carry takes the sequence's dtype; back to the stored one
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


class DPCRN(DualPathStreaming, Unet):
    """Unet + 2 x DPRNNblock2D bottleneck; RI input, optional spectral
    compression."""

    def __init__(self, rnn_hidden: int = 128, spectral_compress: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, **unet_kw):
        g = generator_or_default(generator)
        super().__init__(device=device, dtype=dtype, generator=g, **unet_kw)
        self.rnn_hidden, self.spectral_compress = rnn_hidden, spectral_compress
        ch = self._chans[-1]
        fk = dict(device=device, dtype=dtype, generator=g)
        self.dprnn_block1 = DPRNNblock2D(ch, rnn_hidden, self.dropout, **fk)
        self.dprnn_block2 = DPRNNblock2D(ch, rnn_hidden, self.dropout, **fk)
        self._int8_cache = None    # (parameter key, the int8_hh weight list)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spectral_compress:
            x = spectral_compression(x, alpha=0.3, dim=1)
        x, skips = self._down(self._pack_input(x))
        x = self.dprnn_block2(self.dprnn_block1(x))
        return self._unpack_output(self._up(x, skips))

    # ------------------------------------------------- fused bottleneck
    def _dp_kernel_weights(self, int8_hh: bool = False):
        """Both blocks' weights in `dual_path_chunk`'s flat order (JAX
        layouts: [in, out] products, the LSTM biases summed). int8_hh: each
        recurrent w_hh becomes (int8 per-column weights, column scales), as
        JAX's (puresound_tpu/nnet/dpcrn.py:140-150); that tuple is cached
        until a parameter changes (storage or in-place version)."""
        if int8_hh:
            key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                        for p in self.parameters())
            cached = self._int8_cache
            if cached is None or cached[0] != key:
                with torch.no_grad():
                    ws = []
                    for i, w in enumerate(self._dp_kernel_weights()):
                        hh = DP_NAMES[i % len(DP_NAMES)].startswith("w_hh")
                        ws += list(quantize_cols(w)) if hh else [w]
                self._int8_cache = cached = (key, ws)
            return cached[1]
        ws = []
        for blk in (self.dprnn_block1, self.dprnn_block2):
            H = blk.hidden_size
            intra, inter = blk.intra_rnn, blk.inter_rnn
            lstm_f = intra.rnn.direction(False)
            lstm_b = intra.rnn.direction(True)
            lstm_i = inter.rnn.direction(False)
            pk = intra.proj.weight.T                         # [2H, CH]
            ws += [lstm_f[0].T, lstm_f[1].T, lstm_f[2] + lstm_f[3],
                   lstm_b[0].T, lstm_b[1].T, lstm_b[2] + lstm_b[3],
                   pk[:H], pk[H:], intra.proj.bias,
                   blk.intra_norm.weight, blk.intra_norm.bias,
                   lstm_i[0].T, lstm_i[1].T, lstm_i[2] + lstm_i[3],
                   inter.proj.weight.T, inter.proj.bias,
                   blk.inter_norm.weight, blk.inter_norm.bias]
        return ws

    def bottleneck_kernel_chunk(self, x: torch.Tensor, state: dict,
                                int8_hh: bool = False, xscr_half: bool = False):
        """Both dual-path blocks through `dual_path_chunk`: x [B, CH, F, K]
        -> (y [B, CH, F, K], h1, c1, h2, c2), carries [F, B, H]
        (init_stream_state(dp_kernel=True))."""
        dot_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        y, h_out, c_out = dual_path_chunk(
            x.permute(2, 3, 0, 1).contiguous(), [state["h1"], state["h2"]],
            [state["c1"], state["c2"]], self._dp_kernel_weights(int8_hh), dot_dtype,
            int8_hh=int8_hh, xscr_half=xscr_half)
        return y.permute(2, 3, 0, 1), h_out[0], c_out[0], h_out[1], c_out[1]

    def center_kernel_chunk(self, x: torch.Tensor, state: dict,
                            int8_hh: bool = False, xscr_half: bool = False):
        """The six stride-1 inner layers (d_{n-3}..d_{n-1} convs, both
        dual-path blocks, u0..u2 transpose convs) through `center_chunk`:
        x [B, C, F, K] (the output of down layer n-4) -> (y [B, C', F, K],
        the output of up layer 2, then the new dc, u0h, u0s, u1h, u2h conv
        carries and h1, c1, h2, c2) from init_stream_state(mk_kernel=True)."""
        dot_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        y, dc, u0h, u0s, u1h, u2h, h_out, c_out = center_chunk(
            x.permute(2, 3, 0, 1).contiguous(), state["dc"], state["u0h"],
            state["u0s"], state["u1h"], state["u2h"], [state["h1"], state["h2"]],
            [state["c1"], state["c2"]], self._mk_conv_weights(),
            self._dp_kernel_weights(int8_hh), dot_dtype, int8_hh=int8_hh,
            xscr_half=xscr_half)
        return (y.permute(2, 3, 0, 1), dc, u0h, u0s, u1h, u2h,
                h_out[0], c_out[0], h_out[1], c_out[1])

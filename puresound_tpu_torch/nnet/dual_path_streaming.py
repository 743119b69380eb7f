"""Frame streaming of dual-path Unet bottleneck models (counterpart of
puresound_tpu/nnet/dual_path_streaming.py:15-183).

Mixed into `DPCRN` and `DPARN`: the Unet base supplies the down/up
streaming helpers, the bottleneck blocks `step_chunk(x, h, c, fused, ...)`.
The inter-LSTM carries are [1, B, F, H] per block in the stock state (slot
axis 1; the step reshapes them to the LSTM's [1, B*F, H] rows) and [F, B, H]
in the kernel-native states of `dual_path_chunk` (`dp_kernel=True`) and of
the wide-center kernels (`mk_kernel=True`, slot axis 1); one server holds
one layout.
"""
from __future__ import annotations

import torch


class DualPathStreaming:
    def causal_streamable(self) -> bool:
        """The Unet's conv conditions and no spectral compression; unlike the
        plain Unet's, any multi_output streams (`DPARN_Mout`), as in JAX
        (`dual_path_streaming.py:22-29`)."""
        return self._conv_streamable() and not self.spectral_compress

    def init_stream_state(self, batch: int, dtype=torch.float32, device=None,
                          dp_kernel: bool = False, mk_kernel: bool = False) -> dict:
        """1-frame conv contexts of the Unet and both blocks' inter-LSTM
        carries (+ the skip FIFOs under transpose_delay).

        mk_kernel=True (causal only) is the wide-center layout: the kernel
        owns the six stride-1 inner layers (d_{n-3}..d_{n-1}, u0..u2) with
        [F, B, C] carries: the down in-carries dc (doubling as the up skip
        carries), the up h-carries u0h / u1h / u2h and the u0 skip u0s; the
        stride-2 edge layers keep their stock carries."""
        if device is None:
            device = next(self.parameters()).device
        Fb, H = self._stream_freqs()[-1], self.rnn_hidden
        z = lambda *s: torch.zeros(s, device=device, dtype=dtype)
        if mk_kernel:
            freqs, chans, n = self._stream_freqs(), self._chans, self._n_cnn
            if self.transpose_delay or not self.causal_streamable():
                raise ValueError("mk_kernel supports causal streamable configs only")
            if n < 4 or not all(self.stride_f[i] == 1 and self.kernel_f[i] == 3
                                and freqs[i] == Fb for i in range(n - 3, n)):
                raise ValueError("mk_kernel needs 3 stride-1 k_f-3 inner down layers")
            state = {"down": [z(batch, chans[i], freqs[i]) for i in range(n - 3)],
                     "up": [z(batch, 2 * chans[n - j], freqs[n - j]) for j in range(3, n)],
                     "dc": [z(Fb, batch, chans[i]) for i in range(n - 3, n)],
                     "u0h": z(Fb, batch, chans[n]), "u0s": z(Fb, batch, chans[n]),
                     "u1h": z(Fb, batch, chans[n - 1]), "u2h": z(Fb, batch, chans[n - 2])}
        else:
            state = self._init_unet_stream_state(batch, dtype, device)
        shape = (Fb, batch, H) if dp_kernel or mk_kernel else (1, batch, Fb, H)
        for key in ("h1", "c1", "h2", "c2"):
            state[key] = z(*shape)
        return state

    def stream_frames(self, x: torch.Tensor, state: dict, fused: bool = False,
                      dp_kernel: bool = False, int8_hh: bool = False,
                      attn_kernel: bool = False, xscr_half: bool = False,
                      mk_kernel: bool = False):
        """A chunk of frames x [B, C, K] -> (mask [B, C, K], or [B, M, C, K]
        with multi_output M, new state).

        Equals the offline forward on the chunked input for causal configs;
        transpose_delay configs emit the mask `stream_delay_frames` frames
        late. fused=True runs each recurrence through `lstm_scan`;
        attn_kernel=True (DPARN) each block's intra pass through
        `dparn_intra_pass`; dp_kernel=True (DPCRN) the whole bottleneck
        through `dual_path_chunk` (state from init_stream_state(dp_kernel=
        True)); mk_kernel=True the six stride-1 inner layers through the
        wide-center kernel (state from init_stream_state(mk_kernel=True))."""
        if mk_kernel:
            n = self._n_cnn
            h, skips, new_down = self._stream_down(x, state, n_layers=n - 3)
            (y, dc, u0h, u0s, u1h, u2h, h1, c1, h2, c2) = self.center_kernel_chunk(
                h, state, int8_hh=int8_hh, xscr_half=xscr_half)
            # the fused layers' skips live in the kernel
            mask, new_up, _ = self._stream_up(y, skips + [None] * 3, state, start=3)
            return mask, dict(state, down=new_down, up=new_up, dc=dc, u0h=u0h, u0s=u0s,
                              u1h=u1h, u2h=u2h, h1=h1, c1=c1, h2=h2, c2=c2)
        h, skips, new_down = self._stream_down(x, state)
        if dp_kernel:
            h, h1, c1, h2, c2 = self.bottleneck_kernel_chunk(
                h, state, int8_hh=int8_hh, xscr_half=xscr_half)
        else:
            if int8_hh or xscr_half:
                raise ValueError("int8_hh / xscr_half go with dp_kernel / mk_kernel")
            kw = {"attn_kernel": True} if attn_kernel else {}
            h, h1, c1 = self.dprnn_block1.step_chunk(h, state["h1"], state["c1"],
                                                     fused=fused, **kw)
            h, h2, c2 = self.dprnn_block2.step_chunk(h, state["h2"], state["c2"],
                                                     fused=fused, **kw)
        mask, new_up, new_skipq = self._stream_up(h, skips, state)
        new_state = dict(state, down=new_down, up=new_up, h1=h1, c1=c1, h2=h2, c2=c2)
        if self.transpose_delay:
            new_state["skipq"] = new_skipq
        return mask, new_state

    def _mk_conv_weights(self):
        """BN-folded weights of the six fused inner layers, in the wide-center
        kernel's flat order: down layers n-3..n-1 as W[6] ([C_in, C_out], tap
        (df, dt = slot)), bias, PReLU alpha; then up layers 0..2 as Wh[6] and
        Ws[6] (the h and skip halves of the transpose conv's [2C, C_out]
        taps, time taps flipped: slot s multiplies input frame k - 1 + s),
        bias, alpha. Folded in the parameters' dtype, as JAX does."""
        def bn_affine(norm):
            rstd = torch.reciprocal(torch.sqrt(norm.running_var + norm.eps))
            return (norm.weight * rstd,
                    norm.bias - norm.running_mean * norm.weight * rstd)

        n = self._n_cnn
        out = []
        for i in range(n - 3, n):
            seq = self.cnn_down[i]
            g, beta = bn_affine(seq[2])
            wd = seq[1].weight * g[:, None, None, None]              # [Co, Ci, 3, 2]
            out += [wd[:, :, df, sl].T for sl in range(2) for df in range(3)]
            out += [seq[1].bias * g + beta, seq[3].weight]
        for j in range(3):
            seq = self.cnn_up[j]
            g, beta = bn_affine(seq[1])
            wu = seq[0].weight * g[None, :, None, None]              # [2C, Co, 3, 2]
            C = wu.shape[0] // 2
            out += [wu[:C, :, df, 1 - sl] for sl in range(2) for df in range(3)]
            out += [wu[C:, :, df, 1 - sl] for sl in range(2) for df in range(3)]
            out += [seq[0].bias * g + beta, seq[2].weight]
        return out

"""Frame streaming of dual-path Unet bottleneck models (counterpart of
puresound_tpu/nnet/dual_path_streaming.py:15-140).

Mixed into `DPCRN`: the Unet base supplies the down/up streaming helpers,
the bottleneck blocks `step_chunk(x, h, c, fused)`. The inter-LSTM carries
are [1, B, F, H] per block in the stock state (slot axis 1; the step
reshapes them to the LSTM's [1, B*F, H] rows) and [F, B, H] in the
kernel-native state of `dual_path_chunk` (`dp_kernel=True`, slot axis 1);
one server holds one layout.
"""
from __future__ import annotations

import torch


class DualPathStreaming:
    def causal_streamable(self) -> bool:
        return super().causal_streamable() and not self.spectral_compress

    def init_stream_state(self, batch: int, dtype=torch.float32, device=None,
                          dp_kernel: bool = False, mk_kernel: bool = False) -> dict:
        """1-frame conv contexts of the Unet and both blocks' inter-LSTM
        carries (+ the skip FIFOs under transpose_delay)."""
        if mk_kernel:
            raise NotImplementedError(
                "mk_kernel (the center-fused masker kernel) is not ported yet "
                "(ROADMAP queue 2 item 9)")
        if device is None:
            device = next(self.parameters()).device
        state = self._init_unet_stream_state(batch, dtype, device)
        Fb, H = self._stream_freqs()[-1], self.rnn_hidden
        shape = (Fb, batch, H) if dp_kernel else (1, batch, Fb, H)
        for key in ("h1", "c1", "h2", "c2"):
            state[key] = torch.zeros(shape, device=device, dtype=dtype)
        return state

    def stream_frames(self, x: torch.Tensor, state: dict, fused: bool = False,
                      dp_kernel: bool = False, int8_hh: bool = False,
                      attn_kernel: bool = False, xscr_half: bool = False,
                      mk_kernel: bool = False):
        """A chunk of frames x [B, C, K] -> (mask [B, C, K], new state).

        Equals the offline forward on the chunked input for causal configs;
        transpose_delay configs emit the mask `stream_delay_frames` frames
        late. fused=True runs each recurrence through `lstm_scan`;
        dp_kernel=True runs the whole bottleneck through `dual_path_chunk`
        (state from init_stream_state(dp_kernel=True))."""
        if attn_kernel or mk_kernel:
            raise NotImplementedError(
                "attn_kernel / mk_kernel are not ported yet (ROADMAP queue 2 "
                "items 8-9)")
        h, skips, new_down = self._stream_down(x, state)
        if dp_kernel:
            h, h1, c1, h2, c2 = self.bottleneck_kernel_chunk(
                h, state, int8_hh=int8_hh, xscr_half=xscr_half)
        else:
            if int8_hh or xscr_half:
                raise ValueError("int8_hh / xscr_half go with dp_kernel=True")
            h, h1, c1 = self.dprnn_block1.step_chunk(h, state["h1"], state["c1"],
                                                     fused=fused)
            h, h2, c2 = self.dprnn_block2.step_chunk(h, state["h2"], state["c2"],
                                                     fused=fused)
        mask, new_up, new_skipq = self._stream_up(h, skips, state)
        new_state = dict(state, down=new_down, up=new_up, h1=h1, c1=c1, h2=h2, c2=c2)
        if self.transpose_delay:
            new_state["skipq"] = new_skipq
        return mask, new_state

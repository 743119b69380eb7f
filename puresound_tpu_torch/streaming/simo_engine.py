"""Streaming SIMO separation engine, the DSS near / far task (counterpart of
puresound_tpu/streaming/simo_engine.py:22-129).

An STFT-domain `DPARN_Mout` emits M masks a frame: the mixture's features
are applied against each and the B * M overlap-add streams are synthesised
in one batched product. The latency and the contract are StreamingNS's with
a source axis on the output: streamed chunks of x equal the offline
`SiMoTaskWrapModule.inference` of [zeros(n_fft - hop), x] per source, from
sample n_fft on.
"""
from __future__ import annotations

import torch
from torch import nn

from ..dsp.stft import overlap_add, periodic_hann_sumsquare
from ..nnet.base_nn import apply_tf_masks, get_mask, wav_output_constrain
from ..nnet.encoder import ConvEncDec


class StreamingDSS(nn.Module):
    """Streaming wrapper over the offline SIMO wrapper's submodules (so its
    state_dict names) for a ConvEncDec encoder and a multi-output masker
    with `init_stream_state` / `stream_frames`."""

    def __init__(self, encoder: ConvEncDec, masker: nn.Module,
                 mask_constraint: str = "linear", output_constraint: str = "linear",
                 drop_first_bin: bool = True, f_type: str = "Complex",
                 mask_type: str = "Complex"):
        super().__init__()
        if not isinstance(encoder, ConvEncDec):
            raise TypeError("StreamingDSS requires a ConvEncDec (STFT) encoder")
        self.encoder, self.masker = encoder, masker
        self.mask_constraint, self.output_constraint = mask_constraint, output_constraint
        self.drop_first_bin, self.f_type, self.mask_type = drop_first_bin, f_type, mask_type

    @classmethod
    def from_offline(cls, model) -> "StreamingDSS":
        """The engine over an offline SiMoTaskWrapModule's submodules."""
        return cls(model.encoder, model.masker, model.mask_constraint,
                   model.output_constraint, model.drop_first_bin, model.f_type,
                   model.mask_type)

    @property
    def n_sources(self) -> int:
        return self.masker.multi_output

    def init_state(self, batch: int, dtype=torch.float32, device=None,
                   mk_kernel: bool = False) -> dict:
        """Zero state for `batch` streams (the wide-center kernel's masker
        layout with mk_kernel); the OLA tail carries M sources, `wsum` stays
        float32 with no stream axis."""
        n_fft, hop = self.encoder.fft_length, self.encoder.hop_length
        if device is None:
            device = self.encoder.encoder.wsin.device
        tail = n_fft - hop
        return {"enc_tail": torch.zeros((batch, tail), device=device, dtype=dtype),
                "ola_tail": torch.zeros((batch, self.n_sources, tail), device=device,
                                        dtype=dtype),
                "wsum": torch.from_numpy(periodic_hann_sumsquare(n_fft, hop)).to(device),
                "masker": self.masker.init_stream_state(batch, dtype, device,
                                                        mk_kernel=mk_kernel)}

    def step(self, chunk: torch.Tensor, state: dict, fused: bool = False,
             attn_kernel: bool = False, mk_kernel: bool = False):
        """Advance every stream by a chunk [B, S] (S a multiple of the hop).
        Returns ([B, M, S], new state): the M separated signals, each
        delayed by n_fft - hop samples. fused=True runs the inter LSTMs
        through `lstm_scan`, attn_kernel=True the intra passes through
        `dparn_intra_pass` (the two combine), mk_kernel=True the six
        stride-1 inner layers through `dparn_center_chunk` (state from
        init_state(mk_kernel=True))."""
        if fused and mk_kernel:
            raise ValueError("fused and mk_kernel are mutually exclusive")
        n_fft, hop, M = self.encoder.fft_length, self.encoder.hop_length, self.n_sources
        B, S = chunk.shape
        if S % hop:
            raise ValueError("chunk length must be a multiple of the hop")
        K = S // hop
        tail = n_fft - hop

        buf = torch.cat([state["enc_tail"], chunk.to(state["enc_tail"].dtype)], dim=-1)
        ri = self.encoder.encoder.stream_analysis_ri(buf, K, self.drop_first_bin)
        mask, masker_state = self.masker.stream_frames(
            ri, state["masker"], fused=fused, attn_kernel=attn_kernel, mk_kernel=mk_kernel)
        mask = get_mask(mask, self.mask_constraint)                  # [B, M, C, K]
        C = ri.shape[1]
        rep = ri[:, None].expand(B, M, C, K).reshape(B * M, C, K)
        enh = apply_tf_masks(rep, mask.reshape(B * M, C, K), self.mask_type, self.f_type)

        # the synthesis of all B * M streams in one product
        frames = self.encoder.encoder.stream_synthesis_frames(enh, self.drop_first_bin)
        ola = overlap_add(frames, hop).reshape(B, M, S + tail)
        ola = torch.cat([ola[..., :tail] + state["ola_tail"], ola[..., tail:]], dim=-1)
        # bf16 / float32 promotes to float32, as in JAX
        emit = ola[..., :S] / state["wsum"].repeat(K)
        new_state = {"enc_tail": buf[:, -tail:], "ola_tail": ola[..., S:],
                     "wsum": state["wsum"], "masker": masker_state}
        return wav_output_constrain(emit, self.output_constraint), new_state

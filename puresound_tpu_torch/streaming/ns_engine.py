"""Streaming engine for STFT-domain models (counterpart of
puresound_tpu/streaming/ns_engine.py:33-201).

A causal STFT-domain masker runs as a chunked stateful step batched over
streams: the analysis keeps an (n_fft - hop) sample tail, the masker its
1-frame conv contexts and recurrent carries, the overlap-add an (n_fft -
hop) sample tail. Output lags input by n_fft - hop samples (24 ms at
512/128), plus `masker.stream_delay_frames * hop` with transpose_delay
(the UnetTcn models' 6 frames: 768 samples, 1,152 in all).

With a speaker net the engine serves STFT-domain TSE (the causal
UnetTcn): `embed` the enrollment once, then pass the d-vector to every
`step`. A masker that cannot stream (a non-causal UnetTcn, a UnetFsmn with
right context) is refused with a ValueError when the engine is built.

Equivalence contract (tested): streamed chunks of x equal offline
`inference` on [zeros(n_fft - hop), x] delayed by the masker's stream
delay, from sample n_fft on (the offline edge normaliser differs before).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..dsp.stft import overlap_add, periodic_hann_sumsquare
from ..nnet.base_nn import (apply_tf_masks, get_mask, ri_concat, run_speaker_net,
                            wav_output_constrain)
from ..nnet.encoder import ConvEncDec


def _asked(**flags) -> dict:
    return {k: True for k, v in flags.items() if v}


class StreamingNS(nn.Module):
    """Streaming wrapper over the offline wrapper's submodules (so its
    state_dict names) for a ConvEncDec encoder and a masker with
    `init_stream_state` / `stream_frames`, and the speaker net (and
    `encoder_spk`) of an STFT-domain TSE model."""

    def __init__(self, encoder: ConvEncDec, masker: nn.Module, speaker_net=None,
                 mask_constraint: str = "linear", output_constraint: str = "linear",
                 drop_first_bin: bool = True, f_type: str = "Complex",
                 mask_type: str = "Complex", encoder_spk: Optional[nn.Module] = None):
        super().__init__()
        if not isinstance(encoder, ConvEncDec):
            raise TypeError("StreamingNS requires a ConvEncDec (STFT) encoder")
        check = getattr(masker, "check_streamable", None)
        if check is not None:
            check()
        self.encoder, self.masker, self.encoder_spk = encoder, masker, encoder_spk
        self.speaker_net = nn.ModuleList(speaker_net) if speaker_net is not None else None
        self.mask_constraint, self.output_constraint = mask_constraint, output_constraint
        self.drop_first_bin, self.f_type, self.mask_type = drop_first_bin, f_type, mask_type

    @classmethod
    def from_offline(cls, model) -> "StreamingNS":
        """The engine over an offline SoTaskWrapModule's submodules."""
        return cls(model.encoder, model.masker, model.speaker_net,
                   model.mask_constraint, model.output_constraint,
                   model.drop_first_bin, model.f_type, model.mask_type,
                   model.encoder_spk)

    def embed(self, enroll: torch.Tensor) -> torch.Tensor:
        """Enrollment waveform [B, L] -> speaker embedding [B, E] (RI-concat
        features, the first bin dropped with `drop_first_bin`, through the
        speaker net; JAX `ns_engine.py:90-106`)."""
        enc = self.encoder_spk if self.encoder_spk is not None else self.encoder
        feats = enc(enroll)
        if isinstance(enc, ConvEncDec):
            feats = ri_concat(feats, self.drop_first_bin)
        return run_speaker_net(self.speaker_net, feats).squeeze(-1)

    @property
    def _mask_delay(self) -> int:
        return getattr(self.masker, "stream_delay_frames", 0)

    @property
    def _feat_ch(self) -> int:
        return 2 * (self.encoder.fft_length // 2 + 1 - (1 if self.drop_first_bin else 0))

    def init_state(self, batch: int, dtype=torch.float32, device=None,
                   dp_kernel: bool = False, mk_kernel: bool = False) -> dict:
        """Zero state for `batch` streams (the masker's layout for the
        dp_kernel / mk_kernel routes as asked); `wsum`, the OLA normaliser,
        stays float32 and has no stream axis."""
        n_fft, hop = self.encoder.fft_length, self.encoder.hop_length
        if device is None:
            device = self.encoder.encoder.wsin.device
        z = lambda *s: torch.zeros(s, device=device, dtype=dtype)
        routes = _asked(dp_kernel=dp_kernel, mk_kernel=mk_kernel)
        state = {"enc_tail": z(batch, n_fft - hop), "ola_tail": z(batch, n_fft - hop),
                 "wsum": torch.from_numpy(periodic_hann_sumsquare(n_fft, hop)).to(device),
                 "masker": self.masker.init_stream_state(batch, dtype, device, **routes)}
        if self._mask_delay > 0:
            # a lookahead masker emits mask[t - delay] at t: delay the
            # features to pair each mask with its own frame
            state["feat_q"] = z(batch, self._feat_ch, self._mask_delay)
        return state

    def step(self, chunk: torch.Tensor, state: dict,
             dvec: Optional[torch.Tensor] = None, fused: bool = False,
             dp_kernel: bool = False, int8_hh: bool = False,
             attn_kernel: bool = False, xscr_half: bool = False,
             mk_kernel: bool = False):
        """Advance every stream by a chunk [B, S] (S a multiple of the hop).
        fused=True runs the masker's recurrences through `lstm_scan`;
        attn_kernel=True a DPARN's intra passes through `dparn_intra_pass`;
        dp_kernel=True a DPCRN's whole bottleneck through `dual_path_chunk`
        and mk_kernel=True the six stride-1 inner layers through the
        wide-center kernel (state from init_state(dp_kernel=True) /
        init_state(mk_kernel=True)). `dvec` [B, E], the speaker embedding of
        each stream, conditions a TSE masker. Returns ([B, S], new state)."""
        if sum(map(bool, (fused, dp_kernel, mk_kernel))) > 1:
            raise ValueError("fused / dp_kernel / mk_kernel are mutually exclusive")
        n_fft, hop = self.encoder.fft_length, self.encoder.hop_length
        B, S = chunk.shape
        if S % hop:
            raise ValueError("chunk length must be a multiple of the hop")
        K = S // hop

        buf = torch.cat([state["enc_tail"], chunk.to(state["enc_tail"].dtype)], dim=-1)
        ri = self.encoder.encoder.stream_analysis_ri(buf, K, self.drop_first_bin)
        # only the routes asked for reach the masker (a UnetTcn takes none)
        routes = _asked(fused=fused, dp_kernel=dp_kernel, int8_hh=int8_hh,
                        attn_kernel=attn_kernel, xscr_half=xscr_half, mk_kernel=mk_kernel)
        if dvec is not None:
            mask, masker_state = self.masker.stream_frames(ri, state["masker"],
                                                           dvec.to(ri.dtype), **routes)
        else:
            mask, masker_state = self.masker.stream_frames(ri, state["masker"], **routes)
        mask = get_mask(mask, self.mask_constraint)
        feats, new_feat_q = ri, None
        if self._mask_delay > 0:
            cat = torch.cat([state["feat_q"], ri], dim=-1)
            feats, new_feat_q = cat[..., :K], cat[..., K:]
        enh = apply_tf_masks(feats, mask, self.mask_type, self.f_type)

        frames = self.encoder.encoder.stream_synthesis_frames(enh, self.drop_first_bin)
        ola = overlap_add(frames, hop)                 # [B, S + n_fft - hop]
        tail = n_fft - hop
        ola = torch.cat([ola[:, :tail] + state["ola_tail"], ola[:, tail:]], dim=-1)
        # bf16 / float32 promotes to float32, as in JAX
        emit = ola[:, :S] / state["wsum"].repeat(K)[None, :]
        new_state = {"enc_tail": buf[:, -tail:], "ola_tail": ola[:, S:],
                     "wsum": state["wsum"], "masker": masker_state}
        if new_feat_q is not None:
            new_state["feat_q"] = new_feat_q
        return wav_output_constrain(emit, self.output_constraint), new_state

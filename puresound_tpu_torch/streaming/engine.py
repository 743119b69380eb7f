"""Streaming TSE engine (counterpart of puresound_tpu/streaming/engine.py:27).

All per-stream state — encoder tail, the masker's state (SkiM's per-block
(h, c) and MemLSTM internals, a causal ConvTasNet's depthwise contexts, or
DPRNN's inter-segment (h, c)), decoder overlap-add carry — lives in one
explicit dict with a stream-batch axis; `step` advances every stream by one
chunk. The enrollment is embedded through `encoder_spk` where the model has
one; an embedding-free model (DPRNN "veve", no speaker net) takes its
conditioning through `init_state(enroll_feats=)` and steps with dvec None.

Equivalence contract (tested): feeding chunks of x equals offline
`inference` on `offline_equivalent_input(x)` truncated to the emitted length.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.stft import overlap_add
from ..nnet.base_nn import get_mask, run_speaker_net, wav_output_constrain
from ..nnet.encoder import FreeEncDec


class StreamingTSE(nn.Module):
    """Streaming wrapper sharing the offline wrapper's submodules (and so
    its state_dict names)."""

    def __init__(self, encoder: FreeEncDec, masker: nn.Module,
                 speaker_net=None, mask_constraint: str = "linear",
                 output_constraint: str = "linear", encoder_spk: Optional[nn.Module] = None):
        super().__init__()
        if not isinstance(encoder, FreeEncDec):
            raise TypeError("StreamingTSE requires a FreeEncDec encoder")
        if not (hasattr(masker, "init_state") and hasattr(masker, "step_frames")):
            raise TypeError("StreamingTSE requires a masker with the "
                            "streaming API (init_state/step_frames)")
        self.encoder = encoder
        self.encoder_spk = encoder_spk
        self.masker = masker
        self.speaker_net = (nn.ModuleList(speaker_net)
                            if speaker_net is not None else None)
        self.mask_constraint = mask_constraint
        self.output_constraint = output_constraint

    @classmethod
    def from_offline(cls, model) -> "StreamingTSE":
        """The engine over an offline SoTaskWrapModule's submodules."""
        return cls(model.encoder, model.masker, model.speaker_net,
                   model.mask_constraint, model.output_constraint, model.encoder_spk)

    def embed(self, enroll: torch.Tensor) -> torch.Tensor:
        """Enrollment waveform [B, L] -> speaker embedding [B, E], or the
        enrollment features [B, C, T'] of an embedding-free model (no speaker
        net), which go to `init_state(enroll_feats=)`."""
        enc = self.encoder_spk if self.encoder_spk is not None else self.encoder
        feats = enc(enroll)
        if self.speaker_net is None:
            return feats
        return run_speaker_net(self.speaker_net, feats).squeeze(-1)

    def init_state(self, batch: int, dtype=torch.float32, device=None,
                   enroll_feats: Optional[torch.Tensor] = None) -> dict:
        """The streams' state; `enroll_feats` (an embedding-free masker's
        `embed` output, [batch, C, T']) conditions the masker's initial
        recurrent state (`condition_stream_state`); step it with dvec None."""
        if device is None:
            device = self.encoder.decoder.weight.device
        keep = self.encoder.win_length - self.encoder.hop_length
        masker_state = self.masker.init_state(batch, dtype, device)
        if enroll_feats is not None:
            masker_state = self.masker.condition_stream_state(masker_state, enroll_feats)
        return {
            "enc_tail": torch.zeros((batch, keep), device=device, dtype=dtype),
            "dec_tail": torch.zeros((batch, keep), device=device, dtype=dtype),
            "skim": masker_state,
        }

    def step(self, chunk: torch.Tensor, dvec: Optional[torch.Tensor],
             state: dict, fused: bool = False, dot_dtype=torch.float32,
             int8_hh: bool = False, int8_full: bool = False):
        """Advance every stream by one chunk [B, S] (S a multiple of the hop).
        fused=True runs the SkiM block stack through the fused kernel (a
        ConvTasNet masker has none);
        int8_hh / int8_full quantize its recurrent (and, with int8_full, all
        its) products (`fused_skim_frames`). Returns ([B, S], new state)."""
        if (int8_hh or int8_full) and not fused:
            raise ValueError("int8_hh / int8_full go with fused=True")
        win, hop = self.encoder.win_length, self.encoder.hop_length
        S = chunk.shape[1]
        if S % hop:
            raise ValueError("chunk length must be a multiple of the hop")
        buf = torch.cat([state["enc_tail"], chunk.to(state["enc_tail"].dtype)],
                        dim=-1)
        feats = self.encoder(buf)                       # [B, C, K]
        frames = feats.transpose(1, 2)                  # [B, K, C]
        if fused:
            mask, skim_state = self.masker.step_frames_fused(
                frames, dvec, state["skim"], dot_dtype=dot_dtype,
                int8_hh=int8_hh, int8_full=int8_full)
        else:
            mask, skim_state = self.masker.step_frames(frames, dvec,
                                                       state["skim"])
        enh = feats * get_mask(mask, self.mask_constraint)
        frame_wavs = torch.einsum(
            "bck,cw->bkw", enh, self.encoder.decoder.weight[:, 0, :].to(enh.dtype))
        full = overlap_add(frame_wavs, hop)             # [B, S + win - hop]
        # the carry goes into the FULL buffer before slicing: with >50%
        # overlap part of it lands beyond the emitted samples
        full = torch.cat([full[:, :win - hop] + state["dec_tail"],
                          full[:, win - hop:]], dim=-1)
        out = wav_output_constrain(full[:, :S], self.output_constraint)
        return out, {"enc_tail": buf[:, -(win - hop):], "dec_tail": full[:, S:],
                     "skim": skim_state}


def offline_equivalent_input(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """Zero-prime by (win - hop) samples: offline inference on this equals
    the streamed output."""
    return F.pad(x, (win - hop, 0))

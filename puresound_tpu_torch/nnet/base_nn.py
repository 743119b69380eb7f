"""Task wrapper, inference path (counterpart of puresound_tpu/nnet/base_nn.py).

`SoTaskWrapModule.inference` (`base_nn.py:282`) with a time-domain
(FreeEncDec) encoder and real masks: encoder -> speaker net -> masker ->
mask -> decoder. The losses and training forwards are the training slice's
work (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .encoder import FreeEncDec


def get_mask(mask: torch.Tensor, mask_constraint: str = "linear") -> torch.Tensor:
    c = mask_constraint.lower()
    if c == "linear":
        return mask
    if c == "relu":
        return torch.relu(mask)
    if c == "sigmoid":
        return torch.sigmoid(mask)
    raise NotImplementedError(mask_constraint)


def wav_output_constrain(wav: torch.Tensor, mode: str) -> torch.Tensor:
    m = mode.lower()
    if m == "linear":
        return wav.clamp(-1.0, 1.0)
    if m == "sigmoid":
        return torch.sigmoid(wav)
    raise NameError(mode)


def run_speaker_net(layers, x: torch.Tensor) -> torch.Tensor:
    """Walk the speaker-net layers (TCN / pooling / conv)."""
    for layer in layers:
        x = layer(x)
    return x


class SoTaskWrapModule(nn.Module):
    """Single-output TSE wrapper: FreeEncDec -> (speaker net) -> masker ->
    real mask -> decoder. Submodule names match PureSound's wrapper."""

    def __init__(self, encoder: nn.Module, masker: nn.Module,
                 speaker_net: Optional[Sequence[nn.Module]] = None,
                 mask_constraint: str = "linear",
                 output_constraint: str = "linear"):
        super().__init__()
        if not isinstance(encoder, FreeEncDec):
            raise NotImplementedError(
                "only the FreeEncDec encoder (real masks) is ported (ROADMAP "
                "queue 1: NS brings ConvEncDec and complex masks)")
        self.encoder = encoder
        self.masker = masker
        self.speaker_net = (nn.ModuleList(speaker_net)
                            if speaker_net is not None else None)
        self.mask_constraint = mask_constraint
        self.output_constraint = output_constraint

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the training forward (losses) is not ported yet (ROADMAP queue "
            "1: SDRLoss + training step); use inference()")

    def _dvec(self, enroll_feats):
        return run_speaker_net(self.speaker_net, enroll_feats).squeeze(-1)

    def _mask_and_decode(self, noisy_feats, dvec):
        mask = (self.masker(noisy_feats, dvec) if dvec is not None
                else self.masker(noisy_feats))
        enh_feats = noisy_feats * get_mask(mask, self.mask_constraint)
        return wav_output_constrain(self.encoder.inverse(enh_feats),
                                    self.output_constraint)

    def inference(self, noisy: torch.Tensor,
                  enroll: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noisy [N, L] (+ enroll [N, L']) -> enhanced [N, L]."""
        noisy_feats = self.encoder(noisy)
        dvec = None
        if enroll is not None:
            dvec = self._dvec(self.encoder(enroll))
        return self._mask_and_decode(noisy_feats, dvec)

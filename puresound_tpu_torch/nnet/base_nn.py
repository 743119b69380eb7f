"""Task wrapper (counterpart of puresound_tpu/nnet/base_nn.py).

`SoTaskWrapModule` with a time-domain (FreeEncDec) encoder and real masks:
encoder -> speaker net -> masker -> mask -> decoder. `forward` returns the
training loss of the task (`base_nn.py:200`): tasks 0/4 (`_forward`) and 1
(`_forward_join`); `inference` (`:282`) returns the waveform. The module's
own `training` flag takes the place of JAX's `train` argument.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def align_waveform(enh: torch.Tensor, ref: torch.Tensor,
                   truncate_enh: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length-align: pad ref at the front, or truncate (`base_nn.py:90`)."""
    le, lr = enh.shape[-1], ref.shape[-1]
    if le == lr:
        return enh, ref
    if lr < le:
        return enh, torch.nn.functional.pad(ref, (le - lr, 0))
    if truncate_enh:
        return enh[..., :lr], ref
    return enh, ref[..., :le]


def run_speaker_net(layers, x: torch.Tensor) -> torch.Tensor:
    """Walk the speaker-net layers (TCN / pooling / conv)."""
    for layer in layers:
        x = layer(x)
    return x


class SoTaskWrapModule(nn.Module):
    """Single-output TSE wrapper: FreeEncDec -> (speaker net) -> masker ->
    real mask -> decoder. Submodule names match PureSound's wrapper; the
    loss functions are plain callables and hold no parameters."""

    def __init__(self, encoder: nn.Module, masker: nn.Module,
                 speaker_net: Optional[Sequence[nn.Module]] = None,
                 loss_func_wav: Optional[Callable] = None,
                 loss_func_spk: Optional[Callable] = None,
                 loss_func_others: Optional[Callable] = None,
                 embedding_free_tse: bool = False,
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
        self.loss_func_wav = loss_func_wav
        self.loss_func_spk = loss_func_spk
        self.loss_func_others = loss_func_others
        self.embedding_free_tse = embedding_free_tse
        self.mask_constraint = mask_constraint
        self.output_constraint = output_constraint

    @property
    def task(self) -> Optional[int]:
        """Task label (`base_nn.py:137-147`): 0 SE, 1 TSE (+ speaker loss),
        2 contrastive, 3 three-loss, 4 embedding-free TSE; None for a
        wrapper without losses."""
        if self.speaker_net is None:
            return 4 if self.embedding_free_tse else 0
        if self.loss_func_spk is not None:
            if self.loss_func_wav is None:
                return 2
            return 3 if self.loss_func_others is not None else 1
        if self.loss_func_wav is None and self.loss_func_spk is None:
            return None
        return 1

    def forward(self, noisy, enroll=None, ref_clean=None, spk_class=None,
                inactive_labels=None, alpha: float = 10.0,
                return_loss_detail: bool = False):
        """The task's training loss (batch statistics when `self.training`)."""
        task = self.task
        if task in (0, 4):
            return self._forward(noisy, enroll, ref_clean, inactive_labels)
        if task == 1:
            return self._forward_join(noisy, enroll, ref_clean, spk_class, alpha,
                                      return_loss_detail, inactive_labels)
        if task in (2, 3):
            raise NotImplementedError(
                f"task {task} (GE2E / triplet losses) is not ported yet "
                "(ROADMAP queue 1: loss/metrics.py)")
        raise NotImplementedError("wrapper constructed without loss functions")

    def _dvec(self, enroll_feats):
        return run_speaker_net(self.speaker_net, enroll_feats).squeeze(-1)

    def _condition(self, enroll):
        if enroll is None:
            return None
        feats = self.encoder(enroll)
        return feats if self.embedding_free_tse else self._dvec(feats)

    def _mask_and_decode(self, noisy_feats, dvec):
        mask = (self.masker(noisy_feats, dvec) if dvec is not None
                else self.masker(noisy_feats))
        enh_feats = noisy_feats * get_mask(mask, self.mask_constraint)
        return wav_output_constrain(self.encoder.inverse(enh_feats),
                                    self.output_constraint)

    def _forward(self, noisy, enroll, ref_clean, inactive_labels):
        enh_wav = self._mask_and_decode(self.encoder(noisy),
                                        self._condition(enroll))
        enh_wav, ref_clean = align_waveform(enh_wav, ref_clean)
        return self.loss_func_wav(enh_wav, ref_clean, inactive_labels)

    def _forward_join(self, noisy, enroll, ref_clean, spk_class, alpha,
                      return_loss_detail, inactive_labels):
        dvec = self._dvec(self.encoder(enroll))
        enh_wav = self._mask_and_decode(self.encoder(noisy), dvec)
        enh_wav, ref_clean = align_waveform(enh_wav, ref_clean)
        loss_wav = self.loss_func_wav(enh_wav, ref_clean, inactive_labels)
        if self.loss_func_spk is not None and spk_class is not None:
            loss_spk = self.loss_func_spk(dvec, spk_class)
            if return_loss_detail:
                return loss_wav + alpha * loss_spk, (loss_wav, loss_spk)
            return loss_wav + alpha * loss_spk
        return loss_wav

    def inference(self, noisy: torch.Tensor,
                  enroll: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noisy [N, L] (+ enroll [N, L']) -> enhanced [N, L]."""
        return self._mask_and_decode(self.encoder(noisy), self._condition(enroll))

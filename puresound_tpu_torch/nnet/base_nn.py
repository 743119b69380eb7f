"""Task wrapper and mask algebra (counterpart of puresound_tpu/nnet/base_nn.py).

`SoTaskWrapModule` with a time-domain (FreeEncDec) encoder and real masks,
or a conv-STFT (ConvEncDec) encoder with RI-concat features (the first bin
dropped and re-padded when `drop_first_bin`) and any mask of
`apply_tf_masks`: encoder -> speaker net -> masker -> mask -> decoder; the
enrollment goes through `encoder_spk` where one is set (`tse_skim_v2_causal`'s
FbankEnc), else through the mixture's encoder. `forward` returns the
training loss of the task (`base_nn.py:200`): tasks 0/4 (`_forward`), 1
(`_forward_join`), 2 (`_forward_contrastive`) and 3 (`_forward_join_loop`);
`inference` (`:282`) returns the waveform. `SiMoTaskWrapModule` (`:296-371`)
is the single-input multi-output wrapper of DSS: an [N, M, C, T] mask applied
to the repeated mixture and decoded into [N, M, L]. The module's own
`training` flag takes the place of JAX's `train` argument.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from .encoder import ConvEncDec, FbankEnc, FreeEncDec


def mul_complex(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Entrywise complex product of [.., 2] RI tensors."""
    r1, i1 = x1[..., 0], x1[..., 1]
    r2, i2 = x2[..., 0], x2[..., 1]
    return torch.stack([r1 * r2 - i1 * i2, r1 * i2 + i1 * r2], dim=-1)


def apply_tf_masks(tf_rep: torch.Tensor, est_masks: torch.Tensor,
                   mask_type: str, f_type: str) -> torch.Tensor:
    """Apply a TF mask (`base_nn.py:49-78`). tf_rep / est_masks [N, C, T] or
    RI-concat [N, 2C, T]; (mask_type, f_type) one of complex/complex,
    real/complex, real/real, polar/polar."""
    mt, ft = mask_type.lower(), f_type.lower()
    if mt == "real" and ft == "real":
        return tf_rep * est_masks
    re, im = torch.chunk(tf_rep, 2, dim=1)
    if mt == "real" and ft == "complex":
        return torch.cat([re * est_masks, im * est_masks], dim=1)
    mre, mim = torch.chunk(est_masks, 2, dim=1)
    if mt == "complex" and ft == "complex":
        out = mul_complex(torch.stack([re, im], -1), torch.stack([mre, mim], -1))
        return torch.cat([out[..., 0], out[..., 1]], dim=1)
    if mt == "polar" and ft == "polar":
        tf_mag = torch.sqrt(re ** 2 + im ** 2 + 1e-8)
        tf_phase = torch.atan2(im, re)
        mask_mag = torch.sqrt(mre ** 2 + mim ** 2 + 1e-8)
        mask_phase = torch.atan2(mim / (mask_mag + 1e-8), mre / (mask_mag + 1e-8))
        est_mag = tf_mag * torch.tanh(mask_mag)
        est_phase = tf_phase + mask_phase
        return torch.cat([est_mag * torch.cos(est_phase),
                          est_mag * torch.sin(est_phase)], dim=1)
    raise NameError(f"unsupported mask/feature combination {mask_type}/{f_type}")


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


def check_encoder(encoder: nn.Module) -> None:
    """The mixture encoder must decode its own features: FreeEncDec or
    ConvEncDec. FbankEnc's inverse takes (mel, phase), not the masked
    features the wrapper decodes (JAX's `_decode` fails on it as well), so
    it serves as `encoder_spk` only."""
    if isinstance(encoder, FbankEnc):
        raise ValueError("FbankEnc cannot be the mixture encoder: the wrapper decodes "
                         "with encoder.inverse(feats) and FbankEnc's inverse takes (mel, "
                         "phase); pass it as encoder_spk")
    if not isinstance(encoder, (FreeEncDec, ConvEncDec)):
        raise TypeError(f"the mixture encoder must be FreeEncDec or ConvEncDec, not "
                        f"{type(encoder).__name__}")


def ri_concat(feats: torch.Tensor, drop_first_bin: bool) -> torch.Tensor:
    """An STFT's [N, F, T, 2] -> the RI-concat features [N, 2F', T], the
    first (DC) bin dropped with `drop_first_bin`."""
    lo = 1 if drop_first_bin else 0
    return torch.cat([feats[:, lo:, :, 0], feats[:, lo:, :, 1]], dim=1)


def run_speaker_net(layers, x: torch.Tensor) -> torch.Tensor:
    """Walk the speaker-net layers (TCN / pooling / conv)."""
    for layer in layers:
        x = layer(x)
    return x


class SoTaskWrapModule(nn.Module):
    """Single-output wrapper (SE / TSE): encoder -> (speaker net) -> masker
    -> mask -> decoder. Submodule names match PureSound's wrapper. A loss
    that is an `nn.Module` (GE2E, AAM-softmax) is a submodule: its
    parameters train with the model under `loss_func_spk.*`."""

    def __init__(self, encoder: nn.Module, masker: nn.Module,
                 speaker_net: Optional[Sequence[nn.Module]] = None,
                 loss_func_wav: Optional[Callable] = None,
                 loss_func_spk: Optional[Callable] = None,
                 loss_func_others: Optional[Callable] = None,
                 embedding_free_tse: bool = False,
                 mask_constraint: str = "linear",
                 output_constraint: str = "linear", f_type: str = "real",
                 mask_type: str = "real", drop_first_bin: bool = False,
                 encoder_spk: Optional[nn.Module] = None):
        super().__init__()
        check_encoder(encoder)
        self.encoder = encoder
        self.encoder_spk = encoder_spk
        self.masker = masker
        self.speaker_net = (nn.ModuleList(speaker_net)
                            if speaker_net is not None else None)
        self.loss_func_wav = loss_func_wav
        self.loss_func_spk = loss_func_spk
        self.loss_func_others = loss_func_others
        self.embedding_free_tse = embedding_free_tse
        self.mask_constraint = mask_constraint
        self.output_constraint = output_constraint
        self.f_type, self.mask_type = f_type, mask_type
        self.drop_first_bin = drop_first_bin

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
        if task == 2:
            return self._forward_contrastive(noisy, enroll)
        if task == 3:
            return self._forward_join_loop(noisy, enroll, ref_clean, spk_class, alpha,
                                           return_loss_detail, inactive_labels)
        raise NotImplementedError("wrapper constructed without loss functions")

    def _encode(self, wav, encoder=None):
        """Waveform -> features ([N, C, T]; RI-concat for the STFT) through
        `encoder`, the mixture's by default."""
        encoder = self.encoder if encoder is None else encoder
        feats = encoder(wav)
        return ri_concat(feats, self.drop_first_bin) if isinstance(encoder, ConvEncDec) else feats

    def _encode_enroll(self, wav):
        """Enrollment waveform -> speaker-net features: through
        `encoder_spk` where one is set (JAX `base_nn.py:162-170`)."""
        return self._encode(wav, self.encoder_spk)

    def _decode(self, enh_feats):
        """Masked features -> waveform (the DC bin re-padded for the STFT)."""
        if isinstance(self.encoder, ConvEncDec):
            re, im = torch.chunk(enh_feats, 2, dim=1)
            if self.drop_first_bin:
                re = torch.nn.functional.pad(re, (0, 0, 1, 0))
                im = torch.nn.functional.pad(im, (0, 0, 1, 0))
            enh_feats = torch.stack([re, im], dim=-1)
        return self.encoder.inverse(enh_feats)

    def _dvec(self, enroll_feats):
        return run_speaker_net(self.speaker_net, enroll_feats).squeeze(-1)

    def _condition(self, enroll):
        if enroll is None:
            return None
        feats = self._encode_enroll(enroll)
        return feats if self.embedding_free_tse else self._dvec(feats)

    def _mask_and_decode(self, noisy_feats, dvec):
        mask = (self.masker(noisy_feats, dvec) if dvec is not None
                else self.masker(noisy_feats))
        enh_feats = apply_tf_masks(noisy_feats, get_mask(mask, self.mask_constraint),
                                   self.mask_type, self.f_type)
        return wav_output_constrain(self._decode(enh_feats), self.output_constraint)

    def _forward(self, noisy, enroll, ref_clean, inactive_labels):
        enh_wav = self._mask_and_decode(self._encode(noisy),
                                        self._condition(enroll))
        enh_wav, ref_clean = align_waveform(enh_wav, ref_clean)
        return self.loss_func_wav(enh_wav, ref_clean, inactive_labels)

    def _forward_join(self, noisy, enroll, ref_clean, spk_class, alpha,
                      return_loss_detail, inactive_labels):
        dvec = self._dvec(self._encode_enroll(enroll))
        enh_wav = self._mask_and_decode(self._encode(noisy), dvec)
        enh_wav, ref_clean = align_waveform(enh_wav, ref_clean)
        loss_wav = self.loss_func_wav(enh_wav, ref_clean, inactive_labels)
        if self.loss_func_spk is not None and spk_class is not None:
            loss_spk = self.loss_func_spk(dvec, spk_class)
            if return_loss_detail:
                return loss_wav + alpha * loss_spk, (loss_wav, loss_spk)
            return loss_wav + alpha * loss_spk
        return loss_wav

    def _forward_contrastive(self, noisy, enroll):
        """GE2E on the enrollment's and the enhanced waveform's d-vectors."""
        dvec = self._dvec(self._encode_enroll(enroll))
        enh_wav = self._mask_and_decode(self._encode(noisy), dvec)
        # as JAX (`base_nn.py:252-254`): the enhanced waveform is re-embedded
        # through the mixture encoder
        enh_dvec = self._dvec(self._encode(enh_wav))
        N = dvec.shape[0]
        # JAX's interleave (`:256-258`): row 2i is dvec i, row 2i + 1 its
        # enhanced waveform's d-vector, so GE2E sees N speakers x 2
        total = torch.cat([dvec, enh_dvec], dim=-1).reshape(N * 2, -1)
        return self.loss_func_spk(total, None)

    def _forward_join_loop(self, noisy, enroll, ref_clean, spk_class, alpha,
                           return_loss_detail, inactive_labels):
        """Task 1's losses plus the triplet (enrollment, enhanced, residual
        noise) over their d-vectors, weighted 1 / alpha."""
        dvec = self._dvec(self._encode_enroll(enroll))
        enh_wav = self._mask_and_decode(self._encode(noisy), dvec)
        enh_dvec = self._dvec(self._encode_enroll(enh_wav))
        noise_dvec = self._dvec(self._encode_enroll(noisy - enh_wav))
        triplet = torch.stack([dvec, enh_dvec, noise_dvec], dim=1)
        enh_wav, ref_clean = align_waveform(enh_wav, ref_clean)
        loss_wav = self.loss_func_wav(enh_wav, ref_clean, inactive_labels)
        if self.loss_func_spk is not None and spk_class is not None:
            loss_spk = self.loss_func_spk(dvec, spk_class)
            loss_loop = self.loss_func_others(triplet)
            total = loss_wav + alpha * loss_spk + (1 / alpha) * loss_loop
            if return_loss_detail:
                return total, (loss_wav, loss_spk, (1 / alpha) * loss_loop)
            return total
        return loss_wav

    def inference(self, noisy: torch.Tensor,
                  enroll: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noisy [N, L] (+ enroll [N, L']) -> enhanced [N, L]."""
        return self._mask_and_decode(self._encode(noisy), self._condition(enroll))

    def inference_tse_embedding(self, enroll: torch.Tensor) -> torch.Tensor:
        """Enrollment [N, L'] -> the speaker net's output (JAX
        `base_nn.py:291-293`): [N, E, 1] for the pooled nets."""
        return run_speaker_net(self.speaker_net, self._encode_enroll(enroll))


class SiMoTaskWrapModule(nn.Module):
    """Single-input multi-output wrapper (DSS separation): the masker emits
    [N, M, C, T] masks, the mixture's features are repeated per source and
    flattened into the batch for the mask and the decoder (`base_nn.py:296`).
    `forward` returns the training loss, `inference` [N, M, L]."""

    def __init__(self, encoder: nn.Module, masker: nn.Module,
                 loss_func_wav: Optional[Callable] = None, f_type: str = "real",
                 mask_type: str = "real", mask_constraint: str = "linear",
                 output_constraint: str = "linear", drop_first_bin: bool = False):
        super().__init__()
        check_encoder(encoder)
        self.encoder, self.masker = encoder, masker
        self.loss_func_wav = loss_func_wav
        self.f_type, self.mask_type = f_type, mask_type
        self.mask_constraint = mask_constraint
        self.output_constraint = output_constraint
        self.drop_first_bin = drop_first_bin

    _encode = SoTaskWrapModule._encode
    _decode = SoTaskWrapModule._decode

    def _decode_multi(self, enh_feats: torch.Tensor) -> torch.Tensor:
        """[N, M, C, T] -> [N, M, L], all N * M streams in one decode."""
        N, M, C, T = enh_feats.shape
        return self._decode(enh_feats.reshape(N * M, C, T)).reshape(N, M, -1)

    def _separate(self, noisy: torch.Tensor) -> torch.Tensor:
        feats = self._encode(noisy)
        mask = get_mask(self.masker(feats), self.mask_constraint)   # [N, M, C, T]
        N, M, C, T = mask.shape
        rep = feats[:, None].expand(N, M, C, T).reshape(N * M, C, T)
        enh = apply_tf_masks(rep, mask.reshape(N * M, C, T), self.mask_type, self.f_type)
        return wav_output_constrain(self._decode_multi(enh.reshape(N, M, C, T)),
                                    self.output_constraint)

    def forward(self, noisy, ref_clean, inactive_labels=None):
        """The loss of [N, M, L] outputs against ref_clean [N, M, L'] (ref
        truncated or front-padded to the outputs, as JAX's `:348-352`): a
        source-aggregated loss takes [N, M, L] with inactive labels [N, M],
        any other the flattened [N * M, L] with [N * M] labels (`:353-366`)."""
        enh_wav, ref_clean = align_waveform(self._separate(noisy), ref_clean)
        N, M, L = enh_wav.shape
        if getattr(self.loss_func_wav, "source_aggregated", False):
            return self.loss_func_wav(enh_wav, ref_clean, inactive_labels)
        inact = inactive_labels.reshape(-1) if inactive_labels is not None else None
        return self.loss_func_wav(enh_wav.reshape(N * M, -1),
                                  ref_clean.reshape(N * M, -1), inact)

    def inference(self, noisy: torch.Tensor) -> torch.Tensor:
        """noisy [N, L] -> the M separated sources [N, M, L]."""
        return self._separate(noisy)

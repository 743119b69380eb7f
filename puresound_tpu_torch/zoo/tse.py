"""TSE model zoo (counterpart of puresound_tpu/zoo/tse.py): the flagship
`tse_skim_v0_causal` (`:157-170`) and `init_loss` (`:33`) for the SDR
losses. The other names and losses are still JAX-only."""
from __future__ import annotations

from typing import Optional

import torch

from ..nnet.base_nn import SoTaskWrapModule
from ..nnet.conv_tasnet import TCN
from ..nnet.encoder import FreeEncDec
from ..nnet.lobe.cnn import Conv1d
from ..nnet.lobe.pooling import AttentiveStatisticsPooling
from ..nnet.loss.sdr import SDRLoss
from ..nnet.skim import SkiM
from ..utils.init import generator_or_default

#: zoo names of the JAX package that this port does not build yet
JAX_ONLY = ("td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal",
            "tse_unet_tcn_v0", "tse_unet_tcn_v0_causal", "tse_unet_tcn_v1",
            "tse_skim_v0", "tse_skim_v1_causal", "tse_skim_v2_causal",
            "tse_skim_v0_causal_vad", "veve_dprnn_v0_causal")


def init_loss(hparam):
    """(sig_loss, cls_loss) from the LOSS config (`:33`): the SDR losses
    `sisnr`, `sdsdr`, `sdr`, `tsdr` with `sig_threshold`; no speaker loss."""
    loss = hparam["LOSS"]
    sig_loss, cls_loss = loss.get("sig_loss"), loss.get("cls_loss")
    if cls_loss or loss.get("cls_loss_other"):
        raise NotImplementedError(
            f"speaker loss {cls_loss or loss.get('cls_loss_other')!r} is not ported "
            "yet (ROADMAP queue 1 item 5: loss/metrics.py, loss/aamsoftmax.py)")
    if not sig_loss:
        return None, None
    if sig_loss.lower() not in ("sisnr", "sdsdr", "sdr", "tsdr"):
        raise NotImplementedError(
            f"signal loss {sig_loss!r} is not ported yet (ROADMAP queue 1 item 6: "
            "loss/stft_loss.py; item 5: F1)")
    return SDRLoss.init_mode(sig_loss.lower(), threshold=loss.get("sig_threshold")), None


def _tcn_speaker_net(feat_dim: int, embed_dim: int = 192, tcn_dim: int = 256,
                     **fk):
    """5x TCN + ASP pooling + 1x1 conv (the standard TSE speaker net)."""
    return ([TCN(feat_dim, tcn_dim, kernel=3, dilation=2 ** i,
                 tcn_norm="gLN", dconv_norm="gGN", **fk) for i in range(5)]
            + [AttentiveStatisticsPooling(feat_dim, 128, **fk),
               Conv1d(feat_dim * 2, embed_dim, 1, bias=False, **fk)])


def _device(device):
    """None means the card; the CPU only when a caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_model builds on the CUDA card by default and torch sees none "
            "(torch.cuda.is_available() is False); pass device='cpu' to build "
            "on the CPU")
    return torch.device("cuda")


def init_model(name: str, sig_loss=None, cls_loss=None, other_loss=None, *,
               device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None) -> SoTaskWrapModule:
    """Build a named TSE model in eval mode, on the card unless `device`
    says otherwise. The losses make `forward` the training loss
    (`sig_loss` the waveform loss, `cls_loss` the speaker loss)."""
    if name == "tse_skim_v0_causal":
        # 6,375,440 parameters, as the JAX package counts; lookahead 16
        fk = dict(device=_device(device), dtype=dtype,
                  generator=generator_or_default(generator))
        return SoTaskWrapModule(
            encoder=FreeEncDec(win_length=32, hop_length=16, laten_length=128,
                               output_active=True, **fk),
            masker=SkiM(input_size=128, hidden_size=256, output_size=128,
                        n_blocks=4, seg_size=150, seg_overlap=False,
                        causal=True, embed_dim=192, embed_norm=True,
                        block_with_embed=(1, 1, 1, 1), embed_fusion="FiLM",
                        **fk),
            speaker_net=_tcn_speaker_net(128, **fk),
            loss_func_wav=sig_loss, loss_func_spk=cls_loss,
            loss_func_others=other_loss, mask_constraint="ReLU").eval()
    if name in JAX_ONLY:
        raise NotImplementedError(
            f"{name!r} is not ported yet (ROADMAP queue 1: the rest of the "
            "TSE zoo); only 'tse_skim_v0_causal' is")
    raise NameError(name)

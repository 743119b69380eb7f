"""TSE model zoo (counterpart of puresound_tpu/zoo/tse.py): the SkiM models
`tse_skim_v0` / `tse_skim_v0_causal` (`:157-170`, the flagship the causal
one), `tse_skim_v1_causal` (a BiLSTM speaker net, `:172-189`),
`tse_skim_v2_causal` (FbankEnc + SpecAugment + TCN speaker net,
`:191-210`), the PVAD model `tse_skim_v0_causal_vad` (`:212-224`), the
Conv-TasNet models `td_tse_conv_tasnet_v0` / `_causal` (`:94-121`), the
embedding-free DPRNN `veve_dprnn_v0_causal` (`:226-237`), the STFT-domain
UnetTcn models `tse_unet_tcn_v0` / `_v0_causal` / `_v1` (`:123-155`),
`init_loss` (`:33`) with every loss of the JAX package's, and
`cross_entropy` (`:25`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..nnet.base_nn import SoTaskWrapModule
from ..nnet.conv_tasnet import TCN, ConvTasNet, GatedTCN
from ..nnet.dprnn import DPRNN
from ..nnet.encoder import ConvEncDec, FbankEnc, FreeEncDec
from ..nnet.lobe.cnn import Conv1d
from ..nnet.lobe.pooling import AttentiveStatisticsPooling
from ..nnet.lobe.rnn import SingleRNN
from ..nnet.lobe.trivial import Magnitude, SpecAugment
from ..nnet.loss.aamsoftmax import AAMsoftmax
from ..nnet.loss.metrics import F1Loss, GE2ELoss, TripletLoss
from ..nnet.loss.sdr import SDRLoss
from ..nnet.loss.stft_loss import MultiResolutionSTFTLoss, over_suppression_loss
from ..nnet.skim import SkiM
from ..nnet.unet import UnetTcn
from ..utils.init import generator_or_default

#: zoo names of the JAX package that this port does not build yet
JAX_ONLY = ()
#: the STFT-domain TSE models
UNET_TCN = ("tse_unet_tcn_v0", "tse_unet_tcn_v0_causal", "tse_unet_tcn_v1")
#: the zoo names this port builds
PORTED = ("tse_skim_v0_causal", "tse_skim_v0_causal_vad", "td_tse_conv_tasnet_v0",
          "td_tse_conv_tasnet_v0_causal", "tse_skim_v0", "tse_skim_v1_causal",
          "tse_skim_v2_causal", "veve_dprnn_v0_causal") + UNET_TCN


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits [N, C] against integer labels [N] (a
    float32 one-hot, as JAX's)."""
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1])
    return -(onehot.to(torch.float32) * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def init_loss(hparam, *, device=None, dtype=torch.float32,
              generator: Optional[torch.Generator] = None):
    """(sig_loss, cls_loss), or (sig_loss, cls_loss, cls_loss_other) when the
    config names one, from the LOSS config (`:33-78`). The losses with
    parameters (GE2E's scale and bias, AAM-softmax's weight) are built on
    `device`, the card unless the caller says otherwise; AAM-softmax's
    weight draws from `generator`."""
    loss = hparam["LOSS"]
    sig_loss, cls_loss = loss.get("sig_loss"), loss.get("cls_loss")
    threshold = loss.get("sig_threshold")
    fk = lambda: dict(device=_device(device), dtype=dtype)

    sig = sig_loss.lower() if sig_loss else None
    if sig in ("sisnr", "sdsdr", "sdr", "tsdr"):
        sig_loss = SDRLoss.init_mode(sig, threshold=threshold)
    elif sig == "sisnr_stft":
        sdr_loss = SDRLoss.init_mode("sisnr", threshold=threshold)
        stft_loss = MultiResolutionSTFTLoss()
        sig_loss = lambda enh, ref, others: stft_loss(enh, ref) + sdr_loss(enh, ref, others)
    elif sig == "sisnr_ov":
        sdr_loss = SDRLoss.init_mode("sisnr", threshold=threshold)
        sig_loss = lambda enh, ref, others: (sdr_loss(enh, ref, others)
                                             + over_suppression_loss(enh, ref))
    elif sig == "f1":
        f1 = F1Loss()
        sig_loss = lambda enh, ref, others: f1(enh, ref)
    else:
        sig_loss = None

    cls = cls_loss.lower() if cls_loss else None
    if cls == "cross_entropy":
        cls_loss = cross_entropy
    elif cls == "aamsoftmax":
        cls_loss = AAMsoftmax(input_dim=loss["embed_dim"], n_class=loss["n_class"],
                              margin=loss["margin"], scale=loss["scale"],
                              generator=generator, **fk())
    elif cls == "ge2e":
        if not hparam["TRAIN"]["contrastive_learning"]:
            raise ValueError("cls_loss ge2e needs TRAIN.contrastive_learning: its "
                             "batches are p_spks speakers x p_utts utterances")
        cls_loss = GE2ELoss(nspks=hparam["TRAIN"]["p_spks"],
                            putts=hparam["TRAIN"]["p_utts"], add_norm=True, **fk())
    else:
        cls_loss = None

    other = loss.get("cls_loss_other")
    if other is None:
        return sig_loss, cls_loss
    if other.lower() == "triplet":
        return sig_loss, cls_loss, TripletLoss(margin=0.3, add_norm=True,
                                               distance="consine")
    raise NotImplementedError(other)


def _pooled(feat_dim: int, embed_dim: int = 192, **fk):
    """ASP pooling + the 1x1 conv to the d-vector, the speaker nets' tail."""
    return [AttentiveStatisticsPooling(feat_dim, 128, **fk),
            Conv1d(feat_dim * 2, embed_dim, 1, bias=False, **fk)]


def _tcn_speaker_net(feat_dim: int, embed_dim: int = 192, tcn_dim: int = 256,
                     **fk):
    """5x TCN + ASP pooling + 1x1 conv (the standard TSE speaker net)."""
    return ([TCN(feat_dim, tcn_dim, kernel=3, dilation=2 ** i,
                 tcn_norm="gLN", dconv_norm="gGN", **fk) for i in range(5)]
            + _pooled(feat_dim, embed_dim, **fk))


def _unet_tcn(name: str, losses: dict, **fk):
    """The STFT-domain TSE models (JAX `zoo/tse.py:123-155`): a trainable
    512-point STFT (hop 128), a 6-layer Unet (transpose_delay: 6 frames of
    lookahead, 1,152 samples with the overlap-add) around 3 x 5 GatedTCN
    blocks on the 128 x 4 = 512-wide bottleneck, the first of each stack
    taking the d-vector (by FiLM in v1); the speaker net the RI enrollment's
    magnitude through 5 GatedTCN(256, 128), ASP and a 1x1 conv. The causal
    model's masker norms are BatchNorm."""
    causal = name.endswith("causal")
    return SoTaskWrapModule(
        encoder=ConvEncDec(fft_length=512, win_type="hann", win_length=512, hop_length=128,
                           trainable=True, output_format="Complex", device=fk["device"],
                           dtype=fk["dtype"]),
        masker=UnetTcn(
            embed_dim=192, embed_norm=True, input_type="RI", input_dim=512,
            activation_type="PReLU", norm_type="bN2d" if causal else "gLN",
            channels=(1, 32, 64, 128, 128, 128, 128), transpose_t_size=2,
            transpose_delay=True, skip_conv=False, kernel_t=(2,) * 6, kernel_f=(5,) * 6,
            stride_t=(1,) * 6, stride_f=(2,) * 6, dilation_t=(1,) * 6,
            dilation_f=(1,) * 6, delay=(0,) * 6, tcn_layer="gated", tcn_kernel=3,
            tcn_dim=256, tcn_dilated_basic=2, per_tcn_stack=5, repeat_tcn=3,
            tcn_with_embed=(1, 0, 0, 0, 0), tcn_norm="bN1d" if causal else "gLN",
            dconv_norm="bN1d" if causal else "gGN", causal=causal,
            tcn_use_film=name.endswith("v1"), **fk),
        speaker_net=([Magnitude(drop_first=False)]
                     + [GatedTCN(256, 128, 3, dilation=2 ** i, causal=False, tcn_norm="gLN",
                                 **fk) for i in range(5)]
                     + _pooled(256, **fk)),
        mask_constraint="linear", drop_first_bin=True, **losses)


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
    if name not in PORTED:
        raise NameError(name)
    fk = dict(device=_device(device), dtype=dtype,
              generator=generator_or_default(generator))
    losses = dict(loss_func_wav=sig_loss, loss_func_spk=cls_loss,
                  loss_func_others=other_loss)
    if name in UNET_TCN:
        # 13,324,533 parameters (v0 and v0_causal; the causal one's 17,792
        # BatchNorm statistics beside) and 13,177,077 (v1), as JAX counts
        return _unet_tcn(name, losses, **fk).eval()
    if name in ("td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal"):
        # 10,156,311 parameters (v0), as the reference counts; the causal
        # model's masker norms are BatchNorm
        causal = name.endswith("causal")
        norms = ("bN1d", "bN1d") if causal else ("gLN", "gGN")
        return SoTaskWrapModule(
            encoder=FreeEncDec(win_length=32, hop_length=16, laten_length=512, **fk),
            masker=ConvTasNet(512, 192, True, tcn_kernel=3, tcn_dim=256,
                              repeat_tcn=3, tcn_dilated_basic=2, per_tcn_stack=8,
                              tcn_with_embed=(1, 0, 0, 0, 0, 0, 0, 0),
                              tcn_norm=norms[0], dconv_norm=norms[1], causal=causal,
                              tcn_layer="normal", **fk),
            speaker_net=_tcn_speaker_net(512, **fk), mask_constraint="ReLU",
            **losses).eval()
    skim_encoder = lambda: FreeEncDec(win_length=32, hop_length=16, laten_length=128,
                                      output_active=True, **fk)
    if name == "veve_dprnn_v0_causal":
        # embedding-free TSE (the enrollment's features condition the inter
        # LSTMs' initial states): 723,585 parameters, as the JAX zoo counts
        return SoTaskWrapModule(
            encoder=skim_encoder(),
            masker=DPRNN(input_size=128, hidden_size=64, output_size=128, n_blocks=6,
                         seg_size=20, seg_overlap=False, causal=True, embed_dim=0,
                         embed_norm=False, block_with_embed=(0,) * 6,
                         embedding_free_tse=True, **fk),
            speaker_net=None, mask_constraint="ReLU", embedding_free_tse=True,
            **losses).eval()
    # parameters as the JAX package counts: tse_skim_v0_causal 6,375,440;
    # tse_skim_v0 (both directions in every LSTM) 15,575,568;
    # tse_skim_v1_causal 6,249,217; tse_skim_v2_causal 6,221,552;
    # tse_skim_v0_causal_vad (PVAD, a Sigmoid output) 1,133,200
    vad = name.endswith("vad")
    n_blocks = 2 if vad else 4
    # the generator draws in the wrapper's order: encoder, masker, speaker net
    encoder = skim_encoder()
    masker = SkiM(input_size=128, hidden_size=64 if vad else 256, output_size=128,
                  n_blocks=n_blocks, seg_size=150, seg_overlap=False,
                  causal=name != "tse_skim_v0", embed_dim=192, embed_norm=True,
                  block_with_embed=(1,) * n_blocks, embed_fusion="FiLM", **fk)
    encoder_spk = None
    if name == "tse_skim_v1_causal":
        speaker_net = ([SingleRNN("LSTM", 128, 192, bidirectional=True, dropout=0.05, **fk)]
                       + _pooled(128, **fk))
    elif name == "tse_skim_v2_causal":
        encoder_spk = FbankEnc(trainable=False, output_format="Magnitude", n_banks=80,
                               device=fk["device"], dtype=fk["dtype"])
        speaker_net = ([SpecAugment(freq_mask_length=10, time_mask_length=0, fill_value=0.0,
                                    generator=fk["generator"])]
                       + [TCN(80, 256, kernel=3, dilation=2 ** i, tcn_norm="gLN",
                              dconv_norm="gGN", **fk) for i in range(5)]
                       + _pooled(80, **fk))
    else:
        speaker_net = _tcn_speaker_net(128, **fk)
    return SoTaskWrapModule(
        encoder=encoder, masker=masker, speaker_net=speaker_net, encoder_spk=encoder_spk,
        mask_constraint="ReLU", output_constraint="Sigmoid" if vad else "linear",
        **losses).eval()

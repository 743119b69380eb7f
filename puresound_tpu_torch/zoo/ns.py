"""NS model zoo (counterpart of puresound_tpu/zoo/ns.py): `ns_dpcrn_v0_causal`,
`ns_dparn_v0_causal` and their `transpose_delay` lookahead forms
`ns_dpcrn_v0` / `ns_dparn_v0`, and `init_loss` (`:15-27`)."""
from __future__ import annotations

from typing import Optional

import torch

from ..nnet.base_nn import SoTaskWrapModule
from ..nnet.dparn import DPARN
from ..nnet.dpcrn import DPCRN
from ..nnet.encoder import ConvEncDec
from ..nnet.loss.sdr import SDRLoss
from ..nnet.loss.stft_loss import MultiResolutionSTFTLoss, over_suppression_loss
from ..utils.init import generator_or_default
from .tse import _device

#: zoo names of the JAX package that this port does not build yet
JAX_ONLY = ()

def init_loss(hparam):
    """The signal loss of the LOSS config: the SDR modes (`sisnr`, `sdsdr`,
    `sdr`, `tsdr` with `sig_threshold`), `stft` (multi-resolution STFT) or
    `stft_ov` (that plus over-suppression); None for anything else."""
    sig_loss = hparam["LOSS"]["sig_loss"]
    sig = sig_loss.lower() if sig_loss else None
    if sig in ("sisnr", "sdsdr", "sdr", "tsdr"):
        return SDRLoss.init_mode(sig, threshold=hparam["LOSS"].get("sig_threshold"))
    if sig == "stft":
        loss = MultiResolutionSTFTLoss()
        return lambda enh, ref, dummy: loss(enh, ref)
    if sig == "stft_ov":
        loss = MultiResolutionSTFTLoss()
        return lambda enh, ref, dummy: loss(enh, ref) + over_suppression_loss(enh, ref)
    return None


_UNET_KW = dict(
    input_type="RI", input_dim=512, activation_type="PReLU",
    norm_type="bN2d", dropout=0.1, channels=(1, 32, 32, 32, 64, 128),
    transpose_t_size=2, skip_conv=False, kernel_t=(2, 2, 2, 2, 2),
    kernel_f=(5, 3, 3, 3, 3), stride_t=(1, 1, 1, 1, 1),
    stride_f=(2, 2, 1, 1, 1), dilation_t=(1, 1, 1, 1, 1),
    dilation_f=(1, 1, 1, 1, 1), delay=(0, 0, 0, 0, 0), rnn_hidden=128,
)


def init_model(name: str, sig_loss=None, *, device=None, dtype=torch.float32,
               generator: Optional[torch.Generator] = None) -> SoTaskWrapModule:
    """Build a named NS model in eval mode, on the card unless `device`
    says otherwise; `sig_loss` makes `forward` the training loss."""
    if name not in ("ns_dpcrn_v0_causal", "ns_dpcrn_v0", "ns_dparn_v0_causal",
                    "ns_dparn_v0"):
        raise NameError(name)
    fk = dict(device=_device(device), dtype=dtype)
    g = generator_or_default(generator)
    if name in ("ns_dpcrn_v0_causal", "ns_dpcrn_v0"):
        # 1,380,043 parameters, as the JAX package counts; lookahead 384
        # (causal) or 1024 (semi-causal)
        masker = DPCRN(transpose_delay=(name == "ns_dpcrn_v0"), generator=g,
                       **_UNET_KW, **fk)
    else:
        # 1,215,179 parameters; the same lookaheads
        masker = DPARN(transpose_delay=(name == "ns_dparn_v0"), nhead=8, generator=g,
                       **_UNET_KW, **fk)
    encoder = ConvEncDec(fft_length=512, win_type="hann", win_length=512,
                         hop_length=128, trainable=True, output_format="Complex", **fk)
    return SoTaskWrapModule(
        encoder=encoder, masker=masker, speaker_net=None, loss_func_wav=sig_loss,
        drop_first_bin=True, mask_constraint="linear", f_type="Complex",
        mask_type="Complex").eval()

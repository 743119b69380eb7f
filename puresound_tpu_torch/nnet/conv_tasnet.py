"""Residual TCN block (counterpart of puresound_tpu/nnet/conv_tasnet.py:38),
the unfused path (`:66-77`) in the speaker net's form: non-causal, no
embedding input. It trains through autograd, as JAX's stock path does; the
fused training kernel it can route to (`tcn_block_train`, `:79-105`) and the
causal / embedded blocks of ConvTasNet are still JAX-only (ROADMAP queues
1-2)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.init import generator_or_default
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d, DepthwiseSeparableConv1d
from .lobe.norm import get_norm


class TCN(nn.Module):
    """1x1-in -> norm -> PReLU -> DSConv -> 1x1-out, +res. x: [N, C, T].

    Layout follows PureSound:
    `in_conv` = Sequential(conv, norm, PReLU), `dconv` = Sequential(DSConv).
    """

    def __init__(self, in_channels: int, hid_channels: int, kernel: int,
                 dilation: int, tcn_norm: str = "gLN", dconv_norm: str = "gGN",
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.in_conv = nn.Sequential(
            Conv1d(in_channels, hid_channels, 1, bias=False, generator=g, **fk),
            get_norm(tcn_norm)(hid_channels, **fk), PReLU(**fk))
        self.dconv = nn.Sequential(DepthwiseSeparableConv1d(
            hid_channels, hid_channels, norm_cls=dconv_norm, kernel=kernel,
            dilation=dilation, generator=g, **fk))
        self.out_conv = Conv1d(hid_channels, in_channels, 1, generator=g, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_conv(self.dconv(self.in_conv(x))) + x

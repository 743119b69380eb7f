"""Residual TCN block (counterpart of puresound_tpu/nnet/conv_tasnet.py:38)
in the speaker net's form: non-causal, no embedding input.

Every block with global norms (gLN / gGN) and an odd kernel runs through
`ops.tcn_train_kernel.tcn_block_train`, in training and in inference alike
(JAX's `_fusable` / `_fused_call`, `:79-105`): the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor. JAX's v5e engagement floors
(`_FUSED_TCN_MIN_ROWS*`, `_FUSED_TCN_MAX_C_BF16`) and the
`PURESOUND_FUSED_TCN` switch are TPU facts and are dropped here. A block
with BatchNorm norms takes the stock path under autograd, as in JAX; the
causal / embedded blocks of ConvTasNet are still JAX-only (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.tcn_train_kernel import tcn_block_train
from ..utils.init import generator_or_default
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d, DepthwiseSeparableConv1d
from .lobe.norm import GlobLN, GroupNorm1, get_norm


def _gain_bias(norm: nn.Module):
    """(gamma, beta) of a global norm, or None for another kind."""
    if isinstance(norm, GlobLN):
        return norm.gamma, norm.beta
    if isinstance(norm, GroupNorm1):
        return norm.weight, norm.bias
    return None


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
        self.kernel, self.dilation = kernel, dilation
        self.in_conv = nn.Sequential(
            Conv1d(in_channels, hid_channels, 1, bias=False, generator=g, **fk),
            get_norm(tcn_norm)(hid_channels, **fk), PReLU(**fk))
        self.dconv = nn.Sequential(DepthwiseSeparableConv1d(
            hid_channels, hid_channels, norm_cls=dconv_norm, kernel=kernel,
            dilation=dilation, generator=g, **fk))
        self.out_conv = Conv1d(hid_channels, in_channels, 1, generator=g, **fk)

    def fused_params(self):
        """The block's parameters in `tcn_block_train`'s order, or None when
        the block is not one the kernel takes (other norms, an even kernel)."""
        ds = self.dconv[0]
        norms = [_gain_bias(n) for n in (self.in_conv[1], ds.depthwise[1],
                                         ds.pointwise[1])]
        if any(n is None for n in norms) or self.kernel % 2 == 0:
            return None
        (g1, b1), (g2, b2), (g3, b3) = norms
        return (self.in_conv[0].weight[:, :, 0], g1, b1, self.in_conv[2].weight,
                ds.depthwise[0].weight[:, 0, :], ds.depthwise[0].bias, g2, b2,
                ds.depthwise[2].weight, ds.pointwise[0].weight[:, :, 0],
                ds.pointwise[0].bias, g3, b3, ds.pointwise[2].weight,
                self.out_conv.weight[:, :, 0], self.out_conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = self.fused_params()
        if params is not None:
            return tcn_block_train(x, *params, dilation=self.dilation)
        return self.out_conv(self.dconv(self.in_conv(x))) + x

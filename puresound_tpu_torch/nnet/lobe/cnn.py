"""Conv building blocks (counterpart of puresound_tpu/nnet/lobe/cnn.py).

`Conv1d` is torch-compatible ([O, I/groups, K] weight) with explicit
symmetric padding; `DepthwiseSeparableConv1d` keeps PureSound's
`in_conv` / `depthwise` / `pointwise` Sequential layout so its state_dict
names match the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.init import generator_or_default, uniform
from .activation import PReLU
from .norm import get_norm


class Conv1d(nn.Module):
    """torch-compatible Conv1d on [N, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding, self.groups = padding, groups
        g = generator_or_default(generator)
        bound = math.sqrt(groups / (in_channels * kernel))
        self.weight = uniform((out_channels, in_channels // groups, kernel),
                              bound, g, device, dtype)
        self.bias = (uniform((out_channels,), bound, g, device, dtype)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding:
            x = F.pad(x, (self.padding, self.padding))
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv1d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)

    def dense_last(self, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv as a feature-LAST matmul: [..., C_in] -> [..., C_out]."""
        if not (self.kernel == 1 and self.stride == 1 and self.groups == 1):
            raise ValueError("dense_last is a 1x1-conv path")
        y = x @ self.weight[:, :, 0].T.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class DepthwiseSeparableConv1d(nn.Module):
    """Depthwise dilated conv -> 1x1 conv, each norm + PReLU (the
    non-causal form without 1x1-in or skip that the TCN block uses; the
    causal / transform / skip variants are still JAX-only, ROADMAP queue 1).
    """

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cls: str = "gGN", kernel: int = 3, stride: int = 1,
                 dilation: int = 1, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        norm = get_norm(norm_cls)
        self.depthwise = nn.Sequential(
            Conv1d(in_channels, in_channels, kernel, stride=stride,
                   dilation=dilation, padding=((kernel - 1) // 2) * dilation,
                   groups=in_channels, generator=g, **fk),
            norm(in_channels, **fk), PReLU(**fk))
        self.pointwise = nn.Sequential(
            Conv1d(in_channels, out_channels, 1, generator=g, **fk),
            norm(out_channels, **fk), PReLU(**fk))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))

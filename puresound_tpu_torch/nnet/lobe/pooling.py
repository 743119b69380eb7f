"""Attentive statistics pooling and `length_to_mask` (counterpart of
puresound_tpu/nnet/lobe/pooling.py:17, :22). In training mode its BatchNorm
takes batch statistics and updates its running stats (`pooling.py:41`)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.init import generator_or_default
from .cnn import Conv1d
from .norm import BatchNorm


def length_to_mask(length: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] float32 mask, 1 where the index is below
    the length."""
    return (torch.arange(max_len, device=length.device)[None, :]
            < length[:, None]).to(torch.float32)


class AttentiveStatisticsPooling(nn.Module):
    """Attention-weighted mean+std pool: [N, C, L] -> [N, 2C, 1].

    `tdnn` is PureSound's Sequential(conv, ReLU, BatchNorm, Tanh).
    """

    def __init__(self, channels: int, attention_channels: int = 128,
                 eps: float = 1e-12, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.eps = eps
        self.tdnn = nn.Sequential(
            Conv1d(channels, attention_channels, 1, generator=g, **fk),
            nn.ReLU(), BatchNorm(attention_channels, **fk), nn.Tanh())
        self.conv = Conv1d(attention_channels, channels, 1, generator=g, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Pools the full length (the JAX default `lengths=None`); the
        -inf mask of shorter lengths has no caller yet."""
        attn = torch.softmax(self.conv(self.tdnn(x)), dim=2)
        mean = torch.sum(attn * x, dim=2)
        var = torch.sum(attn * (x - mean[:, :, None]) ** 2, dim=2)
        std = torch.sqrt(var.clamp_min(self.eps))
        return torch.cat([mean, std], dim=1)[:, :, None]

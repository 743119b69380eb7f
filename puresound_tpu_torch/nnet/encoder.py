"""Learned filterbank front-end (counterpart of
puresound_tpu/nnet/encoder.py:60 `FreeEncDec`)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.init import generator_or_default, uniform


class _Filterbank(nn.Module):
    """Holds one [laten, 1, win] filterbank as `weight` (PureSound's
    nn.Conv1d / nn.ConvTranspose1d parameter name)."""

    def __init__(self, weight: nn.Parameter):
        super().__init__()
        self.weight = weight


class FreeEncDec(nn.Module):
    """Learned analysis/synthesis filterbank.

    forward: [N, L] -> [N, C, T] (strided conv, optional ReLU);
    inverse: [N, C, T] -> [N, L] (transposed conv).
    """

    def __init__(self, win_length: int = 512, laten_length: int = 512,
                 hop_length: int = 128, output_active: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.win_length, self.laten_length = win_length, laten_length
        self.hop_length, self.output_active = hop_length, output_active
        shape = (laten_length, 1, win_length)
        self.encoder = _Filterbank(uniform(shape, math.sqrt(1.0 / win_length),
                                           g, device, dtype))
        self.decoder = _Filterbank(uniform(
            shape, math.sqrt(1.0 / (laten_length * win_length)), g, device,
            dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = F.conv1d(x[:, None, :], self.encoder.weight.to(x.dtype),
                         stride=self.hop_length)
        return torch.relu(feats) if self.output_active else feats

    def inverse(self, feats: torch.Tensor) -> torch.Tensor:
        wav = F.conv_transpose1d(feats, self.decoder.weight.to(feats.dtype),
                                 stride=self.hop_length)
        return wav[:, 0, :]

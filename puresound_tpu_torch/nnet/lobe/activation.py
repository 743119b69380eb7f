"""PReLU (counterpart of puresound_tpu/nnet/lobe/activation.py:9)."""
from __future__ import annotations

import torch
from torch import nn

from ...utils.init import const


class PReLU(nn.Module):
    """PReLU with one learnable slope (torch's `weight`, init 0.25)."""

    def __init__(self, init: float = 0.25, *, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = const((1,), init, device, dtype)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)

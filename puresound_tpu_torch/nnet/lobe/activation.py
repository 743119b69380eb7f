"""Activations (counterpart of puresound_tpu/nnet/lobe/activation.py)."""
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


_REGISTRY = {"relu": nn.ReLU, "prelu": PReLU, "mish": nn.Mish,
             "sigmoid": nn.Sigmoid, "tanh": nn.Tanh}


def get_activation(name: str):
    """The activation class for a name (JAX `activation.py:50`); PReLU takes
    device / dtype, the others no arguments."""
    if name.lower() not in _REGISTRY:
        raise NameError(f"Could not interpret activation identifier: {name}")
    return _REGISTRY[name.lower()]

"""Dropout that draws its masks from the model's generator (counterpart of
flax's `nn.Dropout` as the JAX package's modules use it)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...parallel import remat
from ...utils.init import generator_or_default


class Dropout(nn.Module):
    """In training mode, zero each element with probability `p` and scale
    the others by 1 / (1 - p), as flax does (`where(keep, x / (1 - p), 0)`);
    in eval mode the identity. Each call draws a seed from the generator the
    model was built from and the mask from that seed on the input's device
    (a generator of that device's, made at its first use), never from
    torch's global RNG."""

    def __init__(self, p: float = 0.0, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator_or_default(generator)
        self._masks: Dict[torch.device, torch.Generator] = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.p):
            return x
        keep = torch.rand(x.shape, device=x.device, generator=remat.seeded_generator(
            self.generator, self._masks, x.device)) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                  device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"

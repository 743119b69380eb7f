"""Additive angular margin softmax head (counterpart of
puresound_tpu/nnet/loss/aamsoftmax.py:14-37)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...utils.init import generator_or_default


def glorot_truncated_normal(shape, generator: Optional[torch.Generator] = None,
                            device=None, dtype=torch.float32) -> nn.Parameter:
    """flax's `xavier_normal` (JAX's glorot normal) for a [fan_in, fan_out]
    matrix: a normal truncated at two standard deviations, scaled so that
    its standard deviation after truncation is sqrt(2 / (fan_in + fan_out)).
    Not `torch.nn.init.xavier_normal_`, which does not truncate."""
    std = math.sqrt(2.0 / (shape[-2] + shape[-1])) / 0.87962566103423978
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                generator=generator_or_default(generator))
    return nn.Parameter((w * std).to(device=device, dtype=dtype))


class AAMsoftmax(nn.Module):
    """Speaker classifier with an additive angular margin: x [N, input_dim],
    label [N] -> the mean cross-entropy of the margin logits."""

    def __init__(self, input_dim: int, n_class: int, margin: float = 0.2,
                 scale: float = 30.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_dim, self.n_class = input_dim, n_class
        self.margin, self.scale = margin, scale
        self.weight = glorot_truncated_normal((n_class, input_dim), generator,
                                              device, dtype)

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        norm = lambda t: t / torch.linalg.vector_norm(t, dim=1, keepdim=True).clamp(min=1e-12)
        cosine = norm(x) @ norm(self.weight).T                        # [N, n_class]
        sine = torch.sqrt((1.0 - cosine ** 2).clamp(0.0, 1.0))
        cos_m, sin_m = math.cos(self.margin), math.sin(self.margin)
        th = math.cos(math.pi - self.margin)
        mm = math.sin(math.pi - self.margin) * self.margin
        phi = cosine * cos_m - sine * sin_m
        phi = torch.where(cosine - th > 0, phi, cosine - mm)
        # a float32 one-hot, as JAX's: under bf16 compute the logits promote
        one_hot = nn.functional.one_hot(label.long(), self.n_class).to(torch.float32)
        logits = (one_hot * phi + (1.0 - one_hot) * cosine) * self.scale
        return -(one_hot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()

"""Parameter factories: explicit device/dtype, random draws from a Generator.

Draws happen on the CPU from a CPU `torch.Generator` and are then moved, so
one seed gives the same weights on every device.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def generator_or_default(generator: Optional[torch.Generator]) -> torch.Generator:
    """The caller's generator, or a fresh one seeded with 0 (never the
    global RNG)."""
    if generator is not None:
        return generator
    g = torch.Generator()
    g.manual_seed(0)
    return g


def uniform(shape: Sequence[int], bound: float,
            generator: Optional[torch.Generator] = None,
            device=None, dtype=torch.float32) -> torch.nn.Parameter:
    """U(-bound, bound) parameter (torch's conv / LSTM default init)."""
    g = generator_or_default(generator)
    w = torch.empty(tuple(shape), dtype=torch.float32).uniform_(
        -bound, bound, generator=g)
    return torch.nn.Parameter(w.to(device=device, dtype=dtype))


def const(shape: Sequence[int], value: float, device=None,
          dtype=torch.float32) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.full(tuple(shape), float(value),
                                         device=device, dtype=dtype))


def fan_in_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)

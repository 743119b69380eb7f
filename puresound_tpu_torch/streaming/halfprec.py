"""bfloat16 serving (counterpart of puresound_tpu/streaming/halfprec.py:23).

Cast a module's float32 parameters and buffers to bfloat16 in place;
other dtypes stay. The serving state is made in bfloat16 by the engine's
`init_state(n, torch.bfloat16)`. The fused kernel still carries h/c in
float32 inside a chunk and writes them back in the state's dtype.
"""
from __future__ import annotations

import torch
from torch import nn


def _cast(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def to_half(module: nn.Module) -> nn.Module:
    """Cast `module`'s float32 parameters and buffers in place; returns it."""
    with torch.no_grad():
        for p in module.parameters():
            p.data = _cast(p.data)
        for mod in module.modules():
            for name, buf in mod.named_buffers(recurse=False):
                setattr(mod, name, _cast(buf))
    return module

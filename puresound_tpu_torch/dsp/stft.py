"""Overlap-add (counterpart of puresound_tpu/dsp/stft.py:171)."""
from __future__ import annotations

import torch


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add frames [..., T, W] with stride `hop` -> [..., W + hop*(T-1)].

    When `hop` divides W, frame t splits into R = W // hop blocks and block
    r lands at output block t + r: R shifted adds, no scatter.
    """
    *lead, T, W = frames.shape
    if W % hop == 0:
        R = W // hop
        blocks = frames.reshape(*lead, T, R, hop)
        out = frames.new_zeros((*lead, T + R - 1, hop))
        for r in range(R):
            out[..., r:r + T, :] += blocks[..., :, r, :]
        return out.reshape(*lead, (T + R - 1) * hop)
    idx = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(W, device=frames.device)[None, :]).reshape(-1)
    out = frames.new_zeros((*lead, W + hop * (T - 1)))
    return out.index_add(-1, idx, frames.reshape(*lead, T * W))

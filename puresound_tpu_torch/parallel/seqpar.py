"""Sequence parallelism: one long recording spread over the mesh's devices
(counterpart of puresound_tpu/parallel/seqpar.py: `overlapped_chunks`
`:43`, `seq_parallel_infer` `:67`).

The time axis is cut into one chunk per device of the mesh (or of one named
axis), each extended by a left / right halo; each device runs the model's
offline forward on its chunk, the halos are dropped and the interiors are
joined back to T (overlap-discard across devices).

- A model with a finite receptive field (convolutions, TCN) is exact once
  halo_left covers its receptive field and halo_right its lookahead
  (`utils.model_info.probe_lookahead_receptive`).
- A recurrent model (LSTM, attention bottlenecks) takes the left halo as a
  burn-in of its state; the error falls as the halo grows.
- The first chunk's zero left halo forms analysis frames the whole-signal
  run never forms, so the recording's first samples (about a receptive
  field) may differ slightly; the boundaries between chunks are exact.

The mesh is single-process: a grid of this process's devices, which may
repeat a device. Each chunk goes to its device and the results come back to
x's device; nothing passes through the host. Calls on distinct CUDA devices
overlap (launches are asynchronous); on a repeated device they run in turn.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .mesh import Mesh, _local_mesh


def _round_up(v: int, align: int) -> int:
    return int(math.ceil(v / align) * align) if align > 1 else int(v)


def overlapped_chunks(x: torch.Tensor, n: int, halo_left: int, halo_right: int,
                      align: int = 1):
    """x [B, T] -> (chunks [n, B, halo_l + Lc + halo_r], Lc, T): chunk i
    starts at i * Lc of the zero-padded signal, Lc = ceil(T / n) rounded up
    to `align` (the encoder's hop, so every chunk frames on the whole
    signal's grid) and halo_l = halo_left rounded up to `align`. Keep
    y[..., halo_l:halo_l + Lc] of each chunk and cut the join to T."""
    B, T = x.shape
    halo_left = _round_up(halo_left, align)
    Lc = _round_up(int(math.ceil(T / n)), align)
    xp = F.pad(x, (halo_left, n * Lc - T + halo_right))
    win = halo_left + Lc + halo_right
    return torch.stack([xp[:, i * Lc:i * Lc + win] for i in range(n)]), Lc, T


def seq_parallel_infer(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                       mesh: Mesh, halo_left: int, halo_right: int = 0, align: int = 1,
                       axis: Optional[str] = None) -> torch.Tensor:
    """Offline inference `fn` ([B, Tc] -> [B, Tc], on its input's device)
    time-sharded over `mesh`: every device of the mesh, row by row, or
    those of `axis` ("dp" / "mp"). x: [T] or [B, T]; the result is on x's
    device. halo_left / halo_right: samples of context each chunk borrows
    from its neighbours (the receptive field / lookahead for exactness; a
    recurrent model buys accuracy with a longer halo_left). align: chunk
    starts snap to this grid (the encoder's hop). One device calls fn(x)."""
    _local_mesh(mesh, "seq_parallel_infer")
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    devices = mesh.along(axis)
    n = len(devices)
    if n == 1:
        y = fn(x)
        return y[0] if squeeze else y
    chunks, Lc, T = overlapped_chunks(x, n, halo_left, halo_right, align)
    halo_l = chunks.shape[-1] - Lc - halo_right
    # every chunk's call is launched before any result is read back
    outs = [fn(c.to(d, non_blocking=True))[..., halo_l:halo_l + Lc]
            for c, d in zip(chunks, devices)]
    y = torch.cat([o.to(x.device) for o in outs], dim=-1)[:, :T]
    return y[0] if squeeze else y

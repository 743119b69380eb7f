"""STFT substrate (counterpart of puresound_tpu/dsp/stft.py).

The window and Fourier-kernel builders are host-side numpy, copied from the
JAX package's module (`:27-91`, `:213-222`) so that the port imports nothing
of it; `overlap_add` (`:171`) and `window_sumsquare` (`:203`) run on tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (the convention of torch.hann_window)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def fourier_kernels(n_fft: int, win_length: Optional[int] = None,
                    freq_bins: Optional[int] = None, fmin: float = 50.0,
                    fmax: float = 6000.0, sr: int = 44100,
                    freq_scale: str = "no") -> Tuple[np.ndarray, np.ndarray, list, list]:
    """(wsin, wcos, bins2freq, bin_list): sin/cos analysis kernels [F, n_fft]
    with bins at DFT frequencies ("no"), or linearly / log spaced between
    fmin and fmax."""
    if freq_bins is None:
        freq_bins = n_fft // 2 + 1
    s = np.arange(0, n_fft, 1.0)
    if freq_scale == "linear":
        start_bin = fmin * n_fft / sr
        scale_ind = (fmax - fmin) * (n_fft / sr) / freq_bins
        k_bins = np.arange(freq_bins) * scale_ind + start_bin
    elif freq_scale == "log":
        start_bin = fmin * n_fft / sr
        scale_ind = np.log(fmax / fmin) / freq_bins
        k_bins = np.exp(np.arange(freq_bins) * scale_ind) * start_bin
    elif freq_scale == "no":
        k_bins = np.arange(freq_bins).astype(np.float64)
    else:
        raise ValueError(f"unknown freq_scale: {freq_scale}")
    phase = 2.0 * np.pi * k_bins[:, None] * s[None, :] / n_fft
    return (np.sin(phase).astype(np.float32), np.cos(phase).astype(np.float32),
            list(k_bins * sr / n_fft), list(k_bins))


def inverse_fourier_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse-DFT bases cos/sin [n_fft (freq), n_fft (time)]."""
    k = np.arange(n_fft)
    phase = 2.0 * np.pi * k[:, None] * k[None, :] / n_fft
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


def periodic_hann_sumsquare(n_fft: int, hop: int) -> np.ndarray:
    """One hop period of the steady-state sum of squared periodic Hann
    windows (needs hop | n_fft): the streaming iSTFT's normaliser, float32."""
    win = hann_window(n_fft).astype(np.float64) ** 2
    wsum = np.zeros(hop)
    for k in range(n_fft // hop):
        wsum += win[k * hop:(k + 1) * hop]
    return wsum.astype(np.float32)


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


def window_sumsquare(window: torch.Tensor, n_frames: int, hop: int,
                     n_fft: int, power: int = 2) -> torch.Tensor:
    """Sum of the `power`-ed window over n_frames overlapping frames
    ([n_fft + hop*(n_frames-1)]), in the window's dtype: the iSTFT's
    per-sample normaliser."""
    w = window.reshape(-1) ** power
    return overlap_add(w[None, :].expand(n_frames, n_fft), hop)

"""Multi-resolution STFT loss and over-suppression loss (counterpart of
puresound_tpu/nnet/loss/stft_loss.py: `stft_mag` `:20`, STFTLoss `:48`,
MultiResolutionSTFTLoss `:60`, over_suppression_loss `:76`).

`stft_mag` is torch.stft's framing (center=True, reflect pad, the window
zero-padded to fft_size, onesided) written out as in the JAX package. The
window is float32, as JAX's, so under bfloat16 compute the frames, the
magnitudes and the losses are float32, where JAX's bf16 step has them.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from ...dsp.stft import hann_window


@functools.lru_cache(maxsize=32)
def _window(win_length: int, device: torch.device) -> torch.Tensor:
    """The float32 periodic Hann window on `device` (built once; read only)."""
    return torch.from_numpy(hann_window(win_length)).to(device)


def stft_mag(x: torch.Tensor, fft_size: int, hop_size: int, win_length: int,
             window: torch.Tensor) -> torch.Tensor:
    """Magnitude spectrogram [B, frames, fft_size // 2 + 1] of x [B, L]."""
    pad = fft_size // 2
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    if win_length < fft_size:
        lpad = (fft_size - win_length) // 2
        window = torch.nn.functional.pad(window, (lpad, fft_size - win_length - lpad))
    frames = x.unfold(-1, fft_size, hop_size) * window
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.sqrt(torch.clamp(spec.abs() ** 2, min=1e-7))


def spectral_convergence_loss(x_mag, y_mag):
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude_loss(x_mag, y_mag):
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


class STFTLoss:
    """(spectral convergence, log magnitude) losses at one resolution."""

    def __init__(self, fft_size: int = 1024, shift_size: int = 120,
                 win_length: int = 600):
        self.fft_size, self.shift_size, self.win_length = fft_size, shift_size, win_length

    def __call__(self, x, y):
        window = _window(self.win_length, x.device)
        mag = lambda s: stft_mag(s, self.fft_size, self.shift_size, self.win_length,
                                 window)
        x_mag, y_mag = mag(x), mag(y)
        return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


class MultiResolutionSTFTLoss:
    """The STFT losses averaged over resolutions and weighted."""

    def __init__(self, fft_sizes: Sequence[int] = (1024, 2048, 512),
                 hop_sizes: Sequence[int] = (120, 240, 50),
                 win_lengths: Sequence[int] = (600, 1200, 240),
                 factor_sc: float = 0.1, factor_mag: float = 0.1):
        self.losses = [STFTLoss(fs, ss, wl)
                       for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths)]
        self.factor_sc, self.factor_mag = factor_sc, factor_mag

    def __call__(self, x, y):
        sc_loss = mag_loss = 0.0
        for loss in self.losses:
            sc, mag = loss(x, y)
            sc_loss = sc_loss + sc
            mag_loss = mag_loss + mag
        n = len(self.losses)
        return self.factor_sc * sc_loss / n + self.factor_mag * mag_loss / n


def over_suppression_loss(enh, ref, p: float = 0.5, fft_size: int = 512,
                          hop_size: int = 128, win_length: int = 512):
    """Penalise ref^p > enh^p (under-estimated magnitudes)."""
    window = _window(win_length, enh.device)
    enh_mag = stft_mag(enh, fft_size, hop_size, win_length, window)
    ref_mag = stft_mag(ref, fft_size, hop_size, win_length, window)
    diff = ref_mag ** p - enh_mag ** p
    return torch.mean(torch.where(diff > 0, diff, torch.zeros_like(diff)) ** 2)

"""Sinc/Blackman FIR filters + frequency/time dropout augmentations (a
copy of puresound_tpu/src/filter.py, numpy only, which the port keeps as
its own: it imports nothing of the JAX package).

Parity: puresound/src/filter.py (lowpass_filter :10, get_bandpass_filter :29,
get_notch_filter :50, wav_drop_frequency :86, wav_drop_chunk :124).  Cutoffs
are normalized (f / f_s), speechbrain-style.

Reference bugs reproduced-or-fixed (documented, per repo convention):
- ref `get_bandpass_filter` calls `Filter.get_lowpass_filter`, a method that
  does not exist (the method is named `lowpass_filter`) — AttributeError
  upstream; fixed here by calling the real name.
- ref `wav_drop_frequency`/`wav_drop_chunk` end with `out.unsqueeze(0)` on a
  numpy array (no such method) — crash upstream; fixed here with `out[None]`,
  matching the evident [1, L] intent of the docstrings.
Everything that runs upstream is numerically identical here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Filter:
    @staticmethod
    def lowpass_filter(cutoff: float, win_width: Optional[int] = None) -> np.ndarray:
        """Windowed-sinc lowpass FIR; kernel size 2*win_width+1.

        cutoff is normalized (f/f_s). win_width defaults to int(2/cutoff).
        """
        if win_width is None:
            win_width = int(2 / cutoff)
        window = np.blackman(2 * win_width + 1)
        t = np.arange(-win_width, win_width + 1, dtype=np.float32)
        sinc = np.sinc(2 * cutoff * t)
        return 2 * cutoff * sinc * window

    @staticmethod
    def get_bandpass_filter(
        cutoff_low: float, cutoff_high: float, win_width: Optional[int] = None
    ) -> np.ndarray:
        """Bandpass = lowpass(high) - lowpass(low), same kernel size."""
        if win_width is None:
            win_width = int(2 / (min(cutoff_low, cutoff_high)))
        low_filter = Filter.lowpass_filter(cutoff_low, win_width)
        high_filter = Filter.lowpass_filter(cutoff_high, win_width)
        return high_filter - low_filter

    @staticmethod
    def get_notch_filter(
        cutoff: float, notch_width: float = 0.05, win_width: Optional[int] = None
    ) -> np.ndarray:
        """Notch (band-reject) filter of length win_width centered at
        cutoff+notch_width with reject band ±notch_width (normalized freqs)."""
        if win_width is None:
            win_width = int(2 / cutoff)
        pad = win_width // 2
        inputs = np.arange(win_width) - pad

        # Avoid frequencies that are too low
        cutoff = cutoff + notch_width

        # lowpass below the notch
        hlpf = np.sinc(2 * (cutoff - notch_width) * inputs)
        hlpf = hlpf * np.blackman(win_width)
        hlpf = hlpf / np.sum(hlpf)

        # highpass above the notch (spectral inversion)
        hhpf = np.sinc(2 * (cutoff + notch_width) * inputs)
        hhpf = hhpf * np.blackman(win_width)
        hhpf = hhpf / -np.sum(hhpf)
        hhpf[pad] += 1

        return (hlpf + hhpf).reshape(-1)


def wav_drop_frequency(
    sig: np.ndarray, sr: int, cutoff_hz: float, drop_width_hz: float,
    win_width: int = 512,
) -> np.ndarray:
    """Notch out a frequency band by time-domain convolution. [L] -> [1, L]."""
    if sig.ndim == 2:
        sig = sig.squeeze()
    assert sig.ndim == 1

    nyquist_fs = sr / 2
    assert cutoff_hz < nyquist_fs
    if cutoff_hz + drop_width_hz > nyquist_fs:
        drop_width_hz = nyquist_fs - cutoff_hz

    cutoff = cutoff_hz / sr
    notch_width = drop_width_hz / sr

    notch_filter = Filter.get_notch_filter(cutoff, notch_width, win_width)
    out = np.convolve(sig, notch_filter, mode="same")
    return out[None]


def wav_drop_chunk(sig: np.ndarray, drop_start: float, drop_width: float) -> np.ndarray:
    """Zero a time chunk. drop_start/drop_width are fractions of the length.
    [L] -> [1, L]."""
    assert drop_start < 1.0
    assert 0 < drop_width < 1.0

    if sig.ndim == 2:
        sig = sig.squeeze()
    assert sig.ndim == 1

    if drop_start + drop_width > 1:
        drop_width = 1 - drop_start

    wav_len = sig.size
    start_idx = int(drop_start * wav_len)
    drop_len = int(drop_width * wav_len)
    mask = np.ones_like(sig)
    mask[start_idx : start_idx + drop_len] = 0.0
    out = sig * mask
    return out[None]

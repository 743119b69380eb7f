"""STFT substrate (counterpart of puresound_tpu/dsp/stft.py).

The window, Fourier-kernel and mel-filterbank builders are host-side numpy,
copied from the JAX package's module (`:27-91`, `:98-164`, `:213-222`) so
that the port imports nothing of it; `overlap_add` (`:171`) and `window_sumsquare` (`:203`) run on tensors.
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


def hz_to_mel(frequencies) -> np.ndarray:
    """Hz -> mel on the Slaney scale (librosa's default, no HTK)."""
    freqs = np.asanyarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = freqs >= min_log_hz
        mels = np.where(log_t, min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz)
                        / logstep, mels)
    elif freqs >= min_log_hz:
        mels = min_log_mel + np.log(freqs / min_log_hz) / logstep
    return mels


def mel_to_hz(mels) -> np.ndarray:
    """mel -> Hz, the inverse of `hz_to_mel`."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def fft_frequencies(sr: int = 16000, n_fft: int = 512) -> np.ndarray:
    return np.linspace(0, float(sr) / 2, int(1 + n_fft // 2), endpoint=True)


def mel_frequencies(n_mels: int = 128, fmin: float = 0.0, fmax: float = 8000.0) -> np.ndarray:
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sr: int, n_fft: int, n_banks: int = 128, fmin: float = 0.0,
                   fmax: Optional[float] = None, norm: int = 1) -> np.ndarray:
    """Triangular Slaney-normalised mel filterbank [n_banks, n_fft//2+1],
    float32; raises ValueError where a bank would be empty."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = fft_frequencies(sr=sr, n_fft=n_fft)
    mel_f = mel_frequencies(n_banks + 2, fmin=fmin, fmax=fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper)).astype(np.float32)
    if norm == 1:
        enorm = 2.0 / (mel_f[2:n_banks + 2] - mel_f[:n_banks])
        weights *= enorm[:, None].astype(np.float32)
    if not np.all((mel_f[:-2] == 0) | (weights.max(axis=1) > 0)):
        raise ValueError("Empty mel filter channels; raise sr/fmax or lower n_banks.")
    return weights


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

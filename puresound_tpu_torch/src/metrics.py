"""Evaluation metrics (a copy of puresound_tpu/src/metrics.py; numpy / scipy,
no torch: the recipes' `dev` scores host arrays).

Parity target: puresound/src/metrics.py (wraps pesq/pystoi/mir_eval). STOI
and BSS-eval SDR are implemented natively (numpy/scipy) following the
published algorithms, so that none of those packages is needed:

- STOI: Taal et al., "A short-time objective intelligibility measure for
  time-frequency weighted noisy speech", ICASSP 2010 (pystoi-compatible).
- BSS-eval SDR: Vincent et al. 2006, single-source 512-tap projection
  (mir_eval.separation.bss_eval_sources semantics for 1 source).
- PESQ (ITU-T P.862/P.862.2-style): native implementation in
  `pesq_native.py` (calibrated, not bit-conformant — see its docstring).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.linalg import solve_toeplitz
from scipy.signal import resample_poly


# ---------------------------------------------------------------------------
# STOI
# ---------------------------------------------------------------------------

_STOI_FS = 10000
_STOI_NFFT = 512
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NBANDS = 15
_STOI_MINFREQ = 150
_STOI_N = 30  # analysis length (frames)
_STOI_BETA = -15.0
_STOI_DYN_RANGE = 40.0


def _thirdoct(fs, nfft, num_bands, min_freq):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = np.power(2.0, k / 3) * min_freq
    low = cf * 2 ** (-1.0 / 6)
    high = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        l_ii = int(np.argmin(np.square(f - low[i])))
        h_ii = int(np.argmin(np.square(f - high[i])))
        obm[i, l_ii:h_ii] = 1
    return obm


def _stoi_frames(x, frame_len, hop):
    n = 1 + (len(x) - frame_len) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    xf = _stoi_frames(x, frame_len, hop) * w
    yf = _stoi_frames(y, frame_len, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-14)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = frame_len + hop * (len(xf) - 1) if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + frame_len] += xf[i]
        ys[i * hop : i * hop + frame_len] += yf[i]
    return xs, ys


def _stft_mag2(x, frame_len, hop, nfft):
    w = np.hanning(frame_len + 2)[1:-1]
    frames = _stoi_frames(x, frame_len, hop) * w
    spec = np.fft.rfft(frames, n=nfft, axis=1)
    return np.abs(spec) ** 2


def stoi(clean: np.ndarray, denoised: np.ndarray, fs_signal: int = 16000) -> float:
    """Short-time objective intelligibility (classic, not extended)."""
    clean = np.asarray(clean, np.float64).reshape(-1)
    denoised = np.asarray(denoised, np.float64).reshape(-1)
    if fs_signal != _STOI_FS:
        from math import gcd

        g = gcd(fs_signal, _STOI_FS)
        clean = resample_poly(clean, _STOI_FS // g, fs_signal // g)
        denoised = resample_poly(denoised, _STOI_FS // g, fs_signal // g)
    clean, denoised = _remove_silent_frames(
        clean, denoised, _STOI_DYN_RANGE, _STOI_FRAME, _STOI_HOP)
    if len(clean) < _STOI_FRAME:
        raise ValueError("signal too short after silence removal")
    obm = _thirdoct(_STOI_FS, _STOI_NFFT, _STOI_NBANDS, _STOI_MINFREQ)
    X = np.sqrt(obm @ _stft_mag2(clean, _STOI_FRAME, _STOI_HOP, _STOI_NFFT).T)
    Y = np.sqrt(obm @ _stft_mag2(denoised, _STOI_FRAME, _STOI_HOP, _STOI_NFFT).T)
    # [bands, frames]
    M = X.shape[1]
    if M < _STOI_N:
        raise ValueError("too few frames for STOI")
    c = 10 ** (-_STOI_BETA / 20)
    d_sum = 0.0
    count = 0
    for m in range(_STOI_N, M + 1):
        Xs = X[:, m - _STOI_N : m]
        Ys = Y[:, m - _STOI_N : m]
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-14)
        Yp = np.minimum(alpha * Ys, Xs * (1 + c))
        Xn = Xs - Xs.mean(axis=1, keepdims=True)
        Yn = Yp - Yp.mean(axis=1, keepdims=True)
        num = np.sum(Xn * Yn, axis=1)
        den = np.linalg.norm(Xn, axis=1) * np.linalg.norm(Yn, axis=1) + 1e-14
        d_sum += np.sum(num / den)
        count += _STOI_NBANDS
    return float(d_sum / count)


# ---------------------------------------------------------------------------
# BSS-eval SDR (single source, 512-tap projection)
# ---------------------------------------------------------------------------

def bss_eval_sdr(reference: np.ndarray, estimate: np.ndarray,
                 filt_len: int = 512) -> float:
    """SDR with allowed 512-tap distortion filter (bss_eval_sources, 1 src)."""
    s = np.asarray(reference, np.float64).reshape(-1)
    e = np.asarray(estimate, np.float64).reshape(-1)
    L = min(len(s), len(e))
    s, e = s[:L], e[:L]
    n_fft = int(2 ** np.ceil(np.log2(L + filt_len - 1)))
    S = np.fft.rfft(s, n_fft)
    E = np.fft.rfft(e, n_fft)
    # autocorrelation of s and crosscorrelation s,e
    r = np.fft.irfft(S * np.conj(S), n_fft)[:filt_len]
    c = np.fft.irfft(E * np.conj(S), n_fft)[:filt_len]
    r[0] += 1e-10
    h = solve_toeplitz((r, r), c)
    s_target = np.convolve(h, s)[:L]
    dist = e - s_target
    return float(10 * np.log10(np.sum(s_target**2) / (np.sum(dist**2) + 1e-14)))


# ---------------------------------------------------------------------------
# Metrics facade (reference API, src/metrics.py:9)
# ---------------------------------------------------------------------------

def _si_snr_np(est, ref, eps=1e-8):
    est = est - est.mean(-1, keepdims=True)
    ref = ref - ref.mean(-1, keepdims=True)
    proj = (np.sum(est * ref, -1, keepdims=True)
            / (np.sum(ref * ref, -1, keepdims=True) + eps)) * ref
    noise = est - proj
    return 10 * np.log10(np.sum(proj**2, -1) / (np.sum(noise**2, -1) + eps) + eps)


class Metrics:
    @staticmethod
    def check_shape(clean, enhanced):
        clean = np.asarray(clean).squeeze()
        enhanced = np.asarray(enhanced).squeeze()
        if clean.ndim != 1:
            clean = clean[0]
        if enhanced.ndim != 1:
            enhanced = enhanced[0]
        L = min(clean.shape[-1], enhanced.shape[-1])
        clean, enhanced = clean[:L], enhanced[:L]
        # All-zero signals (PVAD inactive targets, fully-suppressed outputs)
        # must not become NaN — skip peak normalization for them.
        c_peak = np.abs(clean).max()
        e_peak = np.abs(enhanced).max()
        clean = clean / c_peak if c_peak > 0 else clean
        enhanced = enhanced / e_peak if e_peak > 0 else enhanced
        return clean, enhanced

    @staticmethod
    def pesq_wb(clean, enhanced):
        """Wideband PESQ MOS-LQO via the native P.862.2-style implementation
        (src/pesq_native.py). Same call contract as the reference's wrapper
        around the `pesq` package (puresound/src/metrics.py:48-51)."""
        from .pesq_native import pesq as _pesq

        clean, enhanced = Metrics.check_shape(clean, enhanced)
        return float(_pesq(16000, clean, enhanced, "wb"))

    @staticmethod
    def pesq_nb(clean, enhanced):
        """Narrowband PESQ MOS-LQO. The reference declares fs=8000 even for
        16 kHz audio (puresound/src/metrics.py:53-57); mirrored here."""
        from .pesq_native import pesq as _pesq

        clean, enhanced = Metrics.check_shape(clean, enhanced)
        return float(_pesq(8000, clean, enhanced, "nb"))

    @staticmethod
    def stoi(clean, enhanced, sr: int = 16000) -> float:
        clean, enhanced = Metrics.check_shape(clean, enhanced)
        return stoi(clean, enhanced, sr)

    @staticmethod
    def bss_sdr(clean, enhanced) -> float:
        clean, enhanced = Metrics.check_shape(clean, enhanced)
        return bss_eval_sdr(clean, enhanced)

    @staticmethod
    def sisnr(clean, enhanced) -> float:
        clean, enhanced = Metrics.check_shape(clean, enhanced)
        # _si_snr_np returns shape [1]; index it (float(arr) with ndim>0
        # errors on numpy >= 2)
        return float(
            _si_snr_np(enhanced.reshape(1, -1), clean.reshape(1, -1))[0])

    @staticmethod
    def sisnr_imp(clean, enhanced, noisy) -> float:
        clean, enhanced = Metrics.check_shape(clean, enhanced)
        clean2, noisy = Metrics.check_shape(clean, noisy)
        L = min(len(clean), len(noisy), len(enhanced))
        diff = (_si_snr_np(enhanced[:L].reshape(1, -1), clean[:L].reshape(1, -1))
                - _si_snr_np(noisy[:L].reshape(1, -1), clean2[:L].reshape(1, -1)))
        return float(np.asarray(diff).reshape(-1)[0])

    @staticmethod
    def f1_score(y_true, y_pred) -> Dict[str, float]:
        y_true, y_pred = Metrics.check_shape(y_true, y_pred)
        y_true = y_true.astype(bool)
        y_pred = y_pred.astype(bool)
        tp = np.sum(y_pred & y_true)
        tn = np.sum(~y_pred & ~y_true)
        fp = np.sum(y_pred & ~y_true)
        fn = np.sum(~y_pred & y_true)
        acc = (tp + tn) / (tp + tn + fp + fn)
        prec = tp / (tp + fp + 1e-7)
        rec = tp / (tp + fn + 1e-7)
        f1 = np.clip(2 * prec * rec / (prec + rec + 1e-7), 1e-7, 1 - 1e-7)
        return {"accuracy": float(acc), "precision": float(prec),
                "recall": float(rec), "f1_score": float(f1)}

    @staticmethod
    def noise_reduction(noisy, enhanced) -> float:
        noisy, enhanced = Metrics.check_shape(noisy, enhanced)
        return float(10 * np.log10(np.sum(enhanced**2) / np.sum(noisy**2)))

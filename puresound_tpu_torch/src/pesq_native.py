"""Native PESQ — an ITU-T P.862-family objective speech-quality metric.

A copy of puresound_tpu/src/pesq_native.py (numpy / scipy, no torch), kept
in the port so that it imports nothing of the JAX package. It stands in for
the `pesq` package that PureSound wraps (puresound/src/metrics.py:48-58).
Implements the published P.862 pipeline end-to-end in numpy:

  1. level alignment to a fixed band-filtered target power,
  2. input filtering (IRS-like receive curve for narrowband; the P.862.2
     wideband IIR pre-filter for wideband),
  3. time alignment (envelope cross-correlation + sample-level refinement),
     utterance-level realignment with recursive delay splitting (delay
     changes mid-stream are charged as alignment, not distortion), and
     bad-interval realignment of residual disturbance spikes,
  4. perceptual model: 32 ms Hann frames -> Bark-band pitch power densities
     (Schroeder bark warping), partial frequency compensation of the
     reference, short-term gain compensation of the degraded signal,
     Zwicker-law loudness transform with the P.862 low-band exponent
     modification,
  5. disturbance: deadzone-masked loudness difference, symmetric (L2 over
     bands) and asymmetric (ratio^1.2-weighted, L1 over bands) per frame,
  6. cognitive aggregation: L6 within ~320 ms split-second intervals, L2
     across intervals, frames weighted by reference activity,
  7. raw score 4.5 - 0.1*D - 0.0309*A, mapped to MOS-LQO with the published
     logistic mappings (P.862.1 narrowband, P.862.2 wideband).

Fidelity note: the ITU reference C implementation defines its Bark bands,
absolute-threshold table, and bad-interval realignment via literal tables
and procedures that are not reproduced; here
the band structure and hearing threshold are derived from the published
psychoacoustic formulas (Schroeder bark, Terhardt threshold) and the
internal scale is calibrated on speech+noise anchors (see
tests/test_pesq.py).  Scores are monotone in degradation, scale- and
delay-invariant, and land in the published ranges, but are NOT bit-exact
P.862 conformance values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy.signal import lfilter


# ---------------------------------------------------------------------------
# Mode configuration (P.862: 8 kHz narrowband / P.862.2: 16 kHz wideband)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Mode:
    fs: int
    n_fft: int          # 32 ms frame
    n_bands: int        # Bark bands (42 nb / 49 wb, as in P.862)
    sp: float           # power density scale (P.862 Sp_8k / Sp_16k)
    sl: float           # loudness scale (P.862 Sl)
    wideband: bool


_NB = _Mode(fs=8000, n_fft=256, n_bands=42, sp=2.764344e-5, sl=1.866055e-1,
            wideband=False)
_WB = _Mode(fs=16000, n_fft=512, n_bands=49, sp=6.910853e-6, sl=1.866055e-1,
            wideband=True)

# Calibrated internal constants (see module docstring): the hearing-threshold
# offset places the Terhardt curve on the internal power scale; the raw score
# keeps the published P.862 form  4.5 - 0.1*D' - 0.0309*A'  where each
# channel is a calibrated power law with a model-noise floor:
# D' = k_d*max(D-d0,0)^p_d, A' = k_a*max(A-a0,0)^p_a (the floors absorb
# the small constant disturbance the formula-derived band structure
# produces even for near-transparent pairs).
# Round-5 recalibration (scripts/calibrate_pesq.py) jointly fits SEVEN
# degradation families — white noise at SNR 0..50 dB, MNRU Q 15..35,
# band-limitation (butterworth lowpass), periodic muting, reverberation
# (exponential-decay RIR at realistic DRR for T60 0.3/0.6/1.0), mu-law
# companding (MNRU-equivalent multiplicative noise, Q~38 for 8-bit), and
# linear bit-crush. Round-5 model changes feeding this fit: P.862's
# additive floor constants applied on the correct (scaled-density) scale,
# temporal post-masking (_POSTMASK_*), and a per-mode compensation depth
# floor (_COMP_FLOOR). RMS residual vs the literature-informed targets:
# 0.119 (wb) / 0.072 (nb). The wb residue is anchor-target scatter, not
# mapping stiffness: the wb targets demand a NON-monotone local exponent
# sequence over the D channel (0.59 / 0.15 / 0.5 between adjacent noise/
# codec anchors), so ~0.12 bounds any smooth 2-channel mapping there.
# tests/test_pesq.py asserts the per-family grids as a regression freeze.
_TQ_OFFSET_DB = 55.0
_D_WEIGHT = 0.1
_A_WEIGHT = 0.0309
_CAL = {  # mode -> (k_d, p_d, k_a, p_a, d0, a0)
    "wb": (26.5721, 0.2837, 7.3372, 0.5617, 0.0023, 2.4295),
    "nb": (19.3538, 0.3334, 10.2889, 0.3277, 0.0250, 3.1057),
}
_TARGET_POWER = 1e7
_SPLIT_SECOND_FRAMES = 20  # ~320 ms at 16 ms hop

# Temporal post-masking (round-5): energy arriving shortly after a loud
# reference frame sits in its post-masking shadow (forward masking decays
# over ~100-200 ms) — the mechanism that makes early reverberation much
# milder perceptually than its energy suggests. P.862 models only
# simultaneous masking (the 0.25*min deadzone); without a forward term the
# reverb family is over-penalized by ~0.4 MOS relative to the noise/MNRU
# families (round-4 residuals). The deadzone gains a per-band floor of
# _POSTMASK_K times the decayed running max of STRICTLY PREVIOUS reference
# loudness (decay _POSTMASK_RHO per 16 ms hop). Stationary noise is charged
# as before (pauses have no recent masker); distortion simultaneous with
# speech is already inside the 0.25*min deadzone.
# Per-mode strengths (round-5 grid search, scripts/exp_pesq_postmask.py /
# exp_pesq_dump_ds.py): the wideband pipeline needs the full forward-
# masking term to fit the reverb family; the narrowband pipeline (IRS
# receive filter + 42 coarser bands) already absorbs most of the tail
# loudness, and any residual k made its reverb anchors OVER-lenient.
# Scalars are accepted too (the calibration sweeps set them directly).
_POSTMASK_RHO = 0.7
_POSTMASK_K = {"wb": 0.5, "nb": 0.0}

# Partial-compensation depth floor (P.862 clips the ref->deg equalization
# ratio at 0.01): a killed band's equalized reference keeps floor*ref, so
# the floor sets how much a deeply band-limited signal can still be
# charged. The nb mode needs a deeper charge (0.04) to order its lowpass
# family correctly — its IRS-bandlimited reference leaves band kills
# otherwise nearly free.
_COMP_FLOOR = {"wb": 0.01, "nb": 0.04}


def _knob(v, mode: "_Mode"):
    """Resolve a per-mode knob: dict keyed wb/nb, or a plain scalar."""
    if isinstance(v, dict):
        return v["wb" if mode.wideband else "nb"]
    return v

# Utterance-level alignment + bad-interval realignment (P.862's utterance
# splitting and bad-frame handling): the delay is re-estimated per speech
# utterance (delay may CHANGE mid-stream — VoIP jitter, warping — and must
# be charged as alignment, not distortion), and residual runs of frames
# whose symmetric disturbance spikes far above the utterance's typical
# level are re-aligned once more with a per-interval delay search; the
# realigned disturbances replace the originals only when the INTERVAL's
# total disturbance drops (interval-level accept — see the inline note in
# _perceptual_model). The bad-frame threshold is RELATIVE
# (x median over active frames) because the internal disturbance scale is
# calibrated, not the C reference's absolute scale.
_BAD_FRAME_REL = 4.0
_BAD_FRAME_MIN = 0.25  # floor on the internal (calibrated) scale
_MIN_BAD_FRAMES = 5
_BAD_SEARCH_MS = 57.0  # +- delay search window per interval/utterance
_UTT_MIN_MS = 300.0    # minimum utterance length
_UTT_GAP_MS = 200.0    # silence gap that splits utterances


# ---------------------------------------------------------------------------
# Input filtering
# ---------------------------------------------------------------------------

# IRS-like receive characteristic (Hz, dB) applied in narrowband mode
# (piecewise-linear magnitude curve applied over the full-signal rFFT, as
# P.862's apply_filter does).
_IRS_DB = np.array([
    (0, -200.0), (50, -40.0), (100, -20.0), (125, -12.0), (160, -6.0),
    (200, 0.0), (250, 4.0), (300, 6.0), (350, 8.0), (400, 10.0),
    (500, 11.0), (600, 12.0), (700, 12.0), (800, 12.0), (1000, 12.0),
    (1300, 12.0), (1600, 12.0), (2000, 12.0), (2500, 12.0), (3000, 12.0),
    (3250, 12.0), (3500, 4.0), (4000, -200.0), (5000, -200.0),
    (6300, -200.0), (8000, -200.0)], dtype=np.float64)

# P.862.2 wideband input IIR pre-filter (single biquad).
_WB_IIR_B = np.array([2.6657628, -5.3315255, 2.6657628])
_WB_IIR_A = np.array([1.0, -1.8890331, 0.89487434])


def _apply_db_curve(x: np.ndarray, fs: int, pts: np.ndarray) -> np.ndarray:
    """Filter by a piecewise-linear (Hz, dB) magnitude curve via rFFT."""
    n = len(x)
    X = np.fft.rfft(x)
    freq = np.fft.rfftfreq(n, 1.0 / fs)
    gain_db = np.interp(freq, pts[:, 0], pts[:, 1], left=pts[0, 1], right=pts[-1, 1])
    X *= 10.0 ** (gain_db / 20.0)
    return np.fft.irfft(X, n)


def _bandpass_power(x: np.ndarray, fs: int, lo: float = 350.0,
                    hi: float = 3250.0) -> float:
    """Average power of the lo..hi Hz band (used for level alignment)."""
    X = np.fft.rfft(x)
    freq = np.fft.rfftfreq(len(x), 1.0 / fs)
    band = (freq >= lo) & (freq <= hi)
    # Parseval: mean power of the band-limited signal
    scale = 2.0 / (len(x) ** 2)
    return float(np.sum(np.abs(X[band]) ** 2) * scale)


def _fix_power_level(x: np.ndarray, fs: int) -> np.ndarray:
    p = _bandpass_power(x, fs)
    if p <= 0:
        return x
    return x * np.sqrt(_TARGET_POWER / p)


# ---------------------------------------------------------------------------
# Time alignment
# ---------------------------------------------------------------------------

def _estimate_delay(ref: np.ndarray, deg: np.ndarray, fs: int) -> int:
    """Delay of `deg` relative to `ref` in samples (positive: deg lags).

    Crude stage: cross-correlation of 4 ms energy envelopes; fine stage:
    sample-level cross-correlation in a +-1 envelope-step window.
    """
    step = fs // 250  # 4 ms
    n = min(len(ref), len(deg)) // step * step
    if n == 0:
        return 0
    er = np.sqrt(np.mean(ref[:n].reshape(-1, step) ** 2, axis=1))
    ed = np.sqrt(np.mean(deg[:n].reshape(-1, step) ** 2, axis=1))
    er = er - er.mean()
    ed = ed - ed.mean()
    m = len(er)
    nfft = int(2 ** np.ceil(np.log2(2 * m)))
    corr = np.fft.irfft(np.fft.rfft(ed, nfft) * np.conj(np.fft.rfft(er, nfft)), nfft)
    k = np.arange(nfft)
    lags = np.where(k < nfft // 2, k, k - nfft)  # circular-corr lag per index
    # restrict to |lag| < m/2 envelope steps
    valid = np.abs(lags) < max(m // 2, 1)
    idx = np.argmax(np.where(valid, corr, -np.inf))
    crude = int(lags[idx]) * step

    # fine: sample-level correlation around the crude estimate
    span = step * 2
    best_d, best_v = crude, -np.inf
    L = min(len(ref), len(deg))
    for d in range(crude - span, crude + span + 1):
        if d >= 0:
            a, b = ref[: L - d], deg[d:L]
        else:
            a, b = ref[-d:L], deg[: L + d]
        if len(a) < fs // 10:
            continue
        v = float(np.dot(a, b))
        if v > best_v:
            best_v, best_d = v, d
    return best_d


def _align(ref: np.ndarray, deg: np.ndarray, fs: int) -> Tuple[np.ndarray, np.ndarray]:
    d = _estimate_delay(ref, deg, fs)
    if d > 0:
        ref, deg = ref[:-d] if d < len(ref) else ref[:0], deg[d:]
    elif d < 0:
        ref, deg = ref[-d:], deg[:d]
    L = min(len(ref), len(deg))
    return ref[:L], deg[:L]


def _utterances(ref: np.ndarray, fs: int):
    """Speech utterance spans [(a0, a1), ...] from the reference's 4 ms
    energy envelope (threshold 30 dB below peak; gaps under _UTT_GAP_MS
    merge; spans under _UTT_MIN_MS drop)."""
    step = fs // 250
    n = len(ref) // step * step
    if n == 0:
        return []
    env = np.sqrt(np.mean(ref[:n].reshape(-1, step) ** 2, axis=1))
    thr = env.max() * 10 ** (-30 / 20)
    act = env > thr
    # merge short silence gaps
    gap = int(_UTT_GAP_MS / 4)
    spans = []
    i = 0
    while i < len(act):
        if not act[i]:
            i += 1
            continue
        j = i
        while j < len(act):
            if act[j]:
                j += 1
            else:
                k = j
                while k < len(act) and not act[k] and k - j < gap:
                    k += 1
                if k < len(act) and act[k] and k - j < gap:
                    j = k
                else:
                    break
        spans.append((i * step, min(j * step, len(ref))))
        i = j
    min_len = int(fs * _UTT_MIN_MS / 1000.0)
    return [(a, b) for a, b in spans if b - a >= min_len]


def _span_delay(ref: np.ndarray, deg: np.ndarray, a0: int, a1: int,
                fs: int) -> Tuple[int, float]:
    """Best delay of deg vs ref over span [a0, a1) searched in a
    +-_BAD_SEARCH_MS window, and the normalized correlation there."""
    span = int(fs * _BAD_SEARCH_MS / 1000.0)
    ref_seg = ref[a0:a1]
    e_ref = float(np.sum(ref_seg ** 2))
    if e_ref <= 0.0:
        return 0, 0.0
    # zero-padded search segment so the full +-span lag range is available
    # even at the signal edges (a 'valid' correlate over the raw slice
    # cannot see positive lags when the span touches the end)
    w0, w1 = a0 - span, a1 + span
    seg = np.zeros(w1 - w0)
    src = deg[max(0, w0):min(len(deg), w1)]
    seg[max(0, -w0):max(0, -w0) + len(src)] = src
    corr = np.correlate(seg, ref_seg, mode="valid")
    k = int(np.argmax(corr))
    e_deg = float(np.sum(seg[k:k + len(ref_seg)] ** 2))
    c = float(corr[k]) / (np.sqrt(e_ref * e_deg) + 1e-12)
    return k - span, c


def _paste_shifted(ref_len_span, deg, a0, a1, d, out):
    lo, hi = a0 + d, a1 + d
    shifted = np.zeros(a1 - a0)
    src = deg[max(0, lo):min(len(deg), hi)]
    shifted[max(0, -lo):max(0, -lo) + len(src)] = src
    out[a0:a1] = shifted


def _align_span_rec(ref, deg, a0, a1, out, fs, depth=0):
    """P.862-style utterance splitting on DELAY CHANGE: if the two halves
    of a span each align clearly better under their own delays than the
    whole span does under one delay, split recursively — delay jumps
    INSIDE continuous speech (jitter, warping) then cost nothing. Spans
    whose halves don't beat the single-delay fit stay whole, so uniform
    degradations (noise, muting, filtering) can't cheat the check."""
    d, c = _span_delay(ref, deg, a0, a1, fs)
    min_len = int(fs * _UTT_MIN_MS / 1000.0)
    if depth < 6 and (a1 - a0) >= 2 * min_len:
        mid = (a0 + a1) // 2
        d1, c1 = _span_delay(ref, deg, a0, mid, fs)
        d2, c2 = _span_delay(ref, deg, mid, a1, fs)
        if d1 != d2 and min(c1, c2) > c + 0.05:
            _align_span_rec(ref, deg, a0, mid, out, fs, depth + 1)
            _align_span_rec(ref, deg, mid, a1, out, fs, depth + 1)
            return
    if d != 0:
        _paste_shifted(a1 - a0, deg, a0, a1, d, out)


def _utterance_align(ref: np.ndarray, deg: np.ndarray, fs: int) -> np.ndarray:
    """Re-align `deg` per reference utterance (P.862 utterance splitting):
    each energy-detected utterance is aligned with a recursive delay
    search that splits wherever the delay changes mid-utterance."""
    out = deg.copy()
    for a0, a1 in _utterances(ref, fs):
        _align_span_rec(ref, deg, a0, a1, out, fs)
    return out


# ---------------------------------------------------------------------------
# Perceptual model
# ---------------------------------------------------------------------------

def _bark(f):
    return 7.0 * np.arcsinh(np.asarray(f, np.float64) / 650.0)


def _band_structure(mode: _Mode):
    """Group rFFT bins (excluding DC) into n_bands ~uniform-Bark bands.

    Returns (band_index per bin [n_bins], centre_bark [n_bands],
    width_bark [n_bands], centre_hz [n_bands]).
    """
    n_bins = mode.n_fft // 2  # bins 1..n_fft/2 (skip DC, keep Nyquist-1)
    freq = (np.arange(1, n_bins + 1)) * mode.fs / mode.n_fft
    edges = np.linspace(0.0, float(_bark(mode.fs / 2)), mode.n_bands + 1)
    idx = np.clip(np.searchsorted(edges, _bark(freq), side="right") - 1,
                  0, mode.n_bands - 1)
    # guarantee non-empty bands (merge forward if a band got no bins)
    counts = np.bincount(idx, minlength=mode.n_bands)
    assert (counts > 0).all(), "empty bark band — band construction bug"
    centre_bark = np.empty(mode.n_bands)
    centre_hz = np.empty(mode.n_bands)
    for b in range(mode.n_bands):
        sel = idx == b
        centre_bark[b] = _bark(freq[sel]).mean()
        centre_hz[b] = freq[sel].mean()
    width_bark = edges[1:] - edges[:-1]
    return idx, centre_bark, width_bark, centre_hz


def _abs_threshold(mode: _Mode, centre_hz: np.ndarray) -> np.ndarray:
    """Absolute hearing threshold per band on the internal power scale
    (Terhardt curve, offset calibrated — see module docstring)."""
    f = np.maximum(centre_hz, 20.0) / 1000.0
    tq_db = (3.64 * f ** -0.8
             - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
             + 1e-3 * f ** 4)
    tq_db = np.minimum(tq_db, 100.0)
    return 10.0 ** ((tq_db + _TQ_OFFSET_DB) / 10.0) * mode.sp


def _frames(x: np.ndarray, n_fft: int) -> np.ndarray:
    hop = n_fft // 2
    n = 1 + max(0, (len(x) - n_fft)) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return x[idx]


def _pitch_power_densities(x: np.ndarray, mode: _Mode, band_idx: np.ndarray):
    """[frames, n_bands] Bark power densities + per-frame total hz power."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(mode.n_fft) / mode.n_fft))
    fr = _frames(x, mode.n_fft) * w
    spec = np.fft.rfft(fr, axis=1)
    hz_pow = (np.abs(spec[:, 1 : mode.n_fft // 2 + 1]) ** 2)  # skip DC
    total = hz_pow.sum(axis=1)
    n_bands = band_idx.max() + 1
    pitch = np.zeros((fr.shape[0], n_bands))
    np.add.at(pitch.T, band_idx, hz_pow.T)
    return pitch * mode.sp, total


def _loudness(pitch: np.ndarray, thresh: np.ndarray, centre_bark: np.ndarray,
              sl: float) -> np.ndarray:
    """Zwicker loudness with the P.862 low-band exponent modification."""
    h = np.ones_like(centre_bark)
    low = centre_bark < 4.0
    h[low] = 6.0 / (centre_bark[low] + 2.0)
    h = np.minimum(h, 2.0) ** 0.15
    zw = 0.23 * h  # modified Zwicker power per band
    t = thresh[None, :]
    loud = sl * (t / 0.5) ** zw[None, :] * ((0.5 + 0.5 * pitch / t) ** zw[None, :] - 1.0)
    return np.where(pitch > t, loud, 0.0)


def _postmask(loud_ref: np.ndarray) -> np.ndarray:
    """Decayed running max of strictly-previous reference loudness per band
    (forward/post-masking floor; see the _POSTMASK_* note)."""
    mask = np.zeros_like(loud_ref)
    prev = np.zeros(loud_ref.shape[1])
    for t in range(len(loud_ref)):
        mask[t] = _POSTMASK_RHO * prev
        prev = np.maximum(loud_ref[t], _POSTMASK_RHO * prev)
    return mask


def _weighted_lp(d: np.ndarray, w: np.ndarray, p: float) -> np.ndarray:
    """Per-frame width-weighted Lp norm over bands. d: [frames, bands]."""
    return (np.sum(w[None, :] * np.abs(d) ** p, axis=1) / w.sum()) ** (1.0 / p)


def _lpq(frame_d: np.ndarray, frame_w: np.ndarray,
         p_syl: float = 6.0, p_time: float = 2.0) -> float:
    """L6 within split-second intervals, L2 across them, frame-weighted."""
    n = len(frame_d)
    if n == 0:
        return 0.0
    groups = []
    for s in range(0, n, _SPLIT_SECOND_FRAMES):
        d = frame_d[s : s + _SPLIT_SECOND_FRAMES]
        w = frame_w[s : s + _SPLIT_SECOND_FRAMES]
        tw = w.sum()
        if tw <= 0:
            continue
        groups.append((np.sum(w * d ** p_syl) / tw) ** (1.0 / p_syl))
    if not groups:
        return 0.0
    g = np.asarray(groups)
    return float((np.mean(g ** p_time)) ** (1.0 / p_time))


def _perceptual_model(ref: np.ndarray, deg: np.ndarray, mode: _Mode) -> Tuple[float, float]:
    band_idx, centre_bark, width_bark, centre_hz = _band_structure(mode)
    thresh = _abs_threshold(mode, centre_hz)

    pp_ref, tot_ref = _pitch_power_densities(ref, mode, band_idx)
    pp_deg, tot_deg = _pitch_power_densities(deg, mode, band_idx)
    n_frames = min(len(pp_ref), len(pp_deg))
    pp_ref, pp_deg = pp_ref[:n_frames], pp_deg[:n_frames]
    tot_ref, tot_deg = tot_ref[:n_frames], tot_deg[:n_frames]
    if n_frames == 0:
        return 0.0, 0.0

    # speech-active frames of the reference (30 dB below the loudest frame)
    db = 10.0 * np.log10(tot_ref + 1e-20)
    active = db > (db.max() - 30.0)
    if not active.any():
        active = np.ones_like(active)

    # NOTE on constant scales (round-5 conformance fix): the pitch power
    # densities here are on P.862's own internal scale — the same 1e7
    # band-power normalization, the same 50%-overlap Hann frames, and the
    # published Sp_8k/Sp_16k scale factors — so P.862's additive floor
    # constants (+1000 partial-compensation, +5e3 gain-compensation, +50
    # asymmetry, (x+1e5)/1e7 frame weight) apply VERBATIM. Rounds 1-4
    # multiplied them by Sp (~1e-5), which made every floor effectively
    # zero: compensation ratios on quiet bands/frames ran unfloored, so
    # band limitation was over-compensated (under-penalized) and silent
    # frames over-charged.

    # partial frequency compensation: equalize the REF toward the DEG
    # long-term average spectrum (linear filtering of the system under test
    # is only partially penalized)
    avg_ref = pp_ref[active].mean(axis=0)
    avg_deg = pp_deg[active].mean(axis=0)
    band_factor = np.clip((avg_deg + 1000.0) / (avg_ref + 1000.0),
                          _knob(_COMP_FLOOR, mode), 100.0)
    eq_ref = pp_ref * band_factor[None, :]

    # short-term gain compensation: equalize the DEG frame gains toward the
    # equalized reference (smoothed first-order across frames); "audible"
    # power sums bands above 100x the hearing threshold (P.862's
    # total_audible with factor 100)
    aud_ref = np.sum(np.where(eq_ref > 100.0 * thresh[None, :], eq_ref, 0.0),
                     axis=1)
    aud_deg = np.sum(np.where(pp_deg > 100.0 * thresh[None, :], pp_deg, 0.0),
                     axis=1)
    raw_gain = np.clip((aud_ref + 5e3) / (aud_deg + 5e3), 3e-4, 5.0)
    gain = np.empty_like(raw_gain)
    g = 1.0
    for i in range(n_frames):
        g = 0.2 * g + 0.8 * raw_gain[i]
        gain[i] = g
    eq_deg = pp_deg * gain[:, None]

    loud_ref = _loudness(eq_ref, thresh, centre_bark, mode.sl)
    loud_deg = _loudness(eq_deg, thresh, centre_bark, mode.sl)

    # disturbance with the 0.25*min deadzone + forward-masking floor (see
    # _POSTMASK_* note at the top): postmask[t] is the decayed running max
    # of previous-frame reference loudness per band
    postmask = _knob(_POSTMASK_K, mode) * _postmask(loud_ref)
    d = loud_deg - loud_ref
    m = 0.25 * np.minimum(loud_deg, loud_ref) + postmask
    d = np.sign(d) * np.maximum(np.abs(d) - m, 0.0)

    frame_d = _weighted_lp(d, width_bark, 2.0)

    # asymmetric disturbance: additive distortions weigh more
    ratio = ((pp_deg + 50.0) / (eq_ref + 50.0)) ** 1.2
    asym = np.where(ratio < 3.0, 0.0, np.minimum(ratio, 12.0))
    frame_a = np.sum(np.abs(d) * asym * width_bark[None, :], axis=1) / width_bark.sum()

    # frame emphasis: P.862 divides each frame's disturbance by
    # ((audible reference power + 1e5) / 1e7)^0.04 — a mild de-emphasis of
    # loud frames / boost of quiet ones on the scaled-density scale
    aud1_ref = np.sum(np.where(eq_ref > thresh[None, :], eq_ref, 0.0),
                      axis=1)
    h = ((aud1_ref + 1e5) / _TARGET_POWER) ** 0.04
    frame_d = np.minimum(frame_d / h, 45.0)
    frame_a = np.minimum(frame_a / h, 45.0)

    # ---- bad-interval realignment (P.862 bad-frame handling) -------------
    # runs of >= _MIN_BAD_FRAMES frames above the disturbance threshold are
    # re-aligned per interval (delay drift mid-utterance is an alignment
    # problem, not distortion): search the best interval delay by
    # cross-correlation, recompute those frames' disturbances against the
    # SAME frozen equalizations/gains, and accept per INTERVAL (total
    # disturbance must drop — see the decision comment below).
    thr_bad = max(_BAD_FRAME_REL * float(np.median(frame_d[active])),
                  _BAD_FRAME_MIN)
    bad = frame_d > thr_bad
    hop = mode.n_fft // 2
    span = int(mode.fs * _BAD_SEARCH_MS / 1000.0)
    s = 0
    n_realigned = 0
    while s < n_frames and n_realigned < 8:
        if not bad[s]:
            s += 1
            continue
        e = s
        while e < n_frames and bad[e]:
            e += 1
        if e - s < _MIN_BAD_FRAMES:
            s = e
            continue
        n_realigned += 1
        a0, a1 = s * hop, (e - 1) * hop + mode.n_fft
        ref_seg = ref[a0:a1]
        if a1 <= len(ref) and float(np.sum(ref_seg ** 2)) > 0.0:
            b0, b1 = max(0, a0 - span), min(len(deg), a1 + span)
            seg = deg[b0:b1]
            if len(seg) > len(ref_seg):
                corr = np.correlate(seg, ref_seg, mode="valid")
                d_int = (b0 + int(np.argmax(corr))) - a0
                if d_int != 0:
                    lo, hi = a0 + d_int, a1 + d_int
                    shifted = np.zeros(a1 - a0)
                    src = deg[max(0, lo):min(len(deg), hi)]
                    shifted[max(0, -lo):max(0, -lo) + len(src)] = src
                    pp2, _ = _pitch_power_densities(shifted, mode, band_idx)
                    m2 = min(len(pp2), e - s)
                    eq_deg2 = pp2[:m2] * gain[s:s + m2, None]
                    loud2 = _loudness(eq_deg2, thresh, centre_bark, mode.sl)
                    d2 = loud2 - loud_ref[s:s + m2]
                    mm = (0.25 * np.minimum(loud2, loud_ref[s:s + m2])
                          + postmask[s:s + m2])
                    d2 = np.sign(d2) * np.maximum(np.abs(d2) - mm, 0.0)
                    fd2 = _weighted_lp(d2, width_bark, 2.0)
                    ratio2 = ((pp2[:m2] + 50.0)
                              / (eq_ref[s:s + m2] + 50.0)) ** 1.2
                    asym2 = np.where(ratio2 < 3.0, 0.0,
                                     np.minimum(ratio2, 12.0))
                    fa2 = (np.sum(np.abs(d2) * asym2 * width_bark[None, :],
                                  axis=1) / width_bark.sum())
                    fd2 = np.minimum(fd2 / h[s:s + m2], 45.0)
                    fa2 = np.minimum(fa2 / h[s:s + m2], 45.0)
                    # interval-level decision (not per-frame min): accept
                    # the realignment only if the interval's TOTAL
                    # disturbance drops — per-frame minima could cherry-
                    # pick spurious partial matches (e.g. inside muting)
                    before = (frame_d[s:s + m2].sum()
                              + frame_a[s:s + m2].sum())
                    after = fd2.sum() + fa2.sum()
                    if after < before:
                        frame_d[s:s + m2] = fd2
                        frame_a[s:s + m2] = fa2
        s = e

    frame_w = np.where(active, 1.0, 0.3)
    return _lpq(frame_d, frame_w), _lpq(frame_a, frame_w)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def pesq(fs: int, ref: np.ndarray, deg: np.ndarray, mode: str = "wb") -> float:
    """MOS-LQO score, mirroring the `pesq` package call signature.

    fs: declared sample rate (8000 for 'nb', 16000 for 'wb' — same contract
    as the package the reference wraps).
    """
    mode = mode.lower()
    if mode == "wb":
        if fs != 16000:
            raise ValueError("wb mode requires fs=16000")
        cfg = _WB
    elif mode == "nb":
        if fs not in (8000, 16000):
            raise ValueError("nb mode requires fs in (8000, 16000)")
        cfg = _NB if fs == 8000 else _Mode(fs=16000, n_fft=512, n_bands=42,
                                           sp=6.910853e-6, sl=1.866055e-1,
                                           wideband=False)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    if min(len(ref), len(deg)) < cfg.fs // 4:
        raise ValueError("signals too short for PESQ (need >= 0.25 s)")

    ref = _fix_power_level(ref, cfg.fs)
    deg = _fix_power_level(deg, cfg.fs)

    if cfg.wideband:
        ref = lfilter(_WB_IIR_B, _WB_IIR_A, ref)
        deg = lfilter(_WB_IIR_B, _WB_IIR_A, deg)
    else:
        ref = _apply_db_curve(ref, cfg.fs, _IRS_DB)
        deg = _apply_db_curve(deg, cfg.fs, _IRS_DB)

    ref, deg = _align(ref, deg, cfg.fs)
    if min(len(ref), len(deg)) < cfg.fs // 4:
        raise ValueError("signals do not overlap after time alignment")
    deg = _utterance_align(ref, deg, cfg.fs)

    d_symm, d_asym = _perceptual_model(ref, deg, cfg)
    k_d, p_d, k_a, p_a, d0, a0 = _CAL["wb" if cfg.wideband else "nb"]
    de = max(d_symm - d0, 0.0)
    ae = max(d_asym - a0, 0.0)
    raw = (4.5 - _D_WEIGHT * k_d * de ** p_d
           - _A_WEIGHT * k_a * ae ** p_a)
    raw = float(np.clip(raw, -0.5, 4.5))

    if cfg.wideband:
        # P.862.2 output mapping
        return 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    # P.862.1 output mapping
    return 0.999 + 4.0 / (1.0 + np.exp(-1.4945 * raw + 4.6607))

"""Audio I/O for the data pipeline (counterpart of `AudioIO`,
puresound_tpu/src/audio.py:24-145; host numpy / scipy).

WAV and FLAC decode through the C++ library of `csrc/` (`src/native.py`)
where it loads; without it WAV goes through scipy and FLAC through the
pure-Python decoder of `src/flac.py` (JAX's `src/audio.py:20,43`). The
resampler is the library's polyphase kernel (bit-exact with
`scipy.signal.resample_poly` on float32), else scipy's. The augmentation
chain (`AudioAugmentor`) is not ported yet (ROADMAP queue 1 item 2).
"""
from __future__ import annotations

import random
from math import gcd
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from . import native
from .flac import read_flac


class AudioIO:
    @staticmethod
    def audio_info(f_path: str) -> Tuple[int, float, int]:
        wav, sr = AudioIO._read(f_path)
        return sr, round(wav.shape[-1] / sr, 2), wav.shape[0]

    @staticmethod
    def _read(f_path: str) -> Tuple[np.ndarray, int]:
        """float32 [channels, samples] in [-1, 1] and the sample rate."""
        is_flac = f_path.lower().endswith(".flac")
        if native.available():
            try:
                return native.read_flac(f_path) if is_flac else native.read_wav(f_path)
            except (ValueError, RuntimeError):
                pass  # unusual encodings fall through to the Python path
        if is_flac:
            return read_flac(f_path)
        sr, wav = wavfile.read(f_path)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        elif wav.dtype == np.int32:
            wav = wav.astype(np.float32) / 2147483648.0
        elif wav.dtype == np.uint8:
            wav = (wav.astype(np.float32) - 128.0) / 128.0
        else:
            wav = wav.astype(np.float32)
        return (wav[None, :] if wav.ndim == 1 else wav.T), sr

    @staticmethod
    def open(f_path: str, normalized: bool = False,
             target_lvl: Optional[float] = None) -> Tuple[np.ndarray, int]:
        wav, sr = AudioIO._read(f_path)
        if normalized:
            wav = AudioIO.normalize_waveform(wav, amp_type="avg")
        if target_lvl is not None:
            wav = AudioIO.rescale_waveform(wav, target_lvl=target_lvl,
                                           amp_type="avg", scale="dB")
        return wav, sr

    @staticmethod
    def save(wav: np.ndarray, f_path: str, sr: int) -> None:
        wav = np.asarray(wav)
        if wav.ndim == 2:
            wav = wav.T  # [samples, channels]
        wav16 = np.clip(wav * 32768.0, -32768, 32767).astype(np.int16)
        wavfile.write(f_path, sr, wav16)

    @staticmethod
    def normalize_waveform(wav: np.ndarray, amp_type: str = "avg") -> np.ndarray:
        if amp_type not in ("avg", "peak"):
            raise ValueError(amp_type)
        if amp_type == "avg":
            den = np.mean(np.abs(wav), axis=-1, keepdims=True)
        else:
            den = np.max(np.abs(wav), axis=-1, keepdims=True)
        return wav / (den + 1e-14)

    @staticmethod
    def rescale_waveform(wav: np.ndarray, target_lvl: float,
                         amp_type: str = "avg", scale: str = "linear") -> np.ndarray:
        if scale not in ("linear", "dB"):
            raise ValueError(scale)
        wav = AudioIO.normalize_waveform(wav, amp_type)
        if scale == "dB":
            target_lvl = 10 ** (target_lvl / 20)
        return target_lvl * wav

    @staticmethod
    def cut_audio(wav: np.ndarray, sr: int, length_s: float, padding: bool = False):
        audio_len = wav.shape[-1]
        target = int(sr * length_s)
        if audio_len > target:
            offset = random.randint(0, audio_len - target)
            return wav[..., offset:offset + target], offset, offset + target
        if padding:
            pad = np.zeros((*wav.shape[:-1], target - audio_len), wav.dtype)
            return np.concatenate([wav, pad], axis=-1), 0, target
        return wav, 0, audio_len

    @staticmethod
    def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
        if orig_sr == new_sr:
            return wav
        g = gcd(orig_sr, new_sr)
        up, down = new_sr // g, orig_sr // g
        if native.available():
            return native.resample_poly(np.asarray(wav, np.float32), up, down)
        return resample_poly(wav, up, down, axis=-1).astype(np.float32)

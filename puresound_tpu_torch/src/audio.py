"""Audio I/O and the host augmentation chain of the data pipeline
(counterpart of puresound_tpu/src/audio.py: `AudioIO` `:24-145`,
`_resample_poly_f32` `:136`, `AudioAugmentor` `:148-302`; host numpy /
scipy).

WAV and FLAC decode through the C++ library of `csrc/` (`src/native.py`)
where it loads; without it WAV goes through scipy and FLAC through the
pure-Python decoder of `src/flac.py` (JAX's `src/audio.py:20,43`). The
resampler is the library's polyphase kernel (bit-exact with
`scipy.signal.resample_poly` on float32), else scipy's; the biquad the
library's `ps_biquad_f32` (bit-exact with `lfilter` on float32), else
scipy's. `AudioAugmentor` draws from Python's `random` and numpy's global
RNG exactly as JAX's does, so the loader's per-batch seeds give the same
bytes in both packages.
"""
from __future__ import annotations

import random
from math import gcd
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter, resample_poly

from . import native
from .flac import read_flac
from .utils import convolve, fftconvolve, recursive_read_folder


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
    def audio_cut(wav: np.ndarray, sr: int, length_s: float):
        """A random `length_s` window of a [C, L] (or [L]) signal, zero-padded
        at the end when shorter: ([C, sr * length_s], (offset, end))."""
        if wav.ndim == 1:
            wav = wav[None, :]
        wav, offset, end = AudioIO.cut_audio(wav, sr, length_s, padding=True)
        return wav, (offset, end)

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
        return _resample_poly_f32(wav, new_sr // g, orig_sr // g)


def _resample_poly_f32(wav: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase resample, the library's kernel where it loads (bit-exact
    with scipy.signal.resample_poly on float32 input), else scipy's."""
    if native.available():
        return native.resample_poly(np.asarray(wav, np.float32), up, down)
    return resample_poly(wav, up, down, axis=-1).astype(np.float32)


class AudioAugmentor:
    """On-the-fly waveform augmentation: speed / volume perturbation,
    additive corpus noise at a target SNR, RIR reverberation (image / direct
    / early), biquad frequency-response variation, white noise."""

    def __init__(self, sample_rate: int, convolve_mode: str = "fft"):
        if convolve_mode not in ("convolution", "fft"):
            raise ValueError(convolve_mode)
        self.sr = sample_rate
        self.conv_mode = convolve_mode
        self.bg_noise: Dict = {}
        self.fg_noise: Dict = {}
        self.rir: Dict = {}

    # ------------------------------------------------------------ sox-style
    def sox_effect(self, wav: np.ndarray, sr: int = 16000) -> np.ndarray:
        speed = float(np.random.uniform(0.8, 1.2))
        vol = float(np.random.uniform(0.125, 2))
        wav, _ = self.sox_speed_perturbed(wav, speed, sr)
        return self.sox_volumn_perturbed(wav, vol, sr)

    def sox_volumn_perturbed(self, wav: np.ndarray, vol_ratio: float,
                             sr: int = 16000) -> np.ndarray:
        return wav * vol_ratio

    def sox_speed_perturbed(self, wav: np.ndarray, speed: float,
                            sr: int = 16000) -> Tuple[np.ndarray, float]:
        """sox `speed` (tempo and pitch): resampling by 1 / speed, played at
        sr."""
        if speed == 1.0:
            return wav, speed
        up = int(round(1.0 / speed * 10000))
        return _resample_poly_f32(wav, up, 10000), speed

    # ----------------------------------------------------------- bg / noise
    def add_bg_noise(self, wav: np.ndarray, snr_list: List[float]) -> List[np.ndarray]:
        """Mix one random corpus noise at each SNR. The scale is the
        reference's sqrt(||wav|| / (snr * ||noise|| + 1e-8)): L2 norms, not
        powers."""
        wav_power = np.linalg.norm(wav)
        noise_id = random.choice(list(self.bg_noise.keys()))
        noise, sr = AudioIO.open(self.bg_noise[noise_id]["wav_path"])
        if noise.shape[0] != 1:
            noise = noise[0:1]
        if sr != self.sr:
            noise = AudioIO.resample(noise, sr, self.sr)
        L, Ln = wav.shape[-1], noise.shape[-1]
        if L <= Ln:
            s = int(np.random.randint(0, Ln - L)) if Ln > L else 0
            noise = noise[:, s:s + L]
        else:
            noise = np.tile(noise, (1, round(L / Ln) + 1))[:, :L]
        noise_power = np.linalg.norm(noise)
        out = []
        for snr_db in snr_list:
            snr = 10 ** (snr_db / 10)
            scale = np.sqrt(wav_power / (snr * noise_power + 1e-8))
            out.append(wav + scale * noise)
        return out

    def _get_white_noise_with_snr(self, wav: np.ndarray, snr: float) -> np.ndarray:
        rms_s = np.sqrt(np.mean(wav ** 2, axis=-1))
        rms_n = np.sqrt(rms_s ** 2 / (10 ** (snr / 10)))
        return np.random.normal(0, float(rms_n), wav.shape[-1]).astype(
            np.float32).reshape(1, -1)

    # ------------------------------------------------------------------ RIR
    def _apply_impulse(self, wav: np.ndarray, impulse: np.ndarray) -> np.ndarray:
        impulse = impulse / np.linalg.norm(impulse)
        if self.conv_mode == "fft":
            out = fftconvolve(wav, impulse, mode="full")
            delay = int(np.argmax(np.abs(impulse), axis=-1).reshape(-1)[0])
            out = out[..., delay:delay + wav.shape[-1]]
        else:
            out = convolve(wav, impulse[..., ::-1])
        if out.shape[-1] != wav.shape[-1]:
            raise ValueError(f"convolved length {out.shape[-1]} != {wav.shape[-1]}")
        return out.astype(np.float32)

    def apply_rir(self, wav: np.ndarray):
        key = random.choice(list(self.rir.keys()))
        impulse, sr = AudioIO.open(self.rir[key]["wav_path"])
        choose_ch = None
        if impulse.shape[0] != 1:
            choose_ch = random.randint(0, impulse.shape[0] - 1)
            impulse = impulse[choose_ch:choose_ch + 1]
        if sr != self.sr:
            impulse = AudioIO.resample(impulse, sr, self.sr)
        return self._apply_impulse(wav, impulse), key, choose_ch

    def apply_rir_by_key(self, wav: np.ndarray, key: str,
                         choose_ch: Optional[int] = None,
                         rir_mode: str = "image", sr: int = 16000) -> np.ndarray:
        impulse, sr = AudioIO.open(self.rir[key]["wav_path"])
        if impulse.shape[0] != 1:
            if choose_ch is None:
                choose_ch = random.randint(0, impulse.shape[0] - 1)
        else:
            choose_ch = 0
        impulse = impulse[choose_ch:choose_ch + 1]
        if sr != self.sr:
            impulse = AudioIO.resample(impulse, sr, self.sr)
        mode = rir_mode.lower()
        if mode == "direct":
            peak = int(np.argmax(impulse))
            impulse = impulse[:, :peak + int(sr * 0.006)]
        elif mode == "early":
            peak = int(np.argmax(impulse))
            impulse = impulse[:, :peak + int(sr * 0.05)]
        elif mode != "image":
            raise NameError(rir_mode)
        return self._apply_impulse(wav, impulse)

    # --------------------------------------------------------------- biquad
    def add_variaion_response(self, wav: np.ndarray,
                              a_coeffs: Optional[np.ndarray] = None,
                              b_coeffs: Optional[np.ndarray] = None):
        """A random biquad frequency-response variation (or the given one)."""
        if a_coeffs is None and b_coeffs is None:
            r = np.random.uniform(-3 / 8, 3 / 8, 4)
            a_coeffs = np.array([1, r[0], r[1]], np.float32)
            b_coeffs = np.array([1, r[2], r[3]], np.float32)
        if native.available() and len(a_coeffs) == 3 and len(b_coeffs) == 3:
            out = native.biquad(b_coeffs, a_coeffs, np.asarray(wav, np.float32))
        else:
            out = lfilter(b_coeffs, a_coeffs, wav, axis=-1).astype(np.float32)
        return out, a_coeffs, b_coeffs

    # -------------------------------------------------------------- corpora
    def load_bg_noise_from_folder(self, folder: str) -> None:
        self.bg_noise = self._load_wav_folder(folder)

    def load_fg_noise_from_folder(self, folder: str) -> None:
        self.fg_noise = self._load_wav_folder(folder)

    def load_rir_from_folder(self, folder: str) -> None:
        self.rir = self._load_wav_folder(folder)

    def _load_wav_folder(self, folder: str) -> Dict:
        temp = {}
        wav_list: List[str] = []
        recursive_read_folder(folder, ".wav", wav_list)
        for file in wav_list:
            path = file.strip().split(" ")[1]
            uttid = "_".join(path.split("/")[-1].split(".")[0:-1])
            temp[uttid] = {"wav_path": path}
        return temp

"""Batched audio augmentation on the training device (counterpart of
puresound_tpu/src/augment_jax.py).

`DeviceAugmentor` loads the noise and RIR corpora once into padded banks on
the device and applies, per example, inside the train step:

- RIR: the full convolution against a bank row, sliced [delay : delay + L]
  at the impulse's peak as the host chain's `_apply_impulse`; the target is
  warped with the image / direct / early variant of `rir_mode` (anechoic
  leaves it dry), truncated then normalised as `apply_rir_by_key`. The
  convolution runs through `torch.fft.rfft` / `irfft` (JAX's runs through
  `jnp.fft`, outside any Pallas kernel) at JAX's FFT length, the next power
  of two of L + Lr - 1; the slice is the same at any length that holds the
  full convolution;
- noise at a per-example uniform SNR with the reference's scale
  sqrt(||wav|| / (snr * ||noise|| + 1e-8)) (L2 norms, not powers), the
  slice wrapping around the corpus row from a random start;
- volume (one ratio for input, target and `vol_extra`) and the [-1, 1] clip;
- per-example NaN rollback, then `inactive` examples take the augmented
  mixture as their target.

The draws and the arithmetic are apart: `draw(generator, B)` returns the
per-example indices, flags, starts, SNRs and ratios from a
`torch.Generator` on the banks' device, and `apply(noisy, clean, draws)` is
pure. Speed perturbation (it changes the length) and the biquad (a serial
IIR) stay in the host chain.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import multihost
from .audio import AudioIO
from .utils import recursive_read_folder


def _load_folder_rows(folder: str, sr: int, max_len: int):
    """Every wav under `folder` in a zero-padded [N, max_len] float32 matrix
    (longer files truncated), and the true lengths [N]."""
    wav_list = []
    recursive_read_folder(folder, ".wav", wav_list)
    rows, lens = [], []
    for file in sorted(wav_list):
        path = file.strip().split(" ")[1]
        wav, fsr = AudioIO.open(f_path=path)
        if wav.shape[0] != 1:
            wav = wav[0:1]
        if fsr != sr:
            wav = AudioIO.resample(wav, fsr, sr)
        w = wav[0, :max_len].astype(np.float32)
        lens.append(w.shape[0])
        rows.append(np.pad(w, (0, max_len - w.shape[0])))
    if not rows:
        raise ValueError(f"no .wav files under {folder}")
    return np.stack(rows), np.asarray(lens, np.int64)


def _rir_variant(row: np.ndarray, length: int, sr: int, mode: str):
    """An impulse truncated for `mode`, then normalised: (the impulse padded
    to the row's size, its peak delay)."""
    imp = row[:length]
    if mode == "direct":
        imp = imp[:int(np.argmax(imp)) + int(sr * 0.006)]
    elif mode == "early":
        imp = imp[:int(np.argmax(imp)) + int(sr * 0.05)]
    elif mode != "image":
        raise NameError(mode)
    n = np.linalg.norm(imp)
    imp = imp / (n if n > 0 else 1.0)
    out = np.zeros_like(row)
    out[:imp.shape[0]] = imp
    return out, int(np.argmax(np.abs(imp)))


def _rir_banks(rows, lens, sr: int, mode: str):
    imps, delays = zip(*(_rir_variant(r, int(n), sr, mode) for r, n in zip(rows, lens)))
    return np.stack(imps), np.asarray(delays, np.int64)


class DeviceAugmentor:
    """RIR, noise and volume augmentation of whole batches on the banks'
    device. Use through `make_augment_fn` in `make_train_step(augment_fn=)`,
    or `draw` then `apply`."""

    @classmethod
    def from_arrays(cls, sample_rate: int, noise: Optional[np.ndarray] = None,
                    rir: Optional[np.ndarray] = None, **kw) -> "DeviceAugmentor":
        """Banks from noise [N, L] and rir [N, Lr] arrays instead of corpus
        folders (written as 16-bit wavs and read back, as JAX's)."""
        from scipy.io import wavfile

        with tempfile.TemporaryDirectory() as td:
            folders = {}
            for name, rows in (("noise", noise), ("rir", rir)):
                if rows is None:
                    continue
                folders[name] = os.path.join(td, name)
                os.makedirs(folders[name])
                for i, row in enumerate(rows):
                    wavfile.write(os.path.join(folders[name], f"{name[0]}{i}.wav"),
                                  sample_rate,
                                  (np.clip(row, -1, 1) * 32767).astype(np.int16))
            return cls(sample_rate, noise_folder=folders.get("noise"),
                       rir_folder=folders.get("rir"), **kw)

    def __init__(self, sample_rate: int, noise_folder: Optional[str] = None,
                 rir_folder: Optional[str] = None, rir_mode: str = "image",
                 noise_snr_range: Tuple[float, float] = (-5.0, 15.0),
                 vol_range: Optional[Tuple[float, float]] = None,
                 p_noise: float = 0.8, p_rir: float = 0.8,
                 max_noise_seconds: float = 10.0, max_rir_seconds: float = 0.5,
                 device=None):
        self.sr = sample_rate
        self.rir_mode = rir_mode.lower()
        if self.rir_mode not in ("image", "direct", "early", "anechoic"):
            raise NameError(rir_mode)
        self.noise_snr_range = tuple(float(v) for v in noise_snr_range)
        self.vol_range = tuple(float(v) for v in vol_range) if vol_range else None
        self.p_noise, self.p_rir = float(p_noise), float(p_rir)
        self.device = torch.device(device if device is not None else "cpu")
        put = lambda a: torch.from_numpy(a).to(self.device)

        self.noise_bank = self.noise_len = None
        if noise_folder:
            rows, lens = _load_folder_rows(noise_folder, sample_rate,
                                           int(sample_rate * max_noise_seconds))
            self.noise_bank, self.noise_len = put(rows), put(lens)

        self.rir_bank = self.rir_delay = None
        self.rir_bank_target = self.rir_delay_target = None
        if rir_folder:
            rows, lens = _load_folder_rows(rir_folder, sample_rate,
                                           int(sample_rate * max_rir_seconds))
            bank, delay = _rir_banks(rows, lens, sample_rate, "image")
            self.rir_bank, self.rir_delay = put(bank), put(delay)
            if self.rir_mode != "anechoic":
                bank, delay = _rir_banks(rows, lens, sample_rate, self.rir_mode)
                self.rir_bank_target, self.rir_delay_target = put(bank), put(delay)

    # ---------------------------------------------------------------- draws
    def draw(self, generator: torch.Generator, B: int) -> Dict[str, torch.Tensor]:
        """One batch's draws from `generator` (on the banks' device): RIR
        rows and flags, noise rows, starts, SNRs (dB) and flags, volume
        ratios. Only the parts with a bank (or a volume range) are drawn."""
        kw = dict(generator=generator, device=self.device)
        uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(B, dtype=torch.float32, **kw)
        out: Dict[str, torch.Tensor] = {}
        if self.rir_bank is not None:
            out["rir_idx"] = torch.randint(0, self.rir_bank.shape[0], (B,), **kw)
            out["rir_use"] = torch.rand(B, **kw) < self.p_rir
        if self.noise_bank is not None:
            idx = torch.randint(0, self.noise_bank.shape[0], (B,), **kw)
            nlen = self.noise_len[idx]
            out["noise_idx"] = idx
            out["noise_start"] = (torch.rand(B, **kw) * nlen.float()).long()
            out["snr_db"] = uniform(*self.noise_snr_range)
            out["noise_use"] = torch.rand(B, **kw) < self.p_noise
        if self.vol_range is not None:
            out["vol"] = uniform(*self.vol_range)
        return out

    # ------------------------------------------------------------ arithmetic
    @staticmethod
    def _convolve_delayed(wav, imp, delay):
        """The full convolution of wav [B, L] with imp [B, Lr], sliced
        [delay : delay + L] per example."""
        L = wav.shape[-1]
        n = 1 << (L + imp.shape[-1] - 2).bit_length()     # >= L + Lr - 1
        out = torch.fft.irfft(torch.fft.rfft(wav, n) * torch.fft.rfft(imp, n), n)
        idx = delay[:, None] + torch.arange(L, device=wav.device)[None, :]
        return torch.gather(out, -1, idx).to(wav.dtype)

    def _noise(self, draws, L: int, dtype):
        idx = draws["noise_idx"]
        nlen = self.noise_len[idx]
        pos = (draws["noise_start"][:, None]
               + torch.arange(L, device=idx.device)[None, :]) % nlen[:, None]
        return torch.gather(self.noise_bank[idx].to(dtype), -1, pos)

    def apply(self, noisy: torch.Tensor, clean: torch.Tensor, draws: Dict[str, torch.Tensor],
              vol_extra: Optional[Sequence[torch.Tensor]] = None,
              inactive: Optional[torch.Tensor] = None):
        """[B, L] (or [B, 1, L]) input and target -> the augmented pair, and
        the `vol_extra` signals scaled by the same volume ratio when given.
        Pure: every random choice is in `draws`."""
        squeeze = noisy.dim() == 3
        if squeeze:
            noisy, clean = noisy[:, 0], clean[:, 0]
        if clean.dim() != 2:
            raise ValueError(f"targets [B, L] or [B, 1, L], not {tuple(clean.shape)}")
        x, t = noisy, clean
        col = lambda v: v[:, None]
        if self.rir_bank is not None:
            idx, use = draws["rir_idx"], col(draws["rir_use"])
            wet = self._convolve_delayed(x, self.rir_bank[idx].to(x.dtype),
                                         self.rir_delay[idx])
            x = torch.where(use, wet, x)
            if self.rir_mode != "anechoic":
                wet_t = self._convolve_delayed(t, self.rir_bank_target[idx].to(t.dtype),
                                               self.rir_delay_target[idx])
                t = torch.where(use, wet_t, t)
        if self.noise_bank is not None:
            noise = self._noise(draws, x.shape[-1], x.dtype)
            snr = 10.0 ** (draws["snr_db"].to(x.dtype) / 10.0)
            scale = torch.sqrt(torch.linalg.vector_norm(x, dim=-1)
                               / (snr * torch.linalg.vector_norm(noise, dim=-1) + 1e-8))
            x = torch.where(col(draws["noise_use"]), x + col(scale) * noise, x)
        extra = list(vol_extra) if vol_extra else []
        if self.vol_range is not None:
            ratio = draws["vol"].to(x.dtype)
            x = torch.clamp(x * col(ratio), -1.0, 1.0)
            t = torch.clamp(t * col(ratio), -1.0, 1.0)
            extra = [torch.clamp(e * ratio.reshape((-1,) + (1,) * (e.dim() - 1)), -1.0, 1.0)
                     for e in extra]
        bad = col(torch.isnan(x).any(-1) | torch.isnan(t).any(-1))
        x = torch.where(bad, noisy, x)
        t = torch.where(bad, clean, t)
        if inactive is not None:
            t = torch.where(col(inactive.bool()), x, t)
        if squeeze:
            x, t = x[:, None], t[:, None]
        return (x, t, extra) if vol_extra else (x, t)

    def __call__(self, generator: torch.Generator, noisy, clean, vol_extra=None,
                 inactive=None):
        """`apply` on this batch's draws. In a multi-process run the draws
        are those of the global batch (every process's generator seeded
        alike), each process taking its rows', as JAX's replicated key
        draws for the global batch (under tensor parallelism the rows of this
        rank's dp index, which its mp peers share)."""
        B, world = noisy.shape[0], multihost.dp_count()
        draws = self.draw(generator, B * world)
        if world > 1:
            r = multihost.dp_index() * B
            draws = {k: v[r:r + B] for k, v in draws.items()}
        return self.apply(noisy, clean, draws, vol_extra=vol_extra, inactive=inactive)

    def make_augment_fn(self, noisy_key: str = "noisy", target_key: str = "ref_clean",
                        inactive_key: Optional[str] = None,
                        vol_keys: Tuple[str, ...] = ()):
        """(generator, batch kwargs) -> batch kwargs, for `make_train_step`'s
        `augment_fn`. inactive_key names a [B] bool entry (TSE inactive
        targets); vol_keys name extra signals scaled by the volume ratio
        (the TSE enrollment)."""
        def fn(generator, batch):
            out = dict(batch)
            inactive = batch[inactive_key] if inactive_key else None
            keys = [k for k in vol_keys if batch.get(k) is not None]
            res = self(generator, batch[noisy_key], batch[target_key],
                       vol_extra=[batch[k] for k in keys] or None, inactive=inactive)
            out[noisy_key], out[target_key] = res[0], res[1]
            if keys:
                out.update(zip(keys, res[2]))
            return out
        return fn

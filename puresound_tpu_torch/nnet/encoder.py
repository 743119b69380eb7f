"""Waveform front-ends (counterpart of puresound_tpu/nnet/encoder.py).

`FreeEncDec` (`:60`), the learned filterbank of the TSE flagship, the
conv-STFT pair of the NS models: `ConvSTFT` (`:100`) and its wrapper
`ConvEncDec` (`:284`), and the mel front-end `FbankEnc` (`:323`), the
enrollment encoder of `tse_skim_v2_causal`. The analysis is a strided conv with the windowed
sin/cos kernels (parameters when trainable); the synthesis is a matmul
against the fixed inverse-DFT basis, then overlap-add and the window-sum
division. The bases are non-persistent buffers, so the state_dict holds
only what JAX's variables hold.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..dsp.stft import (fourier_kernels, hann_window, inverse_fourier_basis,
                        mel_filterbank, overlap_add, window_sumsquare)
from ..utils.init import generator_or_default, uniform


class _Filterbank(nn.Module):
    """Holds one [laten, 1, win] filterbank as `weight` (PureSound's
    nn.Conv1d / nn.ConvTranspose1d parameter name)."""

    def __init__(self, weight: nn.Parameter):
        super().__init__()
        self.weight = weight


class FreeEncDec(nn.Module):
    """Learned analysis/synthesis filterbank.

    forward: [N, L] -> [N, C, T] (strided conv, optional ReLU);
    inverse: [N, C, T] -> [N, L] (transposed conv).
    """

    def __init__(self, win_length: int = 512, laten_length: int = 512,
                 hop_length: int = 128, output_active: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.win_length, self.laten_length = win_length, laten_length
        self.hop_length, self.output_active = hop_length, output_active
        shape = (laten_length, 1, win_length)
        self.encoder = _Filterbank(uniform(shape, math.sqrt(1.0 / win_length),
                                           g, device, dtype))
        self.decoder = _Filterbank(uniform(
            shape, math.sqrt(1.0 / (laten_length * win_length)), g, device,
            dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = F.conv1d(x[:, None, :], self.encoder.weight.to(x.dtype),
                         stride=self.hop_length)
        return torch.relu(feats) if self.output_active else feats

    def inverse(self, feats: torch.Tensor) -> torch.Tensor:
        wav = F.conv_transpose1d(feats, self.decoder.weight.to(feats.dtype),
                                 stride=self.hop_length)
        return wav[:, 0, :]


class ConvSTFT(nn.Module):
    """Conv-STFT with (optionally trainable) windowed Fourier kernels.

    forward: [N, L] -> [N, F, T, 2], (re, im) with the DFT's sign
    (imag = -sum(x * sin)) for "Complex", or (magnitude, phase) for
    "MagPhase" (`encoder.py:171-193`: the magnitude sqrt(p + 1e-8) when
    trainable); inverse: [N, F, T, 2] -> [N, L], a MagPhase input re-polarised
    first. `wsin` / `wcos` are [F, n_fft] like JAX's.
    """

    def __init__(self, n_fft: int = 2048, win_length: Optional[int] = None,
                 freq_bins: Optional[int] = None,
                 hop_length: Optional[int] = None, freq_scale: str = "no",
                 iSTFT: bool = False, fmin: float = 50.0, fmax: float = 6000.0,
                 sr: int = 22050, trainable: bool = False,
                 output_format: str = "Complex", win_type: str = "hann", *,
                 device=None, dtype=torch.float32):
        super().__init__()
        win = win_length if win_length is not None else n_fft
        if win > n_fft:
            raise ValueError("window length must be <= n_fft")
        if win_type.lower() != "hann":
            raise NotImplementedError(f"window type {win_type}")
        if output_format not in ("Complex", "MagPhase"):
            raise NotImplementedError(output_format)
        self.output_format, self.trainable = output_format, trainable
        self.n_fft, self.freq_bins, self.iSTFT = n_fft, freq_bins, iSTFT
        self.hop = hop_length if hop_length is not None else win // 4
        wsin, wcos, _, _ = fourier_kernels(n_fft, win_length=win,
                                           freq_bins=freq_bins, fmin=fmin,
                                           fmax=fmax, sr=sr, freq_scale=freq_scale)
        window = hann_window(win)
        if win < n_fft:     # centre-padded to n_fft (nnAudio semantics)
            lpad = (n_fft - win) // 2
            window = np.pad(window, (lpad, n_fft - win - lpad))
        self._window_np = window
        fk = dict(device=device, dtype=dtype)
        for name, w in (("wsin", wsin * window[None, :]),
                        ("wcos", wcos * window[None, :])):
            t = torch.from_numpy(w).to(**fk)
            if trainable:
                setattr(self, name, nn.Parameter(t))
            else:
                self.register_buffer(name, t, persistent=False)
        if iSTFT:
            cos_b, sin_b = inverse_fourier_basis(n_fft)
            for name, b in (("_cos_basis", cos_b), ("_sin_basis", sin_b),
                            ("_window", window),
                            ("_stream_basis_full", self._stream_basis(cos_b, sin_b, 0)),
                            ("_stream_basis_drop", self._stream_basis(cos_b, sin_b, 1))):
                self.register_buffer(name, torch.from_numpy(b).to(**fk),
                                     persistent=False)

    @property
    def num_freq_out(self) -> int:
        return self.freq_bins if self.freq_bins is not None else self.n_fft // 2 + 1

    def _stream_basis(self, cos_b, sin_b, lo: int) -> np.ndarray:
        """[C, n_fft] matrix of `stream_synthesis_frames` (JAX `:214-236`):
        the first-bin re-pad, Hermitian extension (mirrored interior bins
        count twice), inverse DFT, window and 1/n_fft, float32."""
        fb, n = self.num_freq_out, self.n_fft
        dbl = np.zeros((fb, n), np.float32)
        dbl[1:fb - 1] = 1.0
        cos_eff = cos_b[:fb] + dbl * cos_b[(n - np.arange(fb)) % n]
        sin_eff = -(sin_b[:fb] - dbl * sin_b[(n - np.arange(fb)) % n])
        basis = np.concatenate([cos_eff[lo:], sin_eff[lo:]], axis=0)
        return basis * self._window_np[None, :] / n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, L] -> [N, F, T, 2]."""
        w = torch.cat([self.wcos, self.wsin], dim=0)[:, None, :].to(x.dtype)
        spec = F.conv1d(x[:, None, :], w, stride=self.hop)     # [N, 2F', T]
        nk, fb = self.wcos.shape[0], self.num_freq_out
        re, im = spec[:, :nk][:, :fb], spec[:, nk:][:, :fb]
        if self.output_format == "Complex":
            return torch.stack([re, -im], dim=-1)
        power = re ** 2 + im ** 2
        mags = torch.sqrt(power + 1e-8) if self.trainable else torch.sqrt(power)
        return torch.stack([mags, torch.atan2(-im, re)], dim=-1)

    # ---------------------------------------------------------- streaming
    def stream_analysis_ri(self, buf: torch.Tensor, K: int,
                           drop_first_bin: bool = True) -> torch.Tensor:
        """buf [N, (K-1)*hop + n_fft] -> RI-stacked features [N, C, K] in one
        product; rows [re bins lo.., im bins lo..] with the DFT's imag sign."""
        lo, fb = (1 if drop_first_bin else 0), self.num_freq_out
        w = torch.cat([self.wcos[lo:fb], -self.wsin[lo:fb]], dim=0).to(buf.dtype)
        frames = buf.unfold(1, self.n_fft, self.hop)[:, :K]    # [N, K, n_fft]
        return torch.einsum("nkt,ct->nck", frames, w)

    def stream_synthesis_frames(self, ri: torch.Tensor,
                                drop_first_bin: bool = True) -> torch.Tensor:
        """RI-stacked spectra [N, C, K] -> windowed frames [N, K, n_fft] in
        one product with the fixed basis (cast to ri's dtype)."""
        basis = self._stream_basis_drop if drop_first_bin else self._stream_basis_full
        return torch.einsum("nck,cs->nks", ri, basis.to(ri.dtype))

    # ------------------------------------------------------------ offline
    def synthesis_frames(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        """Hermitian extension + inverse DFT + window / n_fft, without the
        overlap-add: re/im [N, F, T] -> [N, T, n_fft]."""
        if not self.iSTFT:
            raise ValueError("construct with iSTFT=True to use inverse()")
        re_full = torch.cat([re, re[:, 1:-1].flip(1)], dim=1)
        im_full = torch.cat([im, -im[:, 1:-1].flip(1)], dim=1)
        cos_b, sin_b = self._cos_basis.to(re.dtype), self._sin_basis.to(re.dtype)
        frames = (torch.einsum("nft,fs->nts", re_full, cos_b)
                  - torch.einsum("nft,fs->nts", im_full, sin_b))
        return frames * self._window.to(re.dtype) / self.n_fft

    def _synthesize(self, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        sig = overlap_add(self.synthesis_frames(re, im), self.hop)
        # the normaliser in float32, as JAX builds it from its numpy window
        w_sum = window_sumsquare(self._window.float(), re.shape[2], self.hop,
                                 self.n_fft)
        ok = w_sum > 1e-10
        return torch.where(ok, sig / torch.where(ok, w_sum, 1.0), sig)

    def inverse(self, X: torch.Tensor) -> torch.Tensor:
        """X [N, F, T, 2] -> [N, L]."""
        if X.dim() != 4:
            raise ValueError("inverse expects [N, freq, T, 2] input")
        if self.output_format == "MagPhase":
            mag, phase = X[..., 0], X[..., 1]
            return self._synthesize(mag * torch.cos(phase), mag * torch.sin(phase))
        return self._synthesize(X[..., 0], X[..., 1])


class ConvEncDec(nn.Module):
    """Trainable conv-STFT front-end ([N, L] <-> [N, F, T, 2]); the STFT is
    the `encoder` submodule, as in PureSound."""

    def __init__(self, fft_length: int = 512, win_type: str = "hann",
                 win_length: int = 512, freq_bins: Optional[int] = None,
                 hop_length: int = 128, freq_scale: str = "no",
                 iSTFT: bool = True, fmin: float = 0.0, fmax: float = 8000.0,
                 sr: int = 16000, trainable: bool = True,
                 output_format: str = "Complex", *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.fft_length, self.hop_length = fft_length, hop_length
        self.freq_bins = freq_bins
        self.encoder = ConvSTFT(
            n_fft=fft_length, win_length=win_length, freq_bins=freq_bins,
            hop_length=hop_length, freq_scale=freq_scale, iSTFT=iSTFT,
            fmin=fmin, fmax=fmax, sr=sr, trainable=trainable,
            output_format=output_format, win_type=win_type, device=device,
            dtype=dtype)

    @property
    def num_freq_out(self) -> int:
        return self.freq_bins if self.freq_bins is not None else self.fft_length // 2 + 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def inverse(self, X: torch.Tensor) -> torch.Tensor:
        return self.encoder.inverse(X)


class FbankEnc(nn.Module):
    """Conv mel-spectrogram front-end (JAX `encoder.py:323-391`).

    forward "Magnitude": [N, L] -> mel power [N, n_banks, T] (the power
    + 1e-8 when trainable); "MagPhase": (mel magnitude [N, n_banks, T],
    phase [N, F, T]) (the magnitude sqrt(p + 1e-8) when trainable).
    `inverse(mel, phase)` (MagPhase, iSTFT=True): the pseudo-inverse mel
    map, then `ConvSTFT._synthesize`. The STFT is the `stft` submodule;
    `filterbank` [F, n_banks] / `inv_filterbank` [n_banks, F] are
    parameters when trainable, else non-persistent buffers (JAX holds no
    variables for them then).
    """

    def __init__(self, fft_length: int = 512, win_type: str = "hann",
                 win_length: int = 512, freq_bins: Optional[int] = None,
                 hop_length: int = 128, freq_scale: str = "no", fmin: float = 0.0,
                 fmax: float = 8000.0, sr: int = 16000, trainable: bool = False,
                 output_format: str = "Magnitude", n_banks: int = 80,
                 iSTFT: bool = False, *, device=None, dtype=torch.float32):
        super().__init__()
        if output_format.lower() not in ("magnitude", "magphase"):
            raise NotImplementedError(output_format)
        self.output_format, self.trainable = output_format.lower(), trainable
        self.fft_length, self.hop_length, self.n_banks = fft_length, hop_length, n_banks
        self.stft = ConvSTFT(n_fft=fft_length, win_length=win_length, freq_bins=freq_bins,
                             hop_length=hop_length, freq_scale=freq_scale, iSTFT=iSTFT,
                             fmin=fmin, fmax=fmax, sr=sr, trainable=trainable,
                             output_format="Complex", win_type=win_type, device=device,
                             dtype=dtype)
        # JAX honours sr here where PureSound hardcodes 16 kHz (`:362-365`)
        mel_fb_t = mel_filterbank(sr=sr, n_fft=fft_length, n_banks=n_banks).T
        inv_mel = np.linalg.pinv(mel_fb_t).astype(np.float32)
        for name, a in (("filterbank", mel_fb_t), ("inv_filterbank", inv_mel)):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
            if trainable:
                setattr(self, name, nn.Parameter(t))
            else:
                self.register_buffer(name, t, persistent=False)

    def forward(self, x: torch.Tensor):
        X = self.stft(x)                                    # [N, F, T, 2]
        re, im = X[..., 0], X[..., 1]
        power = re ** 2 + im ** 2
        fb = self.filterbank.to(x.dtype)
        if self.output_format == "magphase":
            mag = torch.sqrt(power + 1e-8) if self.trainable else torch.sqrt(power)
            return torch.einsum("nft,fm->nmt", mag, fb), torch.atan2(im, re)
        mag = power + 1e-8 if self.trainable else power
        return torch.einsum("nft,fm->nmt", mag, fb)

    def inverse(self, melspec: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        if self.output_format != "magphase":
            raise NotImplementedError("inverse only supports MagPhase format")
        spec = torch.einsum("nmt,mf->nft", melspec, self.inv_filterbank.to(melspec.dtype))
        return self.stft._synthesize(spec * torch.cos(phase), spec * torch.sin(phase))

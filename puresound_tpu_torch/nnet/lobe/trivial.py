"""LambdaLayer, Magnitude, Gate and FiLM conditioning, the 50 %-overlap segment
split / merge, the moving average, spectral compression and SpecAugment
(counterpart of puresound_tpu/nnet/lobe/trivial.py:19, :26, :50, :88, :130,
:166, :188, :196)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...parallel import remat
from ...utils.init import generator_or_default
from .activation import PReLU
from .cnn import Conv1d
from .dropout import Dropout
from .norm import ChanLN, LayerNormLast


class LambdaLayer(nn.Module):
    """A module around a callable: forward(x, **kwargs) = fn(x, **kwargs)."""

    def __init__(self, fn=None):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kwargs):
        return self.fn(x, **kwargs)


class Magnitude(nn.Module):
    """Complex [N, C, T, 2] or RI-concat [N, 2C, T] -> magnitude [N, C, T],
    sqrt(re^2 + im^2 + 1e-8), the first bin dropped with `drop_first`,
    log1p-compressed with `log1p` (JAX `trivial.py:26-47`)."""

    def __init__(self, drop_first: bool = True, log1p: bool = False):
        super().__init__()
        self.drop_first, self.log1p = drop_first, log1p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            re, im = x[..., 0], x[..., 1]
        elif x.dim() == 3:
            re, im = torch.chunk(x, 2, dim=1)
        else:
            raise TypeError("Magnitude expects 3-D or 4-D input")
        if self.drop_first:
            re, im = re[:, 1:, :], im[:, 1:, :]
        mag = torch.sqrt(re ** 2 + im ** 2 + 1e-8)
        return torch.log1p(mag) if self.log1p else mag


class Gate(nn.Module):
    """Gated conditioning block: x + out_conv(left * sigmoid(right)), with
    left = PReLU(cLN(left_conv(in_conv(x)))) and right the same over
    [in_conv(x); cond]. x: [N, C, T], condition: [N, E].

    PureSound's layout (`left_conv` / `right_conv` are Sequential(conv, cLN,
    PReLU)). Dropout after each PReLU (JAX's `drop`) runs in training mode
    only: `Dropout` draws each mask's seed from the module's own
    `torch.Generator`, never the global RNG, and the mask on the input's
    device.
    """

    def __init__(self, input_size: int, hidden_size: int, embed_size: int,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size, self.generator = hidden_size, g
        self.in_conv = Conv1d(input_size, hidden_size, 1, bias=False,
                              generator=g, **fk)
        self.left_conv = nn.Sequential(
            Conv1d(hidden_size, hidden_size, 1, bias=False, generator=g, **fk),
            ChanLN(hidden_size, **fk), PReLU(**fk))
        self.right_conv = nn.Sequential(
            Conv1d(hidden_size + embed_size, hidden_size, 1, bias=False,
                   generator=g, **fk),
            ChanLN(hidden_size, **fk), PReLU(**fk))
        self.out_conv = Conv1d(hidden_size, input_size, 1, bias=False,
                               generator=g, **fk)
        self.drop = Dropout(dropout, generator=g)

    def forward(self, x: torch.Tensor, condition: torch.Tensor) -> torch.Tensor:
        u = self.in_conv(x)
        cond = condition[:, :, None].expand(*condition.shape, u.shape[-1])
        left = self.drop(self.left_conv(u))
        right = torch.sigmoid(self.drop(
            self.right_conv(torch.cat([u, cond.to(u.dtype)], dim=1))))
        return self.out_conv(left * right) + x


class FiLM(nn.Module):
    """Feature-wise linear modulation from [x; cond]: scale * x + bias.

    x: [N, C, T] (or feature-last, see forward), condition: [N, E].
    """

    def __init__(self, feats_size: int, embed_size: int,
                 input_norm: bool = True, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.feats_size, self.embed_size = feats_size, embed_size
        self.input_norm = input_norm
        self.cond_scale = Conv1d(feats_size + embed_size, feats_size, 1,
                                 bias=False, generator=g, **fk)
        self.cond_bias = Conv1d(feats_size + embed_size, feats_size, 1,
                                bias=False, generator=g, **fk)
        if input_norm:
            self.norm = LayerNormLast(feats_size, **fk)

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                feature_last: bool = False) -> torch.Tensor:
        """feature_last=True takes/returns x as [N, T, C] and applies the
        1x1 convs as feature-last matmuls (same math)."""
        if feature_last:
            xn = self.norm(x) if self.input_norm else x
            cond = condition[:, None, :].expand(x.shape[0], x.shape[1],
                                                condition.shape[-1])
            cat = torch.cat([xn, cond.to(xn.dtype)], dim=-1)
            return (self.cond_scale.dense_last(cat) * xn
                    + self.cond_bias.dense_last(cat))
        if self.input_norm:
            x = self.norm(x.transpose(1, 2)).transpose(1, 2)
        cond = condition[:, :, None].expand(*condition.shape, x.shape[-1])
        cat = torch.cat([x, cond.to(x.dtype)], dim=1)
        return self.cond_scale(cat) * x + self.cond_bias(cat)


def spectral_compression(x: torch.Tensor, alpha: float = 0.3,
                         dim: int = 1) -> torch.Tensor:
    """mag^alpha * e^{i angle(phase)} on RI-concat input, complex out. As in
    JAX (and the reference), the angle is taken of the real phase, so the
    factor is +1 or -1."""
    re, im = torch.chunk(x, 2, dim=dim)
    mag = torch.sqrt(re ** 2 + im ** 2 + 1e-8) ** alpha
    phase = torch.atan2(im, re)
    return mag * torch.exp(1j * torch.angle(phase))


class SplitMerge:
    """50 %-overlap segment split / merge of the dual-path models (JAX
    `trivial.py:130-163`); no parameters."""

    @staticmethod
    def split(x: torch.Tensor, seg_size: int) -> Tuple[torch.Tensor, int]:
        """x [N, C, T] -> (segments [N, S, K, C], rest)."""
        stride = seg_size // 2
        N, C, T = x.shape
        rest = seg_size - (stride + T % seg_size) % seg_size
        x = nn.functional.pad(x, (stride, rest + stride))
        seg1 = x[:, :, :-stride].reshape(N, C, -1, seg_size)
        seg2 = x[:, :, stride:].reshape(N, C, -1, seg_size)
        segments = torch.cat([seg1, seg2], dim=-1).reshape(N, C, -1, seg_size)
        return segments.permute(0, 2, 3, 1), rest

    @staticmethod
    def merge(x: torch.Tensor, rest: int) -> torch.Tensor:
        """x [N, S, K, C] -> [N, C, T]: the two half-shifted sequences
        averaged, the split's padding cut."""
        N, S, K, C = x.shape
        stride = K // 2
        x = x.permute(0, 3, 1, 2).reshape(N, C, -1, K * 2)
        x1 = x[..., :K].reshape(N, C, -1)[:, :, stride:]
        x2 = x[..., K:].reshape(N, C, -1)[:, :, :-stride]
        out = (x1 + x2) / 2
        return out[..., :-rest] if rest > 0 else out


class MovingAverage1D(nn.Module):
    """Moving average of `kernel_size` samples at `stride` over [N, T]
    (JAX `trivial.py:166-185`); `add_padding` pads kernel_size - 1 samples
    on the left (`causal`) or kernel_size // 2 on both sides first."""

    def __init__(self, kernel_size: int, stride: int, add_padding: bool = False,
                 causal: bool = True):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride
        self.add_padding, self.causal = add_padding, causal

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if self.add_padding:
            x = nn.functional.pad(x, (k - 1, 0) if self.causal else (k // 2, k // 2))
        w = torch.full((1, 1, k), 1.0 / k, dtype=x.dtype, device=x.device)
        return nn.functional.conv1d(x[:, None, :], w, stride=self.stride)[:, 0, :]


class SpecAugment(nn.Module):
    """One frequency and one time mask on [N, C, T], shared by the batch
    (JAX `trivial.py:196-229`): a width drawn uniformly in [0, mask_length)
    and a uniform start, as torchaudio's `mask_along_axis`; the identity
    when not training or for an axis of length 0. The draws and the mask are
    apart: `draw(generator)` gives the two uniforms of each axis ([2, 2]:
    frequency, time) on the generator's device, and `apply(x, draws)`
    computes JAX's `_mask_axis` from them. In training the forward draws a
    seed from the model's generator (`remat.dropout_seed`, replayed when a
    checkpointed forward is recomputed) and the uniforms from it on the
    input's device."""

    def __init__(self, freq_mask_length: int, time_mask_length: int,
                 fill_value: float = 0.0, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.freq_mask_length, self.time_mask_length = freq_mask_length, time_mask_length
        self.fill_value = fill_value
        self.generator = generator_or_default(generator)
        self._draws: Dict[torch.device, torch.Generator] = {}

    @staticmethod
    def draw(generator: torch.Generator) -> torch.Tensor:
        return torch.rand((2, 2), generator=generator, device=generator.device)

    def apply(self, x: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
        for axis, length, (u1, u2) in ((1, self.freq_mask_length, draws[0]),
                                       (2, self.time_mask_length, draws[1])):
            if not length:
                continue
            size = x.shape[axis]
            value = u1 * length
            start = u2 * (size - value)
            idx = torch.arange(size, dtype=draws.dtype, device=x.device)
            shape = [1] * x.dim()
            shape[axis] = size
            mask = ((idx >= start) & (idx < start + value)).reshape(shape)
            x = torch.where(mask, torch.full((), self.fill_value, dtype=x.dtype,
                                             device=x.device), x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        return self.apply(x, self.draw(remat.seeded_generator(self.generator, self._draws,
                                                              x.device)))

    def extra_repr(self) -> str:
        return (f"freq_mask_length={self.freq_mask_length}, "
                f"time_mask_length={self.time_mask_length}, fill_value={self.fill_value}")

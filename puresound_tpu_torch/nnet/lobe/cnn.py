"""Conv building blocks (counterpart of puresound_tpu/nnet/lobe/cnn.py).

`Conv1d` is torch-compatible ([O, I/groups, K] weight) with explicit
symmetric padding; `Conv2d` / `ConvTranspose2d` are torch-compatible too, with the causal
frame-streaming forms of the Unet; `DepthwiseSeparableConv1d` keeps PureSound's
`in_conv` / `depthwise` / `pointwise` Sequential layout so its state_dict
names match the reference. `SpectralTransform` / `FFC` are the Fast Fourier
Convolution blocks (JAX `cnn.py:294-369`) on `Conv2d` and `bN2d`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.init import generator_or_default, uniform
from .activation import PReLU
from .norm import BatchNorm, get_norm


class Conv1d(nn.Module):
    """torch-compatible Conv1d on [N, C, T]."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1,
                 stride: int = 1, dilation: int = 1, padding: int = 0,
                 groups: int = 1, bias: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.padding, self.groups = padding, groups
        g = generator_or_default(generator)
        bound = math.sqrt(groups / (in_channels * kernel))
        self.weight = uniform((out_channels, in_channels // groups, kernel),
                              bound, g, device, dtype)
        self.bias = (uniform((out_channels,), bound, g, device, dtype)
                     if bias else None)

    def forward(self, x: torch.Tensor, pad: Optional[int] = None) -> torch.Tensor:
        """`pad` overrides the module's symmetric padding (0: a streaming
        step whose context is already in x)."""
        pad = self.padding if pad is None else pad
        if pad:
            x = F.pad(x, (pad, pad))
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv1d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)

    def dense_last(self, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv as a feature-LAST matmul: [..., C_in] -> [..., C_out]."""
        if not (self.kernel == 1 and self.stride == 1 and self.groups == 1):
            raise ValueError("dense_last is a 1x1-conv path")
        y = x @ self.weight[:, :, 0].T.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


def _pad2d(x: torch.Tensor, pad) -> torch.Tensor:
    """Zero-pad [N, C, H, W] by pad = ((top, bottom), (left, right))."""
    (t, b), (l, r) = pad
    return F.pad(x, (l, r, t, b)) if (t or b or l or r) else x


class Conv2d(nn.Module):
    """torch-compatible Conv2d on [N, C, H, W] ([O, I, kH, kW] weight) with
    explicit asymmetric padding `pad` = ((top, bottom), (left, right))
    (JAX `nnet/lobe/cnn.py:79`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=(1, 1), dilation=(1, 1), pad=((0, 0), (0, 0)),
                 bias: bool = True, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.dilation, self.pad = tuple(dilation), pad
        g = generator_or_default(generator)
        bound = math.sqrt(1.0 / (in_channels * self.kernel[0] * self.kernel[1]))
        self.weight = uniform((out_channels, in_channels, *self.kernel), bound,
                              g, device, dtype)
        self.bias = (uniform((out_channels,), bound, g, device, dtype)
                     if bias else None)

    def forward(self, x: torch.Tensor, pad=None) -> torch.Tensor:
        """`pad` overrides the configured padding (streaming paths supply
        their own time context)."""
        x = _pad2d(x, self.pad if pad is None else pad)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        dilation=self.dilation)

    def stream_apply(self, h: torch.Tensor, carry: torch.Tensor,
                     pad_f) -> torch.Tensor:
        """Causal frame streaming for time kernel 2, stride 1: the module on
        [carry, h] without the concat. The time context enters as zero
        padding and the carried frame's tap is added into frame 0."""
        if self.kernel[1] != 2 or self.stride[1] != 1 or self.dilation[1] != 1:
            raise ValueError("stream_apply needs time kernel 2, stride 1")
        y = self(h, pad=(pad_f, (1, 0)))
        c = F.conv2d(_pad2d(carry.to(h.dtype)[..., None], (pad_f, (0, 0))),
                     self.weight[:, :, :, 0:1].to(h.dtype), stride=self.stride,
                     dilation=self.dilation)
        return torch.cat([y[..., :1] + c, y[..., 1:]], dim=-1)


class ConvTranspose2d(nn.Module):
    """torch-compatible ConvTranspose2d ([in, out, kH, kW] weight,
    `padding` / `output_padding`; JAX `nnet/lobe/cnn.py:137`):
    out = (in-1)*stride - 2*padding + dilation*(kernel-1) + output_padding + 1."""

    def __init__(self, in_channels: int, out_channels: int, kernel,
                 stride=(1, 1), dilation=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), bias: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.dilation, self.padding = tuple(dilation), tuple(padding)
        self.output_padding = tuple(output_padding)
        g = generator_or_default(generator)
        bound = math.sqrt(1.0 / (out_channels * self.kernel[0] * self.kernel[1]))
        self.weight = uniform((in_channels, out_channels, *self.kernel), bound,
                              g, device, dtype)
        self.bias = (uniform((out_channels,), bound, g, device, dtype)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b,
                                  stride=self.stride, padding=self.padding,
                                  output_padding=self.output_padding,
                                  dilation=self.dilation)

    def _carry_tap(self, carry: torch.Tensor, dtype) -> torch.Tensor:
        """Frame-0 contribution of the carried (previous chunk's last) input
        frame: a one-frame transpose conv with the earlier-time tap."""
        return F.conv_transpose2d(
            carry.to(dtype)[..., None], self.weight[:, :, :, 1:2].to(dtype),
            stride=(self.stride[0], 1), padding=(self.padding[0], 0),
            output_padding=(self.output_padding[0], 0),
            dilation=(self.dilation[0], 1))

    def stream_apply(self, h: torch.Tensor, carry: torch.Tensor) -> torch.Tensor:
        """Causal frame streaming for time kernel 2 / stride 1 / padding 0:
        the module on [carry, h], frames 1..K, without the concat. The call
        on h alone gives out[t] = W_1 h[t-1] + W_0 h[t] (h[-1] = 0) at
        [..., :K]; the carried frame reaches frame 0 through W_1."""
        if (self.kernel[1] != 2 or self.stride[1] != 1 or self.dilation[1] != 1
                or self.padding[1] != 0 or self.output_padding[1] != 0):
            raise ValueError("stream_apply needs time kernel 2, stride 1, "
                             "padding 0")
        K = h.shape[-1]
        y = self(h)[..., :K]
        return torch.cat([y[..., :1] + self._carry_tap(carry, h.dtype),
                          y[..., 1:]], dim=-1)


class DepthwiseSeparableConv1d(nn.Module):
    """(1x1-in ->) depthwise dilated conv -> 1x1 conv, each norm + PReLU
    (+ a 1x1 skip of the input) (JAX `nnet/lobe/cnn.py:222-292`). The
    1x1-in (`in_conv`, PureSound's Sequential) comes with `hid_channels`,
    the skip (`skip_conv`) with `skip`. A causal block pads (k-1)*d on both
    sides and trims that many frames on the right of its output;
    `step_chunk` streams it with the depthwise input's last (k-1)*d frames
    carried.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 norm_cls: str = "gGN", kernel: int = 3, stride: int = 1,
                 dilation: int = 1, causal: bool = False,
                 hid_channels: Optional[int] = None, skip: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if causal and norm_cls in ("gLN", "gGN"):
            raise ValueError("Conflict between global normalization and causal operation.")
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        norm = get_norm(norm_cls)
        self.causal, self.skip = causal, skip
        hid = hid_channels if hid_channels is not None else in_channels
        self.padding = (kernel - 1) * dilation if causal else ((kernel - 1) // 2) * dilation
        if hid_channels is not None:
            self.in_conv = nn.Sequential(Conv1d(in_channels, hid, 1, generator=g, **fk),
                                         norm(hid, **fk), PReLU(**fk))
        self.depthwise = nn.Sequential(
            Conv1d(hid, hid, kernel, stride=stride, dilation=dilation,
                   padding=self.padding, groups=hid, generator=g, **fk),
            norm(hid, **fk), PReLU(**fk))
        self.pointwise = nn.Sequential(
            Conv1d(hid, out_channels, 1, generator=g, **fk),
            norm(out_channels, **fk), PReLU(**fk))
        if skip:
            self.skip_conv = Conv1d(in_channels, out_channels, 1, generator=g, **fk)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return self.in_conv(x) if hasattr(self, "in_conv") else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pointwise(self.depthwise(self._in(x)))
        if self.causal and self.padding:
            y = y[..., :-self.padding]
        return y + self.skip_conv(x) if self.skip else y

    @property
    def ctx_frames(self) -> int:
        """Frames of depthwise input a causal streaming step carries."""
        return self.padding

    def step_chunk(self, x: torch.Tensor, ctx: torch.Tensor):
        """One causal streaming chunk: x [B, C, K] and the carried context
        ctx [B, hid, (k-1)*d] -> (y [B, C_out, K], the new context)."""
        if not self.causal:
            raise ValueError("step_chunk needs a causal DepthwiseSeparableConv1d")
        full = torch.cat([ctx, self._in(x)], dim=-1)
        conv, norm, act = self.depthwise
        y = self.pointwise(act(norm(conv(full, pad=0))))
        if self.skip:
            y = y + self.skip_conv(x)
        return y, full[..., full.shape[-1] - self.padding:]


def _ffc_pad(kernel_size, causal: bool):
    """((freq top, bottom), (time left, right)): the frequency axis padded
    kf // 2 each side; time (kt - 1, 0) when causal, else kt // 2 each side."""
    kf, kt = kernel_size
    return ((kf // 2, kf // 2), (kt - 1, 0) if causal else (kt // 2, kt // 2))


class SpectralTransform(nn.Module):
    """FFC's spectral branch on x [N, CH, F, T] (JAX `cnn.py:294-324`): a
    conv + BatchNorm + ReLU, the real FFT along frequency (dim 2), a 1x1
    conv + BatchNorm + ReLU on [real, imag] stacked on the channels, the
    inverse FFT back to F bins, the residual and a 1x1 conv out.

    torch's CUDA FFT takes no bfloat16 (JAX's refuses it on any device), so
    a bfloat16 / float16 input takes its FFT-domain part in float32 and
    rounds back where JAX casts (`ffted.astype(x.dtype)`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3),
                 stride=(1, 1), causal: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.in_conv = Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                              pad=_ffc_pad(kernel_size, causal), generator=g, **fk)
        self.in_bn = BatchNorm(out_channels, **fk)
        self.fft_conv = Conv2d(2 * out_channels, 2 * out_channels, (1, 1), generator=g, **fk)
        self.fft_bn = BatchNorm(2 * out_channels, **fk)
        self.out_conv = Conv2d(out_channels, out_channels, (1, 1), generator=g, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.in_bn(self.in_conv(x)))
        xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
        ffted = torch.fft.rfft(xf, dim=2)
        cat = torch.cat([ffted.real, ffted.imag], dim=1)
        re, im = torch.relu(self.fft_bn(self.fft_conv(cat))).chunk(2, dim=1)
        ffted = torch.fft.irfft(torch.complex(re, im), n=x.shape[2], dim=2)
        return self.out_conv(x + ffted.to(x.dtype))


class FFC(nn.Module):
    """Fast Fourier Convolution on x [N, C_in, F, T] (JAX `cnn.py:327-369`):
    the first int(C_in * alpha) channels are global (`global_spec_trans`
    and `global_conv`), the rest local (`local_global_conv`,
    `local_local_conv`); global_out = ReLU(bN(spectral + local->global)),
    local_out = ReLU(bN(global->local + local->local)); the output is
    [local, global] on the channels. Where int(C * alpha) is 0 for the
    input or the output, a zero-channel conv's init divides by zero
    (ZeroDivisionError), as JAX's does."""

    def __init__(self, in_channels: int, out_channels: int, alpha: float = 0.3,
                 kernel_size=(3, 3), stride=(1, 1), causal: bool = True, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.fft_in_ch = int(in_channels * alpha)
        fft_out = int(out_channels * alpha)
        local_in, local_out = in_channels - self.fft_in_ch, out_channels - fft_out
        conv = lambda i, o: Conv2d(i, o, kernel_size, stride=stride,
                                   pad=_ffc_pad(kernel_size, causal), generator=g, **fk)
        self.global_spec_trans = SpectralTransform(self.fft_in_ch, fft_out, kernel_size,
                                                   stride, causal, generator=g, **fk)
        self.global_conv = conv(self.fft_in_ch, local_out)
        self.local_global_conv = conv(local_in, fft_out)
        self.local_local_conv = conv(local_in, local_out)
        self.global_bn = BatchNorm(fft_out, **fk)
        self.local_bn = BatchNorm(local_out, **fk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        global_in, local_in = x[:, :self.fft_in_ch], x[:, self.fft_in_ch:]
        global_out = torch.relu(self.global_bn(self.global_spec_trans(global_in)
                                               + self.local_global_conv(local_in)))
        local_out = torch.relu(self.local_bn(self.global_conv(global_in)
                                             + self.local_local_conv(local_in)))
        return torch.cat([local_out, global_out], dim=1)

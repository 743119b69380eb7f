"""Normalization layers over channel-first [N, C, T] data.

Counterpart of puresound_tpu/nnet/lobe/norm.py. Statistics are taken in at
least float32 (float64 stays float64), with the single-pass variance
E[x^2] - mean^2 of the reference (norm.py:20-32). Parameter names follow
PureSound's torch modules: GlobLN keeps gamma/beta, the gGN alias is
torch's GroupNorm(1, C) (weight/bias), BatchNorm and LayerNorm are torch's.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...utils.init import const


def _moments(x: torch.Tensor, dims):
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=dims, keepdim=True)
    var = ((xf * xf).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0.0)
    return mean, var


def _normalize(x, mean, var, eps):
    """(x - mean) * rsqrt(var + eps) in x.dtype (per-sample scalars cast down)."""
    rstd = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * rstd.to(x.dtype)


def _channel_shape(x: torch.Tensor, c: int):
    return (1, c) + (1,) * (x.dim() - 2)


class GlobLN(nn.Module):
    """Global layer norm over every non-batch dim (eps 1e-8)."""

    def __init__(self, channel_size: int, eps: float = 1e-8, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.channel_size, self.eps = channel_size, eps
        self.gamma = const((channel_size,), 1.0, device, dtype)
        self.beta = const((channel_size,), 0.0, device, dtype)

    def forward(self, x):
        mean, var = _moments(x, tuple(range(1, x.dim())))
        shape = _channel_shape(x, self.channel_size)
        return (_normalize(x, mean, var, self.eps)
                * self.gamma.reshape(shape).to(x.dtype)
                + self.beta.reshape(shape).to(x.dtype))


class GroupNorm1(nn.Module):
    """GroupNorm with one group: layer norm over (C, *), eps 1e-8."""

    def __init__(self, channel_size: int, eps: float = 1e-8, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.channel_size, self.eps = channel_size, eps
        self.weight = const((channel_size,), 1.0, device, dtype)
        self.bias = const((channel_size,), 0.0, device, dtype)

    def forward(self, x):
        mean, var = _moments(x, tuple(range(1, x.dim())))
        normed = ((x - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        shape = _channel_shape(x, self.channel_size)
        return (normed * self.weight.reshape(shape).to(x.dtype)
                + self.bias.reshape(shape).to(x.dtype))


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 with running statistics (`norm.py:120-163`).

    Training mode normalises with the batch statistics, taken in at least
    float32 with the single-pass variance, and updates the running stats
    with momentum 0.1 and the unbiased variance n / (n - 1). The update
    starts from the stats as they are stored: under mixed precision those
    are the bfloat16 casts, and the old term is scaled in their dtype, as
    JAX's weak-typed scalar does. When the new stats keep the buffers'
    dtype they are written in place; otherwise (bfloat16 buffers given to
    `torch.func.functional_call`) the buffers are rebound to the float32
    result, which the caller reads back.
    """

    momentum = 0.1

    def __init__(self, channel_size: int, eps: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.channel_size, self.eps = channel_size, eps
        self.weight = const((channel_size,), 1.0, device, dtype)
        self.bias = const((channel_size,), 0.0, device, dtype)
        self.register_buffer("running_mean",
                             torch.zeros(channel_size, device=device, dtype=dtype))
        self.register_buffer("running_var",
                             torch.ones(channel_size, device=device, dtype=dtype))

    def _update(self, name: str, batch_value: torch.Tensor):
        old = getattr(self, name)
        keep = torch.tensor(1 - self.momentum, dtype=old.dtype, device=old.device)
        new = old * keep + self.momentum * batch_value
        if new.dtype == old.dtype:
            old.copy_(new)
        else:
            setattr(self, name, new)

    def forward(self, x):
        shape = _channel_shape(x, self.channel_size)
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=dims)
            var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                self._update("running_mean", mean)
                self._update("running_var", var * n / max(n - 1, 1))
        else:
            mean, var = self.running_mean, self.running_var
        rstd = torch.rsqrt(var.reshape(shape) + self.eps)
        return ((x - mean.reshape(shape).to(x.dtype))
                * rstd.to(x.dtype)
                * self.weight.reshape(shape).to(x.dtype)
                + self.bias.reshape(shape).to(x.dtype))


class LayerNormLast(nn.Module):
    """torch-style LayerNorm over the last dim (eps 1e-5, affine)."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.features, self.eps = features, eps
        self.weight = const((features,), 1.0, device, dtype)
        self.bias = const((features,), 0.0, device, dtype)

    def forward(self, x):
        mean, var = _moments(x, (-1,))
        return (_normalize(x, mean, var, self.eps) * self.weight.to(x.dtype)
                + self.bias.to(x.dtype))


_REGISTRY = {"gLN": GlobLN, "gGN": GroupNorm1, "bN1d": BatchNorm,
             "bN2d": BatchNorm}
_NOT_PORTED = ("cLN", "iLN")


def get_norm(name: str) -> Callable[..., nn.Module]:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"norm {name!r} is not ported yet (ROADMAP queue 1: the rest of "
            "the TSE zoo / NS)")
    if name not in _REGISTRY:
        raise NameError(f"Could not interpret normalization identifier: {name}")
    return _REGISTRY[name]

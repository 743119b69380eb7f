"""Normalization layers over channel-first [N, C, T] data.

Counterpart of puresound_tpu/nnet/lobe/norm.py (`bN2d` is the same
BatchNorm on [N, C, F, T]; `LayerNorm2D` the FFC family's channel +
frequency norm; the module-level aliases and `is_batchnorm` as JAX's
`:196-216`). Statistics are taken in at
least float32 (float64 stays float64), with the single-pass variance
E[x^2] - mean^2 of the reference (norm.py:20-32). Parameter names follow
PureSound's torch modules: GlobLN and ChanLN keep gamma/beta, the gGN alias
is torch's GroupNorm(1, C) (weight/bias), BatchNorm and LayerNorm are torch's.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ...parallel import multihost, remat
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


class ChanLN(GlobLN):
    """Channel-wise layer norm: over the channel dim only (cLN, eps 1e-8;
    JAX `norm.py:78`)."""

    def forward(self, x):
        mean, var = _moments(x, (1,))
        shape = _channel_shape(x, self.channel_size)
        return (_normalize(x, mean, var, self.eps)
                * self.gamma.reshape(shape).to(x.dtype)
                + self.beta.reshape(shape).to(x.dtype))


class InstantLN(GlobLN):
    """Instant layer norm (iLN, JAX `norm.py:86-94`): a [N, CH, C, T] tensor
    normalised over (channel, freq) frame by frame, the affine over the
    CH * C flattened channels (`channel_size` is CH * C)."""

    def forward(self, x):
        N, CH, C, T = x.shape
        flat = x.reshape(N, CH * C, T)
        mean, var = _moments(flat, (1,))
        shape = _channel_shape(flat, self.channel_size)
        return (_normalize(flat, mean, var, self.eps)
                * self.gamma.reshape(shape).to(x.dtype)
                + self.beta.reshape(shape).to(x.dtype)).reshape(N, CH, C, T)


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


class LayerNorm2D(nn.Module):
    """Channel + frequency layer norm of a [N, CH, F, T] tensor, frame by
    frame, with a [1, CH, F, 1] affine (JAX `norm.py:97-117`): the unbiased
    std (ddof 1, torch's `.std()`), eps added to the std, not the variance;
    `w` starts at 1, `b` at 1e-4. The moments are taken in at least float32
    and the normalisation runs in the input's dtype, as JAX's."""

    def __init__(self, ch: int, f: int, eps: float = 1e-8, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.ch, self.f, self.eps = ch, f, eps
        self.w = const((1, ch, f, 1), 1.0, device, dtype)
        self.b = const((1, ch, f, 1), 1e-4, device, dtype)

    def forward(self, x):
        n = x.shape[1] * x.shape[2]
        mean, var = _moments(x, (1, 2))
        std = torch.sqrt(var * (n / max(n - 1, 1)))
        inv = (1.0 / (std + self.eps)).to(x.dtype)
        return ((x - mean.to(x.dtype)) * inv * self.w.to(x.dtype)
                + self.b.to(x.dtype))


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
    result, which the caller reads back. Inside `multihost.global_batch`
    the statistics are the global batch's (the moments all-reduced); a
    recomputation under `TRAIN.remat` leaves the running stats alone.
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
            n = x.numel() // x.shape[1]
            if multihost.syncing():
                # the global batch's statistics (data parallelism): the mean
                # over the dp group's processes of their local moments, each holding
                # as many rows (the lockstep loader); a world of one is exact
                group = multihost.sync_group()
                world = multihost.dist.get_world_size(group)
                moments = multihost.all_reduce_sum(
                    torch.stack([xf.mean(dim=dims), (xf * xf).mean(dim=dims)]),
                    group) / world
                n *= world
                mean = moments[0]
                var = (moments[1] - mean * mean).clamp_min(0.0)
            else:
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
            if not remat.recomputing():
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


# the aliases (JAX `norm.py:196-202`); LN2D is not in the registry, as in JAX
gLN = GlobLN
cLN = ChanLN
iLN = InstantLN
bN1d = BatchNorm
bN2d = BatchNorm
gGN = GroupNorm1
LN2D = LayerNorm2D

_REGISTRY = {"gLN": GlobLN, "cLN": ChanLN, "iLN": InstantLN, "gGN": GroupNorm1,
             "bN1d": BatchNorm, "bN2d": BatchNorm}
_IS_BATCHNORM = {"bN1d", "bN2d"}


def get_norm(name: str) -> Callable[..., nn.Module]:
    if name not in _REGISTRY:
        raise NameError(f"Could not interpret normalization identifier: {name}")
    return _REGISTRY[name]


def is_batchnorm(name: str) -> bool:
    return name in _IS_BATCHNORM


def apply_norm(norm_module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Call a norm module (JAX `norm.py:220`). JAX passes `train` to
    BatchNorm only; here BatchNorm reads its module's `training` flag."""
    return norm_module(x)

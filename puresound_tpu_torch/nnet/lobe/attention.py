"""Attention layers (counterpart of puresound_tpu/nnet/lobe/attention.py:19-158).

`PositionalEncoding` (sinusoidal table, kept a float32 constant outside the
state_dict as JAX keeps its numpy table, so bf16 serving adds float32
positions), `attention_mask` (causal and context-window), `MHA` (no biases,
torch MultiheadAttention's `in_proj_weight` [3E, E] / `out_proj.weight`
under `atten`) and `MhaSelfAttenLayer`, the post-norm transformer encoder
block with a ReLU feed-forward (PureSound's `feedforward` Sequential:
Linear, ReLU, Dropout, Linear, Dropout). Its norms are flax `nn.LayerNorm`s:
eps 1e-5, statistics in at least float32 with the single-pass variance
E[x^2] - E[x]^2 clipped at 0, the output in the promoted dtype of the input
and the parameters. `improved=True` is DPTNet's block: the feed-forward is
the port's `LSTM` lobe (uni- or bidirectional, its scans on
`lstm_scan_train_fp`), then ReLU, dropout, `ff2`, dropout, and no
positional encoding (JAX `:121-158`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ...utils.init import const, generator_or_default, uniform
from .dropout import Dropout
from .norm import _moments
from .rnn import LSTM, Linear


def sinusoid_table(d_model: int, max_len: int = 5000) -> np.ndarray:
    """[max_len, d_model] float32 sinusoidal positions (sin on even, cos on
    odd channels)."""
    if d_model % 2:
        raise ValueError("PositionalEncoding needs an even d_model")
    position = np.arange(max_len)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table to [N, T, C] (dropout off in eval)."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000, *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len
        self.pe_table = sinusoid_table(d_model, max_len)
        self.drop = Dropout(dropout, generator=generator)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def table(self, T: int, device) -> torch.Tensor:
        """The first T rows as a float32 tensor on `device` (copied there
        once)."""
        device = torch.device(device)
        pe = self._on.get(device)
        if pe is None:
            pe = self._on[device] = torch.from_numpy(self.pe_table).to(device)
        return pe[:T]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(x + self.table(x.shape[1], x.device)[None])


def attention_mask(size_q: int, causal: bool, context_range: Optional[int] = None,
                   device=None) -> Optional[torch.Tensor]:
    """Additive mask [L, S] (0 attends, -inf blocks), None when unmasked."""
    if not causal and context_range is None:
        return None
    i = torch.arange(size_q, device=device)[:, None]
    j = torch.arange(size_q, device=device)[None, :]
    if context_range is None:
        blocked = j > i
    elif causal:
        blocked = (j <= i - context_range) | (j > i)
    else:
        # symmetric window: |i - j| >= context_range - 1 is blocked
        blocked = (i - j).abs() >= context_range - 1
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(blocked, torch.full_like(zero, -math.inf), zero)


class _MultiheadAttentionParams(nn.Module):
    """torch MultiheadAttention(bias=False)'s parameters."""

    def __init__(self, d: int, g: torch.Generator, device, dtype):
        super().__init__()
        # xavier-uniform bounds, as the JAX module draws them
        self.in_proj_weight = uniform((3 * d, d), math.sqrt(6.0 / (4 * d)), g, device,
                                      dtype)
        self.out_proj = nn.Module()
        self.out_proj.weight = uniform((d, d), math.sqrt(6.0 / (2 * d)), g, device,
                                       dtype)


class MHA(nn.Module):
    """Multi-head attention without biases: q / k / v [N, T, C] -> (out
    [N, T, C], the attention weights averaged over heads [N, T, T])."""

    def __init__(self, embed_dim: int, heads: int = 1, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim % heads:
            raise ValueError(f"embed_dim {embed_dim} must split into {heads} heads")
        self.embed_dim, self.heads = embed_dim, heads
        self.atten = _MultiheadAttentionParams(embed_dim, generator_or_default(generator),
                                               device, dtype)

    def forward(self, query, key, value, causal: bool = True,
                context_range: Optional[int] = None):
        N, T, C = query.shape
        H = self.heads
        Dh = C // H
        wq, wk, wv = self.atten.in_proj_weight.to(query.dtype).chunk(3, dim=0)
        q = (query @ wq.T).reshape(N, T, H, Dh)
        k = (key @ wk.T).reshape(N, T, H, Dh)
        v = (value @ wv.T).reshape(N, T, H, Dh)
        logits = torch.einsum("nthd,nshd->nhts", q, k) / torch.tensor(
            math.sqrt(Dh), dtype=q.dtype)
        mask = attention_mask(T, causal, context_range, device=q.device)
        if mask is not None:
            logits = logits + mask.to(logits.dtype)[None, None]
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("nhts,nshd->nthd", weights, v).reshape(N, T, C)
        out = out @ self.atten.out_proj.weight.to(out.dtype).T
        return out, weights.mean(dim=1)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last dim (eps 1e-5, use_fast_variance):
    torch LayerNorm's `weight` / `bias` names."""

    def __init__(self, features: int, eps: float = 1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.features, self.eps = features, eps
        self.weight = const((features,), 1.0, device, dtype)
        self.bias = const((features,), 0.0, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x, (-1,))
        sdt = mean.dtype
        mul = torch.rsqrt(var + self.eps) * self.weight.to(sdt)
        y = (x.to(sdt) - mean) * mul + self.bias.to(sdt)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


class MhaSelfAttenLayer(nn.Module):
    """Post-norm transformer encoder block on x [N, C, T] -> [N, C, T]:
    norm1(x + MHA(pos(x))), then norm2(. + ff2(relu(ff1(.)))); improved:
    norm1(x + MHA(x)), then norm2(. + ff2(relu(LSTM(.)))) with `recurrent`
    (hidden_dim a direction) and `ff2` [D * hidden_dim -> feats_dim]."""

    def __init__(self, feats_dim: int, hidden_dim: int, nhead: int,
                 dropout: float = 0.0, improved: bool = False,
                 bidirectional: bool = False, position_encoding: bool = True, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.improved = improved
        self.position_encoding = position_encoding and not improved
        self.self_atten = MHA(feats_dim, nhead, generator=g, **fk)
        self.atten_drop = Dropout(dropout, generator=g)
        self.norm1 = LayerNorm(feats_dim, **fk)
        if improved:
            self.recurrent = LSTM(feats_dim, hidden_dim, bidirectional, generator=g, **fk)
            self.ff_drop1 = Dropout(dropout, generator=g)
            self.ff2 = Linear(hidden_dim * (2 if bidirectional else 1), feats_dim,
                              generator=g, **fk)
            self.ff_drop2 = Dropout(dropout, generator=g)
        else:
            if position_encoding:
                self.pos = PositionalEncoding(feats_dim, dropout, device=device,
                                              generator=g)
            self.feedforward = nn.Sequential(
                Linear(feats_dim, hidden_dim, generator=g, **fk), nn.ReLU(),
                Dropout(dropout, generator=g),
                Linear(hidden_dim, feats_dim, generator=g, **fk),
                Dropout(dropout, generator=g))
        self.norm2 = LayerNorm(feats_dim, **fk)

    def _feedforward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.improved:
            return self.feedforward(x)
        y, _ = self.recurrent(x)
        return self.ff_drop2(self.ff2(self.ff_drop1(torch.relu(y))))

    def forward(self, x: torch.Tensor, causal: bool = False,
                context_range: Optional[int] = None,
                return_atten_weight: bool = False):
        x = x.transpose(1, 2)                                    # [N, T, C]
        src = x
        if self.position_encoding:
            x = self.pos(x)
        x, w = self.self_atten(x, x, x, causal=causal, context_range=context_range)
        x = self.norm1(src + self.atten_drop(x))
        x = self.norm2(x + self._feedforward(x)).transpose(1, 2)
        return (x, w) if return_atten_weight else x

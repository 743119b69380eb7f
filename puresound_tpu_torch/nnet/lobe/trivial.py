"""FiLM conditioning (counterpart of puresound_tpu/nnet/lobe/trivial.py:88)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...utils.init import generator_or_default
from .cnn import Conv1d
from .norm import LayerNormLast


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

"""The residual TCN block and the ConvTasNet masker (counterparts of
puresound_tpu/nnet/conv_tasnet.py:38-124 and :230-314).

Every block with global norms (gLN / gGN), an odd kernel, no embedding
input and no causal padding runs through `ops.tcn_train_kernel.tcn_block_train`,
in training and in inference alike (JAX's `_fusable` / `_fused_call`,
`:79-105`): the CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor. JAX's v5e engagement floors (`_FUSED_TCN_MIN_ROWS*`,
`_FUSED_TCN_MAX_C_BF16`) and the `PURESOUND_FUSED_TCN` switch are TPU facts
and are dropped here. Embedded, causal and BatchNorm blocks take the stock
path under autograd, as in JAX. `GatedTCN` has no kernel in JAX either
(no `_fused_call`): it runs as plain PyTorch on every device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.tcn_train_kernel import tcn_block_train
from ..utils.init import generator_or_default
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d, DepthwiseSeparableConv1d
from .lobe.dropout import Dropout
from .lobe.norm import GlobLN, GroupNorm1, get_norm


def _gain_bias(norm: nn.Module):
    """(gamma, beta) of a global norm, or None for another kind."""
    if isinstance(norm, GlobLN):
        return norm.gamma, norm.beta
    if isinstance(norm, GroupNorm1):
        return norm.weight, norm.bias
    return None


def _with_embed(x: torch.Tensor, embed: Optional[torch.Tensor]) -> torch.Tensor:
    """x [N, C, T] with the embedding [N, E] broadcast over T and
    concatenated on the channels."""
    if embed is None:
        return x
    e = embed[:, :, None].to(x.dtype).expand(-1, -1, x.shape[-1])
    return torch.cat([x, e], dim=1)


class TCN(nn.Module):
    """(embedding concat) -> 1x1-in -> norm -> PReLU -> DSConv -> 1x1-out,
    +res. x: [N, C, T], embed: [N, emb_dim] or None.

    Layout follows PureSound:
    `in_conv` = Sequential(conv, norm, PReLU), `dconv` = Sequential(DSConv).
    """

    def __init__(self, in_channels: int, hid_channels: int, kernel: int,
                 dilation: int, tcn_norm: str = "gLN", dconv_norm: str = "gGN",
                 *, emb_dim: int = 0, causal: bool = False, dropout: float = 0.0,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.kernel, self.dilation = kernel, dilation
        self.hid_channels, self.emb_dim, self.causal = hid_channels, emb_dim, causal
        self.in_conv = nn.Sequential(
            Conv1d(in_channels + emb_dim, hid_channels, 1, bias=False, generator=g, **fk),
            get_norm(tcn_norm)(hid_channels, **fk), PReLU(**fk))
        self.dconv = nn.Sequential(DepthwiseSeparableConv1d(
            hid_channels, hid_channels, norm_cls=dconv_norm, kernel=kernel,
            dilation=dilation, causal=causal, generator=g, **fk))
        # after the DSConv, as JAX's `drop` (no zoo model sets it)
        self.drop = Dropout(dropout, generator=g)
        self.out_conv = Conv1d(hid_channels, in_channels, 1, generator=g, **fk)

    def fused_params(self):
        """The block's parameters in `tcn_block_train`'s order, or None when
        the block is not one the kernel takes (other norms, an even kernel,
        an embedding input or causal padding: the kernel's residual has no
        embedding channels and its depthwise conv is centred) or dropout (the
        kernel has none between the DSConv and the output conv)."""
        ds = self.dconv[0]
        norms = [_gain_bias(n) for n in (self.in_conv[1], ds.depthwise[1],
                                         ds.pointwise[1])]
        if (any(n is None for n in norms) or self.kernel % 2 == 0 or self.emb_dim
                or self.causal or self.drop.p):
            return None
        (g1, b1), (g2, b2), (g3, b3) = norms
        return (self.in_conv[0].weight[:, :, 0], g1, b1, self.in_conv[2].weight,
                ds.depthwise[0].weight[:, 0, :], ds.depthwise[0].bias, g2, b2,
                ds.depthwise[2].weight, ds.pointwise[0].weight[:, :, 0],
                ds.pointwise[0].bias, g3, b3, ds.pointwise[2].weight,
                self.out_conv.weight[:, :, 0], self.out_conv.bias)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = self.fused_params() if embed is None else None
        if params is not None:
            return tcn_block_train(x, *params, dilation=self.dilation)
        return self.out_conv(self.drop(self.dconv(self.in_conv(_with_embed(x, embed))))) + x

    @property
    def ctx_frames(self) -> int:
        return self.dconv[0].ctx_frames

    def init_ctx(self, batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.zeros((batch, self.hid_channels, self.ctx_frames), dtype=dtype,
                           device=device)

    def step_chunk(self, x: torch.Tensor, embed: Optional[torch.Tensor],
                   ctx: torch.Tensor):
        """One causal streaming chunk: x [B, C, K] and the carried depthwise
        context -> (y [B, C, K], the new context). The 1x1 convs and the
        norms (eval mode) are frame-local."""
        h = self.in_conv(_with_embed(x, embed))
        y, ctx = self.dconv[0].step_chunk(h, ctx)
        return self.out_conv(y) + x, ctx


def tcn_stacks(dim: int, tcn_layer: str, kernel: int, hid: int, dilated_basic: int,
               per_stack: int, repeat: int, with_embed: Sequence[int], embed_dim: int,
               tcn_norm: str, dconv_norm: str, causal: bool, use_film: bool = False, *,
               device=None, dtype=torch.float32, generator: torch.Generator) -> nn.ModuleList:
    """`repeat` stacks of `per_stack` TCN (`tcn_layer` "normal") or GatedTCN
    ("gated") blocks at dilation dilated_basic**i, block i taking the
    embedding where with_embed[i] (and FiLM-ing it, for a gated block, under
    `use_film`): ConvTasNet's and UnetTcn's `tcn_list` (JAX
    `conv_tasnet.py:249-272`, `unet.py:313-336`)."""
    if len(with_embed) != per_stack:
        raise ValueError("tcn_with_embed needs one flag a block of a stack")
    fk = dict(device=device, dtype=dtype, generator=generator)

    def block(i):
        emb = embed_dim if with_embed[i] else 0
        if tcn_layer.lower() == "normal":
            return TCN(dim, hid, kernel, dilated_basic ** i, tcn_norm=tcn_norm,
                       dconv_norm=dconv_norm, emb_dim=emb, causal=causal, **fk)
        if tcn_layer.lower() == "gated":
            return GatedTCN(dim, hid, kernel, dilated_basic ** i, emb_dim=emb,
                            causal=causal, tcn_norm=tcn_norm,
                            use_film=use_film if emb else False, **fk)
        raise NameError(tcn_layer)
    return nn.ModuleList(nn.ModuleList(block(i) for i in range(per_stack))
                         for _ in range(repeat))


class GatedTCN(nn.Module):
    """Gated two-branch TCN block (JAX `conv_tasnet.py:127-227`): u =
    in_conv(x); y = x + out_conv(left(u) * sigmoid(right(u_r))), each branch
    a dilated conv, norm, PReLU and dropout; u_r is u with the embedding
    concatenated, or FiLM-ed (cond_scale(e) * u + cond_bias(e)) under
    `use_film`. A causal block pads (k-1)*d on both sides, so its norms
    see (k-1)*d frames more, and trims them on the right after `out_conv`.

    PureSound's layout: `in_conv`, `left_conv` / `right_conv` =
    Sequential(conv, norm, PReLU), `out_conv`, `cond_scale` / `cond_bias`;
    no biases."""

    def __init__(self, in_channels: int, hid_channels: int, kernel: int,
                 dilation: int, dropout: float = 0.0, emb_dim: int = 0,
                 causal: bool = False, tcn_norm: str = "gLN", use_film: bool = False, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hid_channels, self.emb_dim = hid_channels, emb_dim
        self.causal, self.use_film = causal, use_film
        self.padd = (kernel - 1) * dilation if causal else (kernel - 1) * dilation // 2
        norm = get_norm(tcn_norm)
        branch = lambda c_in: nn.Sequential(
            Conv1d(c_in, hid_channels, kernel, dilation=dilation, padding=self.padd,
                   bias=False, generator=g, **fk),
            norm(hid_channels, **fk), PReLU(**fk))
        self.in_conv = Conv1d(in_channels, hid_channels, 1, bias=False, generator=g, **fk)
        self.left_conv = branch(hid_channels)
        self.left_drop = Dropout(dropout, generator=g)
        if use_film:
            self.cond_scale = Conv1d(emb_dim, hid_channels, 1, bias=False, generator=g, **fk)
            self.cond_bias = Conv1d(emb_dim, hid_channels, 1, bias=False, generator=g, **fk)
        self.right_conv = branch(hid_channels if use_film else hid_channels + emb_dim)
        self.right_drop = Dropout(dropout, generator=g)
        self.out_conv = Conv1d(hid_channels, in_channels, 1, bias=False, generator=g, **fk)

    def _condition(self, u: torch.Tensor, embed: Optional[torch.Tensor]) -> torch.Tensor:
        if embed is None:
            return u
        if not self.use_film:
            return _with_embed(u, embed)
        cond = embed[:, :, None].to(u.dtype)
        return self.cond_scale(cond) * u + self.cond_bias(cond)

    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        u = self.in_conv(x)
        left = self.left_drop(self.left_conv(u))
        right = torch.sigmoid(self.right_drop(self.right_conv(self._condition(u, embed))))
        y = self.out_conv(left * right)
        if self.causal and self.padd:
            y = y[..., :-self.padd]
        return y + x

    @property
    def ctx_frames(self) -> int:
        return self.padd

    def init_ctx(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """The two carried contexts: `h`, the hidden stream (the left
        branch's input), and `r`, the right branch's input after the FiLM or
        the concat (the offline conv pads it after conditioning, so zeros
        here are exact)."""
        if device is None:
            device = self.in_conv.weight.device
        right_ch = self.hid_channels + (0 if self.use_film else self.emb_dim)
        z = lambda c: torch.zeros((batch, c, self.padd), dtype=dtype, device=device)
        return {"h": z(self.hid_channels), "r": z(right_ch)}

    def step_chunk(self, x: torch.Tensor, embed: Optional[torch.Tensor], ctx: dict):
        """One causal streaming chunk: x [B, C, K] and the carried contexts
        -> (y [B, C, K], the new contexts); the norms in eval mode are
        frame-local."""
        if not self.causal:
            raise ValueError("step_chunk needs a causal GatedTCN")
        u = self.in_conv(x)
        h_full = torch.cat([ctx["h"], u], dim=-1)
        r_full = torch.cat([ctx["r"], self._condition(u, embed)], dim=-1)
        keep = lambda t: t[..., t.shape[-1] - self.padd:]
        run = lambda seq, t: seq[2](seq[1](seq[0](t, pad=0)))
        left, right = run(self.left_conv, h_full), torch.sigmoid(run(self.right_conv, r_full))
        return self.out_conv(left * right) + x, {"h": keep(h_full), "r": keep(r_full)}


class ConvTasNet(nn.Module):
    """`repeat_tcn` stacks of `per_tcn_stack` TCN blocks with dilation
    tcn_dilated_basic**i (`GatedTCN` blocks with `tcn_layer="gated"`); block
    i of a stack takes the speaker embedding when tcn_with_embed[i]. x:
    [N, C, T] -> mask [N, C, T].

    Module names follow PureSound's (`tcn_list.{r}.{i}`)."""

    def __init__(self, input_dim: int = 512, embed_dim: int = 256,
                 embed_norm: bool = False, tcn_layer: str = "normal",
                 tcn_kernel: int = 3, tcn_dim: int = 256, tcn_dilated_basic: int = 2,
                 per_tcn_stack: int = 5, repeat_tcn: int = 4,
                 tcn_with_embed: Sequence[int] = (1, 0, 0, 0, 0),
                 tcn_norm: str = "gLN", dconv_norm: str = "gGN", causal: bool = False,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.embed_norm, self.causal = embed_norm, causal
        self.tcn_with_embed = tuple(tcn_with_embed)
        self.tcn_list = tcn_stacks(input_dim, tcn_layer, tcn_kernel, tcn_dim,
                                   tcn_dilated_basic, per_tcn_stack, repeat_tcn,
                                   self.tcn_with_embed, embed_dim, tcn_norm, dconv_norm,
                                   causal, device=device, dtype=dtype, generator=g)

    def _norm_dvec(self, dvec: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        if self.embed_norm and dvec is not None:
            dvec = dvec / torch.linalg.norm(dvec, dim=1, keepdim=True).clamp_min(1e-12)
        return dvec

    def _blocks(self):
        """(block, takes the embedding) in order."""
        for stack in self.tcn_list:
            for i, layer in enumerate(stack):
                yield layer, bool(self.tcn_with_embed[i])

    def forward(self, x: torch.Tensor, dvec: Optional[torch.Tensor] = None) -> torch.Tensor:
        dvec = self._norm_dvec(dvec)
        for layer, embedded in self._blocks():
            x = layer(x, dvec) if embedded else layer(x)
        return x

    # -------------------------------------------------------------- streaming
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Streaming state: each block's depthwise-input context (the masker
        is convolutional, so this is all of it). Only a causal ConvTasNet
        streams, as JAX's `init_state` asserts."""
        if not self.causal:
            raise ValueError("streaming needs a causal ConvTasNet")
        if device is None:
            device = self.tcn_list[0][0].out_conv.weight.device
        return {"ctx": [layer.init_ctx(batch, dtype, device) for layer, _ in self._blocks()]}

    def step_frames(self, x: torch.Tensor, dvec: Optional[torch.Tensor], state: dict):
        """One streaming chunk in SkiM's streaming API: frames x [B, K, C]
        -> (mask frames [B, C, K], the new state); equal to the offline
        forward on the chunked input."""
        dvec = self._norm_dvec(dvec)
        h = x.transpose(1, 2)
        ctxs = []
        for (layer, embedded), ctx in zip(self._blocks(), state["ctx"]):
            h, ctx = layer.step_chunk(h, dvec if embedded else None, ctx)
            ctxs.append(ctx)
        return h, dict(state, ctx=ctxs)

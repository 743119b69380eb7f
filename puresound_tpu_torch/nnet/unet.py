"""Frequency-axis U-Net and its TCN / FSMN bottleneck variants (counterpart
of puresound_tpu/nnet/unet.py:27-293, `UnetTcn` :296-392, `UnetFsmn`
:395-477).

With `multi_output` M > 1 the last up layer emits chans[0] * M channels,
read as (M, chans[0]) and unpacked to an [N, M, C, T] mask (the SIMO
separator, `DPARN_Mout`). The shape algebra is JAX's (and PureSound's):
- down layer i: zero pad (time (k_t-1-delay, delay), freq centred), Conv2d
  of stride (s_f, s_t), norm, activation, dropout;
- up layer: ConvTranspose2d(kernel (k_f, t_kernel), padding k_f//2,
  output_padding s_f - k_f + 2*(k_f//2)), norm and activation but on the
  last, then t_kernel-1 frames trimmed on the right (or on the left with
  `transpose_delay`, the semi-causal lookahead mode). The skip enters an
  up layer concatenated, or with `skip_conv` added after a 1x1 conv and the
  activation (`skip_cnn[j]` = [Conv2d, act]).
Module names follow PureSound's Sequential layout: `cnn_down[i]` =
[ZeroPad2d, Conv2d, norm, act, Dropout], `cnn_up[j]` = [ConvTranspose2d,
norm, act] (the last up layer only the transpose conv), so a state_dict
reads `masker.cnn_down.0.1.weight`.

`UnetTcn` runs `repeat_tcn` x `per_tcn_stack` TCN or GatedTCN blocks, and
`UnetFsmn` a chain of FSMN layers with their memory handed on, over the
bottleneck flattened to [N, ch * F, T]; the speaker embedding (L2-normalised
under `embed_norm`) conditions the blocks flagged for it.

The streaming helpers run a chunk of K frames through the causal layers
(time kernel 2): a down conv prepends its carried last input frame as a
one-tap term, a transpose conv keeps its last input frame pending, and
with `transpose_delay` per-layer FIFOs realign the skips. A UnetTcn streams
with causal blocks only, a UnetFsmn with r_context 0; JAX asserts both when
the stream state is made, the port raises a ValueError as the streaming
engine is built (`check_streamable`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.init import generator_or_default
from .conv_tasnet import tcn_stacks
from .lobe.activation import get_activation
from .lobe.cnn import Conv2d, ConvTranspose2d
from .lobe.dropout import Dropout
from .lobe.norm import apply_norm, get_norm
from .lobe.rnn import FSMN, ConditionFSMN


class Unet(nn.Module):
    """Freq-axis down/up 2-D CNN: x [N, C, T] (RI-concat or real) -> mask
    [N, C, T] ([N, M, C, T] when multi_output M > 1)."""

    def __init__(self, input_type: str = "RI", input_dim: int = 512,
                 activation_type: str = "PReLU", norm_type: str = "bN2d",
                 dropout: float = 0.05, channels: Sequence[int] = (1, 1, 8, 8, 16, 16),
                 transpose_t_size: int = 2, skip_conv: bool = False,
                 kernel_t=(5, 1, 9, 1, 1), stride_t=(1, 1, 1, 1, 1),
                 dilation_t=(1, 1, 1, 1, 1), kernel_f=(1, 5, 1, 5, 1),
                 stride_f=(1, 4, 1, 4, 1), dilation_f=(1, 1, 1, 1, 1),
                 delay=(0, 0, 1, 0, 0), multi_output: int = 1,
                 transpose_delay: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(kernel_t)
        if not (len(kernel_f) == len(stride_t) == len(stride_f) == len(dilation_t)
                == len(dilation_f) == len(delay) == n):
            raise ValueError("the per-layer tuples need one entry per layer")
        if input_type.lower() not in ("ri", "real"):
            raise TypeError("input_type must be RI or Real")
        self.input_type, self.input_dim, self.dropout = input_type, input_dim, dropout
        self.multi_output, self.skip_conv = multi_output, skip_conv
        self.transpose_t_size, self.transpose_delay = transpose_t_size, transpose_delay
        self.kernel_t, self.kernel_f = tuple(kernel_t), tuple(kernel_f)
        self.stride_t, self.stride_f = tuple(stride_t), tuple(stride_f)
        self.dilation_t, self.delay = tuple(dilation_t), tuple(delay)
        self._n_cnn = n
        chans = list(channels)
        chans[0] = chans[0] * 2 if input_type.lower() == "ri" else chans[0]
        self._chans = chans
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        act, norm = get_activation(activation_type), get_norm(norm_type)
        mk_act = lambda: act(**fk) if act.__name__ == "PReLU" else act()

        self.cnn_down = nn.ModuleList()
        for i in range(n):
            kf, kt = kernel_f[i], kernel_t[i]
            self.cnn_down.append(nn.Sequential(
                nn.ZeroPad2d((kt - delay[i] - 1, delay[i], kf // 2, kf // 2)),
                Conv2d(chans[i], chans[i + 1], (kf, kt), stride=(stride_f[i], stride_t[i]),
                       dilation=(dilation_f[i], dilation_t[i]), generator=g, **fk),
                norm(chans[i + 1], **fk), mk_act(),
                Dropout(dropout, generator=g)))
        self.cnn_up = nn.ModuleList()
        for i in reversed(range(n)):
            k, s = kernel_f[i], stride_f[i]
            p = k // 2
            out_ch = chans[i] if i != 0 else chans[i] * multi_output
            layers = [ConvTranspose2d(chans[i + 1] * (1 if skip_conv else 2), out_ch,
                                      (k, transpose_t_size),
                                      stride=(s, stride_t[i]),
                                      dilation=(dilation_f[i], dilation_t[i]),
                                      padding=(p, 0), output_padding=(s - k + 2 * p, 0),
                                      generator=g, **fk)]
            if i != 0:
                layers += [norm(chans[i], **fk), mk_act()]
            self.cnn_up.append(nn.Sequential(*layers))
        if skip_conv:
            self.skip_cnn = nn.ModuleList(
                nn.Sequential(Conv2d(chans[i + 1], chans[i + 1], (1, 1), generator=g, **fk),
                              mk_act())
                for i in reversed(range(n)))

    @property
    def num_freq(self) -> int:
        return self.input_dim // 2 if self.input_type.lower() == "ri" else self.input_dim

    # ------------------------------------------------------------ components
    def _pack_input(self, x):
        """[N, C, T] -> [N, CH, F, T] (RI as 2 channels)."""
        if self.input_type.lower() == "ri":
            re, im = torch.chunk(x, 2, dim=-2)
            return torch.stack([re, im], dim=1)
        return x[:, None] if x.dim() == 3 else x

    def _unpack_output(self, x):
        """[N, CH, F, T] -> [N, C, T]; with multi_output M the channels are
        (M, CH / M) and the result [N, M, C, T]."""
        if self.multi_output != 1:
            N, ch, F, T = x.shape
            x = x.reshape(N, self.multi_output, ch // self.multi_output, F, T)
            if self.input_type.lower() == "ri":
                return torch.cat([x[:, :, 0], x[:, :, 1]], dim=2)
            return x[:, :, 0]
        if self.input_type.lower() == "ri":
            return torch.cat([x[:, 0], x[:, 1]], dim=1)
        return x[:, 0]

    def _down(self, x):
        skips = [x]
        for seq in self.cnn_down:
            x = seq(x)
            skips.append(x)
        return x, skips

    def _up(self, x, skips):
        trim = self.transpose_t_size - 1
        for i, seq in enumerate(self.cnn_up):
            if self.skip_conv:
                x = seq(x + self.skip_cnn[i](skips[-i - 1]))
            else:
                x = seq(torch.cat([x, skips[-i - 1]], dim=1))
            if trim:
                x = x[..., trim:] if self.transpose_delay else x[..., :-trim]
        return x

    def bottleneck_dim(self) -> int:
        """Channels x frequencies of the bottleneck, the width of the
        flattened features UnetTcn / UnetFsmn run on."""
        return self._stream_freqs()[-1] * self._chans[-1]

    def shape_info(self):
        """(down-path freqs, up-path freqs)."""
        down_shape, f = [self.num_freq], self.num_freq
        for s in self.stride_f:
            f = f // s + (0 if f % s == 0 else 1)
            down_shape.append(f)
        up_shape = [f]
        for i in range(self._n_cnn):
            seq = self.cnn_up[i][0]
            k, s = seq.kernel[0], seq.stride[0]
            p, op = seq.padding[0], seq.output_padding[0]
            up_shape.append((up_shape[-1] - 1) * s - 2 * p + seq.dilation[0] * (k - 1)
                            + op + 1)
        return down_shape, up_shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, skips = self._down(self._pack_input(x))
        return self._unpack_output(self._up(x, skips))

    # ------------------------------------------------------------- streaming
    def causal_streamable(self) -> bool:
        """Chunked streaming needs a 1-frame conv context per down layer
        (time kernel 2, stride 1, no per-layer delay), transpose_t_size 2
        and no skip_conv; the plain Unet streams one output only, as JAX's (`unet.py:200-207`),
        while the dual-path models stream M (`DualPathStreaming`)."""
        return self._conv_streamable() and self.multi_output == 1

    def _conv_streamable(self) -> bool:
        return (all(k == 2 for k in self.kernel_t)
                and all(s == 1 for s in self.stride_t)
                and all(d == 1 for d in self.dilation_t)
                and all(d == 0 for d in self.delay)
                and self.transpose_t_size == 2 and not self.skip_conv)

    @property
    def stream_delay_frames(self) -> int:
        """Mask-output delay in frames: with transpose_delay each up layer
        needs one future frame, so the stream runs n_layers frames late."""
        return len(self.kernel_t) if self.transpose_delay else 0

    def _stream_freqs(self):
        freqs = [self.num_freq]
        for s in self.stride_f:
            f = freqs[-1]
            freqs.append(f // s + (0 if f % s == 0 else 1))
        return freqs

    def _init_unet_stream_state(self, batch: int, dtype=torch.float32,
                                device=None) -> dict:
        if not self.causal_streamable():
            raise ValueError("streaming needs time kernels 2, strides/dilations "
                             "1, no delay, transpose_t_size 2, no skip_conv")
        freqs, chans, n = self._stream_freqs(), self._chans, self._n_cnn
        z = lambda *s: torch.zeros(s, device=device, dtype=dtype)
        state = {"down": [z(batch, chans[i], freqs[i]) for i in range(n)],
                 "up": [z(batch, 2 * chans[n - j], freqs[n - j]) for j in range(n)]}
        if self.transpose_delay:
            # up layer j runs j frames behind: a FIFO of j down frames
            # realigns its skip
            state["skipq"] = [z(batch, chans[n - j], freqs[n - j], j) for j in range(n)]
        return state

    def _stream_down(self, x: torch.Tensor, state: dict,
                     n_layers: Optional[int] = None):
        """x [B, C, K] -> (bottleneck [B, ch, F, K], skips, new down carries).
        `n_layers` stops after that many layers (a center-fused kernel runs
        the rest; state["down"] then holds that many carries)."""
        h = self._pack_input(x)
        skips, new_down = [h], []
        for i, seq in enumerate(self.cnn_down[:n_layers]):
            new_down.append(h[..., -1])
            kf = self.kernel_f[i]
            h = seq[1].stream_apply(h, state["down"][i], (kf // 2, kf // 2))
            h = seq[3](apply_norm(seq[2], h))
            skips.append(h)
        return h, skips, new_down

    def _stream_up(self, h: torch.Tensor, skips, state: dict, start: int = 0):
        """Bottleneck output [B, ch, F, K] -> (mask [B, C, K] or [B, M, C, K], new up
        carries, new skip FIFOs). `start` skips the first up layers (a
        center-fused kernel ran them; state["up"][j - start] then carries
        layer j)."""
        K = h.shape[-1]
        new_up, new_skipq = [], []
        for j in range(start, len(self.cnn_up)):
            seq = self.cnn_up[j]
            skip_now = skips[-j - 1]
            if self.transpose_delay and j > 0:
                cat = torch.cat([state["skipq"][j], skip_now], dim=-1)
                skip_use = cat[..., :K]
                new_skipq.append(cat[..., K:])
            else:
                skip_use = skip_now
                new_skipq.append(state["skipq"][j] if self.transpose_delay else None)
            h = torch.cat([h, skip_use], dim=1)
            new_up.append(h[..., -1])
            y = seq[0].stream_apply(h, state["up"][j - start])
            if len(seq) > 1:
                y = seq[2](apply_norm(seq[1], y))
            h = y
        return self._unpack_output(h), new_up, new_skipq


def _unit_dvec(dvec: Optional[torch.Tensor], embed_norm: bool) -> Optional[torch.Tensor]:
    """The d-vector L2-normalised (norm clipped at 1e-12) under `embed_norm`
    (JAX `unet.py:343`)."""
    if embed_norm and dvec is not None:
        dvec = dvec / torch.linalg.norm(dvec, dim=1, keepdim=True).clamp_min(1e-12)
    return dvec


class _BottleneckUnet(Unet):
    """A Unet whose bottleneck, flattened to [N, ch * F, T], runs through
    `_bottleneck` (offline) or `_stream_bottleneck` (a streaming chunk)."""

    def forward(self, x: torch.Tensor, dvec: Optional[torch.Tensor] = None) -> torch.Tensor:
        dvec = _unit_dvec(dvec, self.embed_norm)
        h, skips = self._down(self._pack_input(x))
        N, ch, F, T = h.shape
        h = self._bottleneck(h.reshape(N, ch * F, T), dvec).reshape(N, ch, F, T)
        return self._unpack_output(self._up(h, skips))

    def init_stream_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        self.check_streamable()
        if device is None:
            device = self.cnn_up[0][0].weight.device
        state = self._init_unet_stream_state(batch, dtype, device)
        state[self._carry_key] = self._init_carries(batch, dtype, device)
        return state

    def stream_frames(self, x: torch.Tensor, state: dict,
                      dvec: Optional[torch.Tensor] = None):
        """One streaming chunk: x [B, C, K] -> (mask [B, C, K], new state).
        With transpose_delay the mask lags by `stream_delay_frames`:
        stream[..., t] == offline[..., t - delay] (the first frames are
        warm-up); without it the stream is frame-exact."""
        dvec = _unit_dvec(dvec, self.embed_norm)
        h, skips, new_down = self._stream_down(x, state)
        B, ch, F, K = h.shape
        t, carries = self._stream_bottleneck(h.reshape(B, ch * F, K), dvec,
                                             state[self._carry_key])
        mask, new_up, new_skipq = self._stream_up(t.reshape(B, ch, F, K), skips, state)
        new_state = dict(state, down=new_down, up=new_up, **{self._carry_key: carries})
        if self.transpose_delay:
            new_state["skipq"] = new_skipq
        return mask, new_state


class UnetTcn(_BottleneckUnet):
    """Unet with `repeat_tcn` stacks of `per_tcn_stack` TCN (`tcn_layer`
    "normal") or GatedTCN ("gated") blocks over the flattened bottleneck;
    block i of a stack takes the d-vector where tcn_with_embed[i] (FiLM-ed,
    for a gated block, under `tcn_use_film`). `tcn_list.{r}.{i}` as
    PureSound names it. x [N, C, T] (+ dvec [N, E]) -> mask [N, C, T]."""

    _carry_key = "tcn"

    def __init__(self, embed_dim: int = 0, embed_norm: bool = False,
                 tcn_layer: str = "normal", tcn_kernel: int = 3, tcn_dim: int = 256,
                 tcn_dilated_basic: int = 2, per_tcn_stack: int = 5, repeat_tcn: int = 4,
                 tcn_with_embed: Sequence[int] = (1, 0, 0, 0, 0),
                 tcn_use_film: bool = False, tcn_norm: str = "gLN",
                 dconv_norm: str = "gGN", causal: bool = False, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 **unet):
        g = generator_or_default(generator)
        super().__init__(**unet, device=device, dtype=dtype, generator=g)
        self.embed_norm, self.causal = embed_norm, causal
        self.tcn_with_embed = tuple(tcn_with_embed)
        self.tcn_list = tcn_stacks(self.bottleneck_dim(), tcn_layer, tcn_kernel, tcn_dim,
                                   tcn_dilated_basic, per_tcn_stack, repeat_tcn,
                                   self.tcn_with_embed, embed_dim, tcn_norm, dconv_norm,
                                   causal, tcn_use_film, device=device, dtype=dtype,
                                   generator=g)

    def _blocks(self, dvec):
        """(block, its embedding or None) in order."""
        for stack in self.tcn_list:
            for i, layer in enumerate(stack):
                yield layer, dvec if self.tcn_with_embed[i] else None

    def _bottleneck(self, x, dvec):
        for layer, e in self._blocks(dvec):
            x = layer(x, e) if e is not None else layer(x)
        return x

    def check_streamable(self) -> None:
        """Raise a ValueError unless this masker streams: causal blocks and
        the causal Unet layers (JAX asserts it in `init_stream_state`,
        `unet.py:360`)."""
        if not self.causal:
            raise ValueError("streaming needs a causal UnetTcn (causal TCN blocks); "
                             "this one is not causal")
        if not self.causal_streamable():
            raise ValueError("streaming needs time kernels 2, strides/dilations 1, no "
                             "delay, transpose_t_size 2, no skip_conv")

    def _init_carries(self, batch, dtype, device):
        return [layer.init_ctx(batch, dtype, device) for layer, _ in self._blocks(None)]

    def _stream_bottleneck(self, t, dvec, ctxs):
        new = []
        for (layer, e), ctx in zip(self._blocks(dvec), ctxs):
            t, ctx = layer.step_chunk(t, e, ctx)
            new.append(ctx)
        return t, new


class UnetFsmn(_BottleneckUnet):
    """Unet with `num_fsmn` FSMN layers over the flattened bottleneck, the
    memory handed from layer to layer; layer i is a ConditionFSMN (the
    d-vector by FiLM under `use_film`, else concat-projected) where
    fsmn_with_embed[i]. `fsmn_list.{i}`. x [N, C, T] (+ dvec) -> mask."""

    _carry_key = "fsmn"

    def __init__(self, embed_dim: int = 0, embed_norm: bool = False,
                 fsmn_l_context: int = 3, fsmn_r_context: int = 0, fsmn_dim: int = 256,
                 num_fsmn: int = 8, fsmn_with_embed: Sequence[int] = (1,) * 8,
                 fsmn_norm: str = "gLN", use_film: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None,
                 **unet):
        g = generator_or_default(generator)
        super().__init__(**unet, device=device, dtype=dtype, generator=g)
        if num_fsmn != len(fsmn_with_embed):
            raise ValueError("fsmn_with_embed needs one flag a layer")
        self.embed_norm, self.fsmn_r_context = embed_norm, fsmn_r_context
        self.fsmn_with_embed = tuple(fsmn_with_embed)
        dim = self.bottleneck_dim()
        fk = dict(norm_type=fsmn_norm, device=device, dtype=dtype, generator=g)
        self.fsmn_list = nn.ModuleList(
            ConditionFSMN(dim, dim, fsmn_dim, fsmn_l_context, fsmn_r_context,
                          embed_dim=embed_dim, use_film=use_film, **fk) if flag else
            FSMN(dim, dim, fsmn_dim, fsmn_l_context, fsmn_r_context, **fk)
            for flag in self.fsmn_with_embed)

    def _bottleneck(self, x, dvec):
        memory = None
        for flag, layer in zip(self.fsmn_with_embed, self.fsmn_list):
            x, memory = layer(x, dvec, memory) if flag else layer(x, memory)
        return x

    def check_streamable(self) -> None:
        """Raise a ValueError unless this masker streams: causal FSMN layers
        (r_context 0) and the causal Unet layers (JAX asserts it in
        `init_stream_state`, `unet.py:447-448`)."""
        if self.fsmn_r_context:
            raise ValueError(f"streaming needs causal FSMN layers (fsmn_r_context 0), "
                             f"not {self.fsmn_r_context}")
        if not self.causal_streamable():
            raise ValueError("streaming needs time kernels 2, strides/dilations 1, no "
                             "delay, transpose_t_size 2, no skip_conv")

    def _init_carries(self, batch, dtype, device):
        return [layer.init_ctx(batch, dtype, device) for layer in self.fsmn_list]

    def _stream_bottleneck(self, t, dvec, rings):
        memory, new = None, []
        for flag, layer, ring in zip(self.fsmn_with_embed, self.fsmn_list, rings):
            t, memory, ring = layer.step_chunk(t, memory, ring, dvec if flag else None)
            new.append(ring)
        return t, new

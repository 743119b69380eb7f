"""SkiM — Skipping-Memory LSTM (counterpart of puresound_tpu/nnet/skim.py).

Causal SkiM with FiLM (or no) conditioning: the offline forward
(`skim.py:236`), differentiable, with every SegLSTM / MemLSTM scan through
`ops.lstm_train_kernel.lstm_scan_train_fp` (the SegLSTM finals feed
MemLSTM, and its outputs the next block's h0/c0, gradients included); the
explicit streaming state (`init_state` `:293`); the per-frame streaming
step (`step_frames` `:384`); and the fused streaming step
(`step_frames_fused` `:523`) that runs the block stack through
`ops.skim_stream_kernel.fused_skim_frames`. Module and parameter names
follow PureSound (`seg_lstm`, `mem_lstm`, `seg_input_fusion`,
`output_fc`), so its checkpoints load as they are.

The streaming state keeps the JAX pytree's keys; its shared segment clock
`frame_count` is a host int, so the segment-boundary test never reads the
device.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.skim_stream_kernel import SkimWeights, fused_skim_frames
from ..utils.init import fan_in_bound, generator_or_default, uniform
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d
from .lobe.norm import LayerNormLast
from .lobe.rnn import LSTM
from .lobe.trivial import FiLM


class Linear(nn.Module):
    """torch nn.Linear parameters ([out, in] weight) with an explicit init."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        k = fan_in_bound(in_features)
        self.weight = uniform((out_features, in_features), k, g, device, dtype)
        self.bias = uniform((out_features,), k, g, device, dtype)

    def forward(self, x):
        return x @ self.weight.T.to(x.dtype) + self.bias.to(x.dtype)


class SegLSTM(nn.Module):
    """Intra-segment LSTM + projection + LayerNorm residual.

    forward(x [B, K, C], h [1, B, H], c [1, B, H]) -> (y, h', c').
    """

    def __init__(self, input_size: int, hidden_size: int, causal: bool = True,
                 *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size = hidden_size
        self.lstm = LSTM(input_size, hidden_size, bidirectional=not causal,
                         generator=g, **fk)
        self.proj = Linear(hidden_size, input_size, generator=g, **fk)
        self.norm = LayerNormLast(input_size, **fk)

    def forward(self, x, h=None, c=None):
        if h is None:
            h = x.new_zeros((1, x.shape[0], self.hidden_size))
        if c is None:
            c = x.new_zeros((1, x.shape[0], self.hidden_size))
        y, (h, c) = self.lstm(x, (h, c))
        return x + self.norm(self.proj(y)), h, c


class MemLSTM(nn.Module):
    """Inter-segment memory LSTM over SegLSTM (h, c) states (causal)."""

    def __init__(self, hidden_size: int, causal: bool = True, *, device=None,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        if not causal:
            raise NotImplementedError(
                "non-causal MemLSTM is not ported yet (ROADMAP queue 1)")
        H = hidden_size
        self.h_net = LSTM(H, H, generator=g, **fk)
        self.h_proj = Linear(H, H, generator=g, **fk)
        self.h_norm = LayerNormLast(H, **fk)
        self.c_net = LSTM(H, H, generator=g, **fk)
        self.c_proj = Linear(H, H, generator=g, **fk)
        self.c_norm = LayerNormLast(H, **fk)

    @staticmethod
    def _branch(net, proj, norm, x, states):
        y, new_states = net(x, states)
        return x + norm(proj(y)), new_states

    def forward(self, h, c):
        """Offline. h/c: [N, S, D, H] -> next-block init states [D, N*S, H]
        (segment s gets the memory of segment s-1; segment 0 zeros)."""
        N, S, D, H = h.shape
        h_seq, _ = self._branch(self.h_net, self.h_proj, self.h_norm,
                                h.reshape(N, S, D * H), None)
        c_seq, _ = self._branch(self.c_net, self.c_proj, self.c_norm,
                                c.reshape(N, S, D * H), None)
        outs = []
        for seq in (h_seq, c_seq):
            seq = seq.reshape(N, S, D, H)
            seq = torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], dim=1)
            outs.append(seq.reshape(N * S, D, H).transpose(0, 1))
        return outs[0], outs[1]

    def step(self, h, c, h_states, c_states):
        """Streaming one-segment step. h/c: [B, D, H] final SegLSTM states;
        returns the next SegLSTM init (h', c') [D, B, H] + new internals."""
        B, D, H = h.shape
        h_seq, h_states = self._branch(self.h_net, self.h_proj, self.h_norm,
                                       h.reshape(B, 1, D * H), h_states)
        c_seq, c_states = self._branch(self.c_net, self.c_proj, self.c_norm,
                                       c.reshape(B, 1, D * H), c_states)
        return (h_seq.reshape(B, D, H).transpose(0, 1),
                c_seq.reshape(B, D, H).transpose(0, 1), h_states, c_states)


class SkiM(nn.Module):
    """Causal skipping-memory LSTM masker. x: [N, C, T] -> [N, C_out, T]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 n_blocks: int = 2, seg_size: int = 20, seg_overlap: bool = False,
                 causal: bool = True, embed_dim: int = 0,
                 embed_norm: bool = False, embed_fusion: Optional[str] = None,
                 block_with_embed: Optional[tuple] = None,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if dropout:
            raise NotImplementedError(
                "SkiM dropout is not ported (the flagship trains with 0; "
                "ROADMAP queue 1: the rest of the TSE zoo)")
        if not causal or seg_overlap:
            raise NotImplementedError(
                "non-causal / overlapped-segment SkiM is not ported yet "
                "(ROADMAP queue 1: the rest of the TSE zoo)")
        if embed_dim and embed_fusion.lower() != "film":
            raise NotImplementedError(
                f"SkiM {embed_fusion} fusion is not ported yet (ROADMAP "
                "queues 1-2: Gate fusion and its fused_skim_frames mode)")
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.output_size, self.n_blocks = output_size, n_blocks
        self.seg_size, self.causal = seg_size, causal
        self.embed_dim, self.embed_norm = embed_dim, embed_norm
        self.block_with_embed = tuple(block_with_embed or ())
        self.seg_lstm = nn.ModuleList(
            SegLSTM(input_size, hidden_size, causal, generator=g, **fk)
            for _ in range(n_blocks))
        if embed_dim:
            self.seg_input_fusion = nn.ModuleList(
                FiLM(input_size, embed_dim, input_norm=True, generator=g, **fk)
                if self.block_with_embed[i] else nn.Identity()
                for i in range(n_blocks))
        self.mem_lstm = nn.ModuleList(
            MemLSTM(hidden_size, causal, generator=g, **fk)
            for _ in range(n_blocks - 1))
        self.output_fc = nn.Sequential(
            PReLU(**fk), Conv1d(input_size, output_size, 1, generator=g, **fk))
        self._fw_cache = None

    # ---------------------------------------------------------------- utils
    def _norm_embed(self, embed):
        if self.embed_norm and embed is not None:
            embed = embed / torch.linalg.vector_norm(
                embed, dim=1, keepdim=True).clamp_min(1e-12)
        return embed

    def _has_film(self, i: int) -> bool:
        return bool(self.embed_dim and self.block_with_embed[i])

    def _fuse(self, i, x, embed):
        """x: [B, K, C] feature-last, embed: [B, E]."""
        if embed is not None and self._has_film(i):
            return self.seg_input_fusion[i](x, embed, feature_last=True)
        return x

    # --------------------------------------------------------------- offline
    def forward(self, x: torch.Tensor,
                embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        embed = self._norm_embed(embed)
        N, C, T = x.shape
        K = self.seg_size
        rest = K - T % K  # a whole extra segment when K | T, as the reference
        xt = torch.nn.functional.pad(x.transpose(1, 2), (0, 0, 0, rest))
        S = xt.shape[1] // K
        embed_rep = (embed[:, None, :].expand(N, S, embed.shape[1])
                     .reshape(N * S, -1) if embed is not None else None)
        out = xt.reshape(N * S, K, C)
        h = c = None
        for i in range(self.n_blocks):
            out = self._fuse(i, out, embed_rep)
            out, h, c = self.seg_lstm[i](out, h, c)
            if i < self.n_blocks - 1:
                D = h.shape[0]
                h_n = h.reshape(D, N, S, self.hidden_size).permute(1, 2, 0, 3)
                c_n = c.reshape(D, N, S, self.hidden_size).permute(1, 2, 0, 3)
                h, c = self.mem_lstm[i](h_n, c_n)
        out = out.reshape(N, S * K, C)[:, :T, :]
        return self.output_fc(out.transpose(1, 2))

    # -------------------------------------------------------------- streaming
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Explicit streaming state for `batch` concurrent streams."""
        if device is None:
            device = self.output_fc[1].weight.device
        H = self.hidden_size
        zeros = lambda: torch.zeros((1, batch, H), device=device, dtype=dtype)
        return {
            "seg_h": [zeros() for _ in range(self.n_blocks)],
            "seg_c": [zeros() for _ in range(self.n_blocks)],
            "mem_h": [(zeros(), zeros()) for _ in range(self.n_blocks - 1)],
            "mem_c": [(zeros(), zeros()) for _ in range(self.n_blocks - 1)],
            "frame_count": 0,
        }

    def _blocks_over_frames(self, x, embed, seg_h, seg_c):
        out, new_h, new_c = x, [], []
        for i in range(self.n_blocks):
            out = self._fuse(i, out, embed)
            out, h, c = self.seg_lstm[i](out, seg_h[i], seg_c[i])
            new_h.append(h)
            new_c.append(c)
        return out, new_h, new_c

    def _mem_update(self, state, seg_h, seg_c):
        """Next-segment SegLSTM inits: block 0 zeros, block i+1 the output
        of mem_lstm[i] on block i's final states."""
        next_h, next_c = [torch.zeros_like(seg_h[0])], [torch.zeros_like(seg_c[0])]
        new_mem_h, new_mem_c = [], []
        for i in range(self.n_blocks - 1):
            h_out, c_out, mh, mc = self.mem_lstm[i].step(
                seg_h[i].transpose(0, 1), seg_c[i].transpose(0, 1),
                state["mem_h"][i], state["mem_c"][i])
            next_h.append(h_out)
            next_c.append(c_out)
            new_mem_h.append(mh)
            new_mem_c.append(mc)
        return next_h, next_c, new_mem_h, new_mem_c

    def _advance_clock(self, state, seg_h, seg_c, frames: int) -> dict:
        count = state["frame_count"] + frames
        st = dict(state, seg_h=seg_h, seg_c=seg_c, frame_count=count)
        if count % self.seg_size == 0:
            nh, nc, mh, mc = self._mem_update(st, seg_h, seg_c)
            st = dict(st, seg_h=nh, seg_c=nc, mem_h=mh, mem_c=mc)
        return st

    def step_frames(self, x: torch.Tensor, embed: Optional[torch.Tensor],
                    state: dict):
        """Any number of frames with segment-boundary handling.
        x: [B, F, C] -> ([B, C_out, F], new state)."""
        embed = self._norm_embed(embed)
        ys = []
        for t in range(x.shape[1]):
            y, seg_h, seg_c = self._blocks_over_frames(
                x[:, t:t + 1], embed, state["seg_h"], state["seg_c"])
            state = self._advance_clock(state, seg_h, seg_c, 1)
            ys.append(y)
        y = torch.cat(ys, dim=1)
        return self.output_fc(y.transpose(1, 2)), state

    # ------------------------------------------------- fused streaming (CUDA)
    def _fusion_modes(self):
        return tuple("film" if self._has_film(i) else ""
                     for i in range(self.n_blocks))

    def _fused_weights(self) -> SkimWeights:
        """The kernel's weight tuple, rebuilt only when a parameter changes
        (storage or in-place version), so the per-device packing cached on
        it is reused across ticks."""
        params = list(self.parameters())
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                    for p in params)
        if self._fw_cache is not None and self._fw_cache[0] == key:
            return self._fw_cache[1]
        C = self.input_size
        ws, embed_cols = [], []
        with torch.no_grad():
            for i, mode in enumerate(self._fusion_modes()):
                if mode == "film":
                    film = self.seg_input_fusion[i]
                    w_s = film.cond_scale.weight[:, :, 0]   # [C, C+E]
                    w_b = film.cond_bias.weight[:, :, 0]
                    ws += [w_s[:, :C].T.contiguous(), w_b[:, :C].T.contiguous(),
                           film.norm.weight, film.norm.bias]
                    embed_cols.append(torch.cat([w_s[:, C:], w_b[:, C:]], 0))
                seg = self.seg_lstm[i]
                ws += [seg.lstm.weight_ih_l0.T.contiguous(),
                       seg.lstm.weight_hh_l0.T.contiguous(),
                       seg.lstm.bias_ih_l0 + seg.lstm.bias_hh_l0,
                       seg.proj.weight.T.contiguous(), seg.proj.bias,
                       seg.norm.weight, seg.norm.bias]
            weights = SkimWeights(ws)
            # embed columns of every FiLM block stacked: [E, n_film * 2C]
            weights.embed_w = (torch.cat(embed_cols, 0).T.contiguous()
                               if embed_cols else None)
        self._fw_cache = (key, weights)
        return weights

    def _embed_terms(self, embed, B, dtype, weights: SkimWeights):
        """Frame-invariant FiLM terms se/be [n_blocks, B, C] (zeros for
        unconditioned blocks) and the unused Gate term ge [n_blocks, B, 1]."""
        n, C = self.n_blocks, self.input_size
        dev = weights[0].device
        se = torch.zeros((n, B, C), device=dev, dtype=dtype)
        be = torch.zeros((n, B, C), device=dev, dtype=dtype)
        ge = torch.zeros((n, B, 1), device=dev, dtype=dtype)
        if embed is None or weights.embed_w is None:
            return se, be, ge
        terms = (embed @ weights.embed_w.to(embed.dtype)).to(dtype)
        terms = terms.reshape(B, -1, 2, C).permute(2, 1, 0, 3)  # [2, nf, B, C]
        film = [i for i in range(n) if self._has_film(i)]
        se[film] = terms[0]
        be[film] = terms[1]
        return se, be, ge

    def step_frames_fused(self, x: torch.Tensor, embed: Optional[torch.Tensor],
                          state: dict, dot_dtype=torch.float32):
        """The streaming step through `fused_skim_frames`: the CUDA kernel
        for CUDA tensors, its plain version for CPU tensors. F must divide
        seg_size, so a segment boundary only falls at a chunk's end; the
        MemLSTM update at the boundary runs outside the kernel."""
        B, F, C = x.shape
        if self.seg_size % F:
            raise ValueError(f"chunk frames {F} must divide seg_size "
                             f"{self.seg_size}")
        weights = self._fused_weights()
        embed = self._norm_embed(embed)
        se, be, ge = self._embed_terms(embed, B, x.dtype, weights)
        y, h_out, c_out = fused_skim_frames(
            x.contiguous(), se, be, ge, torch.cat(state["seg_h"], 0),
            torch.cat(state["seg_c"], 0), weights, self._fusion_modes(),
            dot_dtype=dot_dtype)
        state = self._advance_clock(state, list(h_out.split(1)),
                                    list(c_out.split(1)), F)
        return self.output_fc(y.transpose(1, 2)), state

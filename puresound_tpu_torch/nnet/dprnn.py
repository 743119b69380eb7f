"""Dual-path RNN masker with embedding-free TSE conditioning (counterpart of
puresound_tpu/nnet/dprnn.py:23-196).

x [N, C, T] is cut into segments of `seg_size` frames (50 %-overlapped with
`seg_overlap`); each block runs an intra-segment LSTM over the [N*S, K, C]
segments and an inter-segment LSTM over the [N*K, S, C] positions, each
followed by a projection, LayerNorm and the residual. Every scan is the
port's `nnet/lobe/rnn.py` `LSTM`, so on the card each is a
`lstm_scan_train_fp` launch (a non-causal block scans both directions).

Conditioning: FiLM on the d-vector before the blocks that `block_with_embed`
names (`embed_dim` set), or, with `embedding_free_tse` ("veve"), the
enrollment features themselves: the net runs over them and each block's
inter-LSTM final states become the mixture's inter-LSTM initial states
(`_get_hidden_states`). Streaming (`init_state`, `condition_stream_state`,
`step_frames`) carries each block's inter-LSTM (h, c) for every (stream,
intra position); a chunk must be a whole number of segments. Module and
parameter names follow PureSound's (`input_film`, `intra_rnn`, `intra_proj`,
`intra_norm`, `inter_rnn`, `inter_proj`, `inter_norm`, `output_fc`).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..utils.init import generator_or_default
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d
from .lobe.norm import LayerNormLast
from .lobe.rnn import LSTM, Linear
from .lobe.trivial import FiLM, SplitMerge


class DPRNN(nn.Module):
    """x [N, C, T], embed [N, E] (or, embedding-free, enrollment features
    [N, C, T']) -> [N, C_out, T]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 n_blocks: int = 2, seg_size: int = 20, seg_overlap: bool = False,
                 causal: bool = True, embed_dim: int = 0, embed_norm: bool = False,
                 block_with_embed: Optional[tuple] = None,
                 embedding_free_tse: bool = False, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.input_size, self.hidden_size, self.n_blocks = input_size, hidden_size, n_blocks
        self.seg_size, self.seg_overlap, self.causal = seg_size, seg_overlap, causal
        self.embed_dim, self.embed_norm = embed_dim, embed_norm
        self.block_with_embed = tuple(block_with_embed or ())
        self.embedding_free_tse = embedding_free_tse
        D = 1 if causal else 2
        C, H = input_size, hidden_size
        if embed_dim:
            self.input_film = nn.ModuleList(
                FiLM(C, embed_dim, input_norm=True, generator=g, **fk)
                if self.block_with_embed[i] else nn.Identity() for i in range(n_blocks))
        lstms = lambda: nn.ModuleList(LSTM(C, H, bidirectional=not causal, generator=g, **fk)
                                      for _ in range(n_blocks))
        projs = lambda: nn.ModuleList(Linear(D * H, C, generator=g, **fk)
                                      for _ in range(n_blocks))
        norms = lambda: nn.ModuleList(LayerNormLast(C, **fk) for _ in range(n_blocks))
        self.intra_rnn, self.intra_proj, self.intra_norm = lstms(), projs(), norms()
        self.inter_rnn, self.inter_proj, self.inter_norm = lstms(), projs(), norms()
        self.output_fc = nn.Sequential(PReLU(**fk),
                                       Conv1d(C, output_size, 1, generator=g, **fk))

    # ------------------------------------------------------------- helpers
    def _has_film(self, i: int) -> bool:
        return bool(self.embed_dim and self.block_with_embed[i])

    def _segment(self, x):
        """[N, C, T] -> ([N, S, K, C], rest)."""
        if self.seg_overlap:
            return SplitMerge.split(x, self.seg_size)
        N, C, T = x.shape
        rest = self.seg_size - T % self.seg_size
        xt = nn.functional.pad(x.transpose(1, 2), (0, 0, 0, rest))
        return xt.reshape(N, -1, self.seg_size, C), rest

    def _block(self, i, seg, embed_rep, init):
        """Block i on [N, S, K, C] -> ([N, S, K, C], the inter LSTM's
        final (h, c) [D, N*K, H])."""
        N, S, K, C = seg.shape
        out = seg.reshape(N * S, K, C)
        if embed_rep is not None and self._has_film(i):
            out = self.input_film[i](out, embed_rep, feature_last=True)
        intra, _ = self.intra_rnn[i](out)
        out = out + self.intra_norm[i](self.intra_proj[i](intra))
        inter_in = out.reshape(N, S, K, C).transpose(1, 2).reshape(N * K, S, C)
        inter, hid = self.inter_rnn[i](inter_in, init)
        out = inter_in + self.inter_norm[i](self.inter_proj[i](inter))
        return out.reshape(N, K, S, C).transpose(1, 2), hid

    def _run_blocks(self, seg, embed_rep, inter_init):
        hiddens = []
        for i in range(self.n_blocks):
            init = inter_init[i] if inter_init is not None else None
            seg, hid = self._block(i, seg, embed_rep, init)
            hiddens.append(hid)
        return seg, hiddens

    def _norm_embed(self, embed):
        if self.embed_norm:
            embed = embed / torch.linalg.vector_norm(embed, dim=1, keepdim=True).clamp_min(1e-12)
        return embed

    def _get_hidden_states(self, enroll_feats) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Each block's inter-LSTM final (h, c) over the enrollment features
        [N, C, T'] (the embedding-free conditioning, JAX `:121-127`)."""
        seg, _ = self._segment(enroll_feats)
        return self._run_blocks(seg, None, None)[1]

    # ------------------------------------------------------------- offline
    def forward(self, x: torch.Tensor, embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        N, C, T = x.shape
        inter_init = embed_rep = None
        if self.embedding_free_tse:
            if embed is None or embed.dim() != 3:
                raise ValueError("embedding-free TSE needs enrollment features [N, C, T']")
            inter_init = self._get_hidden_states(embed)
        seg, rest = self._segment(x)
        S = seg.shape[1]
        if embed is not None and not self.embedding_free_tse:
            embed = self._norm_embed(embed)
            embed_rep = embed[:, None, :].expand(N, S, embed.shape[1]).reshape(N * S, -1)
        out, _ = self._run_blocks(seg, embed_rep, inter_init)
        if self.seg_overlap:
            out = SplitMerge.merge(out, rest)
        else:
            out = out.reshape(N, -1, C)[:, :T, :].transpose(1, 2)
        return self.output_fc(out)

    # ----------------------------------------------------------- streaming
    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Each block's inter-LSTM (h, c), one pair per (stream, intra
        position): [1, batch * seg_size, H]. The intra LSTM restarts every
        segment, so it carries nothing."""
        if not self.causal or self.seg_overlap:
            raise ValueError("streaming needs a causal DPRNN over non-overlapped segments "
                             "(JAX asserts it, puresound_tpu/nnet/dprnn.py:148)")
        if device is None:
            device = self.output_fc[1].weight.device
        z = lambda: torch.zeros((1, batch * self.seg_size, self.hidden_size),
                                device=device, dtype=dtype)
        return {"h": [z() for _ in range(self.n_blocks)],
                "c": [z() for _ in range(self.n_blocks)]}

    def condition_stream_state(self, state: dict, enroll_feats: torch.Tensor) -> dict:
        """The embedding-free conditioning written into a fresh stream
        state: each block's inter (h, c) from the enrollment features."""
        hiddens = self._get_hidden_states(enroll_feats.to(state["h"][0].dtype))
        return dict(state, h=[h for h, _ in hiddens], c=[c for _, c in hiddens])

    def chunk_frames_ok(self, frames: int) -> bool:
        return frames % self.seg_size == 0

    def step_frames(self, x: torch.Tensor, embed: Optional[torch.Tensor], state: dict):
        """A chunk of frames x [B, T, C], T a multiple of seg_size -> (mask
        frames [B, C_out, T], the new state); equal to the offline forward on
        segment-aligned input. An embedding-free model ignores `embed`: its
        conditioning is in the state (`condition_stream_state`)."""
        B, T, C = x.shape
        K = self.seg_size
        if T % K:
            raise ValueError(f"a DPRNN chunk must be a whole number of segments: "
                             f"{T} frames, seg_size {K}")
        S = T // K
        embed_rep = None
        if embed is not None and not self.embedding_free_tse:
            embed = self._norm_embed(embed)
            embed_rep = embed[:, None, :].expand(B, S, embed.shape[1]).reshape(B * S, -1)
        out, hs, cs = x.reshape(B, S, K, C), [], []
        for i in range(self.n_blocks):
            out, (h, c) = self._block(i, out, embed_rep, (state["h"][i], state["c"][i]))
            hs.append(h)
            cs.append(c)
        out = out.reshape(B, T, C).transpose(1, 2)
        return self.output_fc(out), dict(state, h=hs, c=cs)

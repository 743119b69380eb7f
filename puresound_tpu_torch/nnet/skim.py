"""SkiM — Skipping-Memory LSTM (counterpart of puresound_tpu/nnet/skim.py).

SkiM with FiLM, Gate (or no) conditioning, causal or not, with or without
50 %-overlapped segments (`SplitMerge`) and dropout: the offline forward
(`skim.py:236`), differentiable, with every SegLSTM / MemLSTM scan through
a training LSTM kernel (`nnet/lobe/rnn.py`; a non-causal block scans both
directions, the backward one with `reverse=True`; the SegLSTM finals feed
MemLSTM, and its outputs the next block's h0/c0, gradients included); the
explicit streaming state (`init_state` `:293`); the segment step
(`step_chunk` `:345`: one scan of seg_size frames a block, then the
MemLSTM update); the per-frame streaming step (`step_frames` `:384`); and
the fused streaming step
(`step_frames_fused` `:523`) that runs the block stack through
`ops.skim_stream_kernel.fused_skim_frames`. Only a causal SkiM streams:
`init_state` and `step_frames_fused` raise a ValueError for a non-causal
one, as JAX asserts (`:539`); `step_chunk` also for a chunk that is not
one segment or a clock not at a segment boundary, the preconditions JAX
documents (`:347-351`). Module and parameter names follow PureSound
(`seg_lstm`, `mem_lstm`, `seg_input_fusion`, `output_fc`), so its
checkpoints load as they are.

The streaming state keeps the JAX pytree's keys; its shared segment clock
`frame_count` is a host int, so the eager segment-boundary test never reads
the device. `step_chunk` advances it by seg_size (JAX's leaves it), so that
`step_chunk` and `step_frames` can take turns on one stream at segment
boundaries. A 0-d tensor clock (the exported StreamStep's) takes the
boundary through the `cond` operator instead.

`TM_BLOCKS` (JAX's `PURESOUND_TM_BLOCKS`, default off, read at import)
runs the offline block stack of non-overlapped segments time-major,
[K, N*S, C]: one transpose in and one out, with `SegLSTM.call_tm` and
`LSTM.call_tm` in between (`skim.py:42`, `:258-283`). The math is the same;
tests set the module attribute.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn
from torch.func import functional_call
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops.quant import quantize_cols
from ..ops.skim_stream_kernel import SkimWeights, fused_skim_frames
from ..utils.init import generator_or_default
from .lobe.activation import PReLU
from .lobe.cnn import Conv1d
from .lobe.dropout import Dropout
from .lobe.norm import LayerNormLast
from .lobe.rnn import LSTM, Linear
from .lobe.trivial import FiLM, Gate, SplitMerge

#: run the offline block stack time-major (JAX `skim.py:42`)
TM_BLOCKS = os.environ.get("PURESOUND_TM_BLOCKS", "0") != "0"
#: the Gate width of a Gate-conditioned SkiM, fixed as in JAX (`skim.py:192-194`)
GATE_HIDDEN = 128


class SegLSTM(nn.Module):
    """Intra-segment LSTM (bidirectional when not causal) + dropout +
    projection + LayerNorm residual.

    forward(x [B, K, C], h [D, B, H], c [D, B, H]) -> (y, h', c').
    """

    def __init__(self, input_size: int, hidden_size: int, causal: bool = True,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.hidden_size, self.num_directions = hidden_size, 1 if causal else 2
        self.lstm = LSTM(input_size, hidden_size, bidirectional=not causal,
                         generator=g, **fk)
        self.drop = Dropout(dropout, generator=g)
        self.proj = Linear(self.num_directions * hidden_size, input_size, generator=g, **fk)
        self.norm = LayerNormLast(input_size, **fk)

    def _zeros(self, x, h, B):
        return h if h is not None else x.new_zeros((self.num_directions, B, self.hidden_size))

    def forward(self, x, h=None, c=None):
        B = x.shape[0]
        y, (h, c) = self.lstm(x, (self._zeros(x, h, B), self._zeros(x, c, B)))
        return x + self.norm(self.proj(self.drop(y))), h, c

    def call_tm(self, x_t, h=None, c=None):
        """Time-major forward: x_t [K, B, C] (JAX `skim.py:75-89`); the
        dropout, projection, norm and residual act on the last axis."""
        B = x_t.shape[1]
        y, (h, c) = self.lstm.call_tm(x_t, (self._zeros(x_t, h, B), self._zeros(x_t, c, B)))
        return x_t + self.norm(self.proj(self.drop(y))), h, c


class MemLSTM(nn.Module):
    """Inter-segment memory LSTM over SegLSTM (h, c) states: causal (input
    H, one direction, the memory shifted one segment) or not (input 2H, both
    directions, no shift); dropout after each net (JAX `skim.py:92-158`)."""

    def __init__(self, hidden_size: int, causal: bool = True, dropout: float = 0.0, *,
                 device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.causal = causal
        H, C = hidden_size, hidden_size if causal else 2 * hidden_size
        for b in ("h", "c"):
            setattr(self, f"{b}_net", LSTM(C, H, bidirectional=not causal, generator=g, **fk))
            setattr(self, f"{b}_drop", Dropout(dropout, generator=g))
            setattr(self, f"{b}_proj", Linear(C, C, generator=g, **fk))
            setattr(self, f"{b}_norm", LayerNormLast(C, **fk))

    def _branch(self, b, x, states):
        y, new_states = getattr(self, f"{b}_net")(x, states)
        y = getattr(self, f"{b}_proj")(getattr(self, f"{b}_drop")(y))
        return x + getattr(self, f"{b}_norm")(y), new_states

    def forward(self, h, c):
        """Offline. h/c: [N, S, D, H] -> next-block init states [D, N*S, H]
        (causal: segment s gets the memory of segment s-1, segment 0 zeros)."""
        N, S, D, H = h.shape
        h_seq, _ = self._branch("h", h.reshape(N, S, D * H), None)
        c_seq, _ = self._branch("c", c.reshape(N, S, D * H), None)
        outs = []
        for seq in (h_seq, c_seq):
            seq = seq.reshape(N, S, D, H)
            if self.causal:
                seq = torch.cat([torch.zeros_like(seq[:, :1]), seq[:, :-1]], dim=1)
            outs.append(seq.reshape(N * S, D, H).transpose(0, 1))
        return outs[0], outs[1]

    def step(self, h, c, h_states, c_states):
        """Streaming one-segment step. h/c: [B, D, H] final SegLSTM states;
        returns the next SegLSTM init (h', c') [D, B, H] + new internals."""
        B, D, H = h.shape
        h_seq, h_states = self._branch("h", h.reshape(B, 1, D * H), h_states)
        c_seq, c_states = self._branch("c", c.reshape(B, 1, D * H), c_states)
        return (h_seq.reshape(B, D, H).transpose(0, 1),
                c_seq.reshape(B, D, H).transpose(0, 1), h_states, c_states)


class _MemUpdate(nn.Module):
    """SkiM's segment-boundary update over its MemLSTMs (held, not owned:
    built on the fly, it adds no names to SkiM's state_dict)."""

    def __init__(self, mem_lstm: nn.ModuleList):
        super().__init__()
        self.mem_lstm = mem_lstm

    def forward(self, seg_h, seg_c, mem_h, mem_c):
        """Next-segment SegLSTM inits: block 0 zeros, block i+1 the output
        of mem_lstm[i] on block i's final states; and the new MemLSTM
        states."""
        next_h, next_c = [torch.zeros_like(seg_h[0])], [torch.zeros_like(seg_c[0])]
        new_mem_h, new_mem_c = [], []
        for i, mem in enumerate(self.mem_lstm):
            h_out, c_out, mh, mc = mem.step(seg_h[i].transpose(0, 1),
                                            seg_c[i].transpose(0, 1), mem_h[i], mem_c[i])
            next_h.append(h_out)
            next_c.append(c_out)
            new_mem_h.append(tuple(mh))
            new_mem_c.append(tuple(mc))
        return next_h, next_c, new_mem_h, new_mem_c


class SkiM(nn.Module):
    """Skipping-memory LSTM masker. x: [N, C, T] -> [N, C_out, T]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 n_blocks: int = 2, seg_size: int = 20, seg_overlap: bool = False,
                 causal: bool = True, embed_dim: int = 0,
                 embed_norm: bool = False, embed_fusion: Optional[str] = None,
                 block_with_embed: Optional[tuple] = None,
                 dropout: float = 0.0, *, device=None, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if embed_dim and embed_fusion.lower() not in ("film", "gate"):
            raise NameError(embed_fusion)
        fk = dict(device=device, dtype=dtype)
        g = generator_or_default(generator)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.output_size, self.n_blocks = output_size, n_blocks
        self.seg_size, self.causal, self.seg_overlap = seg_size, causal, seg_overlap
        self.embed_dim, self.embed_norm = embed_dim, embed_norm
        self.embed_fusion = embed_fusion.lower() if embed_dim else None
        self.block_with_embed = tuple(block_with_embed or ())
        self.seg_lstm = nn.ModuleList(
            SegLSTM(input_size, hidden_size, causal, dropout, generator=g, **fk)
            for _ in range(n_blocks))
        if embed_dim:
            fusion = lambda: (
                FiLM(input_size, embed_dim, input_norm=True, generator=g, **fk)
                if self.embed_fusion == "film" else
                Gate(input_size, GATE_HIDDEN, embed_dim, generator=g, **fk))
            self.seg_input_fusion = nn.ModuleList(
                fusion() if self.block_with_embed[i] else nn.Identity()
                for i in range(n_blocks))
        self.mem_lstm = nn.ModuleList(
            MemLSTM(hidden_size, causal, dropout, generator=g, **fk)
            for _ in range(n_blocks - 1))
        self.output_fc = nn.Sequential(
            PReLU(**fk), Conv1d(input_size, output_size, 1, generator=g, **fk))
        self._fw_cache = {}    # (int8_hh, int8_full) -> (parameter key, weights)

    # ---------------------------------------------------------------- utils
    def _norm_embed(self, embed):
        if self.embed_norm and embed is not None:
            embed = embed / torch.linalg.vector_norm(
                embed, dim=1, keepdim=True).clamp_min(1e-12)
        return embed

    def _has_embed(self, i: int) -> bool:
        return bool(self.embed_dim and self.block_with_embed[i])

    def _fuse(self, i, x, embed, batch_axis: int = 0):
        """x: [B, K, C] (batch_axis 0) or time-major [K, B, C] (batch_axis
        1), embed: [B, E] -> fused, in x's layout (JAX `skim.py:212-228`).
        FiLM runs feature-last; Gate on [B, C, K]."""
        if embed is None or not self._has_embed(i):
            return x
        fusion = self.seg_input_fusion[i]
        if batch_axis == 1:
            x = x.transpose(0, 1)
        if isinstance(fusion, FiLM):
            y = fusion(x, embed, feature_last=True)
        else:
            y = fusion(x.transpose(1, 2), embed).transpose(1, 2)
        return y.transpose(0, 1) if batch_axis == 1 else y

    # --------------------------------------------------------------- offline
    def forward(self, x: torch.Tensor,
                embed: Optional[torch.Tensor] = None) -> torch.Tensor:
        embed = self._norm_embed(embed)
        N, C, T = x.shape
        K = self.seg_size
        if self.seg_overlap:
            seg, rest = SplitMerge.split(x, K)         # [N, S, K, C]
        else:
            rest = K - T % K  # a whole extra segment when K | T, as the reference
            seg = torch.nn.functional.pad(x.transpose(1, 2), (0, 0, 0, rest))
        S = seg.numel() // (N * K * C)
        embed_rep = (embed[:, None, :].expand(N, S, embed.shape[1])
                     .reshape(N * S, -1) if embed is not None else None)
        out = seg.reshape(N * S, K, C)
        tm = TM_BLOCKS and not self.seg_overlap    # the stack time-major: [K, N*S, C]
        if tm:
            out = out.transpose(0, 1)
        h = c = None
        for i in range(self.n_blocks):
            out = self._fuse(i, out, embed_rep, batch_axis=int(tm))
            seg = self.seg_lstm[i]
            out, h, c = seg.call_tm(out, h, c) if tm else seg(out, h, c)
            if i < self.n_blocks - 1:
                D = h.shape[0]
                h_n = h.reshape(D, N, S, self.hidden_size).permute(1, 2, 0, 3)
                c_n = c.reshape(D, N, S, self.hidden_size).permute(1, 2, 0, 3)
                h, c = self.mem_lstm[i](h_n, c_n)
        if tm:
            out = out.transpose(0, 1)
        if self.seg_overlap:
            return self.output_fc(SplitMerge.merge(out.reshape(N, S, K, C), rest))
        out = out.reshape(N, S * K, C)[:, :T, :]
        return self.output_fc(out.transpose(1, 2))

    # -------------------------------------------------------------- streaming
    def _check_streams(self):
        if not self.causal or self.seg_overlap:
            raise ValueError("streaming needs a causal SkiM over non-overlapped segments "
                             "(JAX asserts it, puresound_tpu/nnet/skim.py:539)")

    def init_state(self, batch: int, dtype=torch.float32, device=None) -> dict:
        """Explicit streaming state for `batch` concurrent streams."""
        self._check_streams()
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
        return _MemUpdate(self.mem_lstm)(seg_h, seg_c, state["mem_h"], state["mem_c"])

    def _advance_clock(self, state, seg_h, seg_c, frames: int) -> dict:
        count = state["frame_count"] + frames
        st = dict(state, seg_h=seg_h, seg_c=seg_c, frame_count=count)
        if isinstance(count, torch.Tensor):
            return self._advance_tensor_clock(st, count)
        if count % self.seg_size == 0:
            nh, nc, mh, mc = self._mem_update(st, seg_h, seg_c)
            st = dict(st, seg_h=nh, seg_c=nc, mem_h=mh, mem_c=mc)
        return st

    def _advance_tensor_clock(self, st: dict, count: torch.Tensor) -> dict:
        """The segment boundary on a 0-d tensor clock (the exported
        StreamStep's, `utils.export.stream_state`): the `cond` operator keeps
        both branches in a traced graph, where a host int would freeze one
        (JAX carries a device int32 and takes `lax.cond`, `skim.py:368-381`).
        The operator takes and returns flat tensors, the MemLSTM weights
        among its operands (`functional_call`); called directly it traces its
        branches without `torch.cond`'s compile step."""
        update = _MemUpdate(self.mem_lstm)
        names, weights = zip(*update.named_parameters()) if self.n_blocks > 1 else ((), ())
        # detached: an operand that requires grad sends the operator through
        # its autograd path, which traces a backward at every call
        weights = [w.detach() for w in weights]
        flat, spec = tree_flatten((st["seg_h"], st["seg_c"], st["mem_h"], st["mem_c"]))
        n = len(flat)

        def boundary(*operands):
            state = tree_unflatten(list(operands[:n]), spec)
            out = functional_call(update, dict(zip(names, operands[n:])), state)
            return tuple(tree_flatten(out)[0])

        def carry(*operands):
            # a branch returns no alias of its operands
            return tuple(t.clone() for t in operands[:n])

        out = torch.ops.higher_order.cond(count % self.seg_size == 0, boundary, carry,
                                          (*flat, *weights))
        nh, nc, mh, mc = tree_unflatten(list(out), spec)
        return dict(st, seg_h=list(nh), seg_c=list(nc), mem_h=[tuple(m) for m in mh],
                    mem_c=[tuple(m) for m in mc])

    def step_chunk(self, x: torch.Tensor, embed: Optional[torch.Tensor],
                   state: dict):
        """Exactly one segment: x [B, K, C] with K == seg_size, the clock at
        a segment boundary -> ([B, C_out, K], new state). Each block's
        SegLSTM scans the K frames in one call (one `lstm_scan_train_fp`
        launch of B rows x K steps on a CUDA tensor); the MemLSTM update
        follows, and the clock advances by K."""
        self._check_streams()
        K = x.shape[1]
        if K != self.seg_size:
            raise ValueError(f"step_chunk takes one segment of {self.seg_size} frames, "
                             f"not {K}")
        if int(state["frame_count"]) % K:
            raise ValueError(f"step_chunk needs the clock at a segment boundary; it is "
                             f"at frame {int(state['frame_count'])}")
        embed = self._norm_embed(embed)
        y, seg_h, seg_c = self._blocks_over_frames(x, embed, state["seg_h"], state["seg_c"])
        return self.output_fc(y.transpose(1, 2)), self._advance_clock(state, seg_h, seg_c, K)

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
        return tuple(self.embed_fusion if self._has_embed(i) else ""
                     for i in range(self.n_blocks))

    def _fused_weights(self, int8_hh: bool = False,
                       int8_full: bool = False) -> SkimWeights:
        """The kernel's weight tuple (JAX's `_fused_weights`,
        puresound_tpu/nnet/skim.py:414-480): int8_hh replaces each w_hh by
        (int8 per-column weights, column scales) from `quantize_cols`;
        int8_full also wsx / wbx / w_ih / proj_w; a Gate block's ten arrays
        stay float. Each option's tuple is rebuilt only when a parameter
        (the Gates' included) changes (storage or in-place version), so the
        per-device packing cached on it is reused across ticks."""
        int8_hh = int8_hh or int8_full
        params = list(self.parameters())
        key = tuple((p.data_ptr(), p._version, p.dtype, p.device)
                    for p in params)
        cached = self._fw_cache.get((int8_hh, int8_full))
        if cached is not None and cached[0] == key:
            return cached[1]
        C = self.input_size
        ws, embed_cols, gate_cols = [], [], []
        q = lambda w, on: list(quantize_cols(w)) if on else [w.contiguous()]
        with torch.no_grad():
            for i, mode in enumerate(self._fusion_modes()):
                if mode == "film":
                    film = self.seg_input_fusion[i]
                    w_s = film.cond_scale.weight[:, :, 0]   # [C, C+E]
                    w_b = film.cond_bias.weight[:, :, 0]
                    ws += (q(w_s[:, :C].T, int8_full) + q(w_b[:, :C].T, int8_full)
                           + [film.norm.weight, film.norm.bias])
                    embed_cols.append(torch.cat([w_s[:, C:], w_b[:, C:]], 0))
                elif mode == "gate":   # JAX skim.py:446-463
                    gate = self.seg_input_fusion[i]
                    Hd = gate.hidden_size
                    w = lambda conv: conv.weight[:, :, 0]
                    left, right = gate.left_conv, gate.right_conv
                    ws += [w(gate.in_conv).T.contiguous(), w(left[0]).T.contiguous(),
                           left[1].gamma, left[1].beta, left[2].weight,
                           w(right[0])[:, :Hd].T.contiguous(), right[1].gamma,
                           right[1].beta, right[2].weight,
                           w(gate.out_conv).T.contiguous()]
                    gate_cols.append(w(right[0])[:, Hd:])   # [Hd, E]
                seg = self.seg_lstm[i]
                ws += (q(seg.lstm.weight_ih_l0.T, int8_full)
                       + q(seg.lstm.weight_hh_l0.T, int8_hh)
                       + [seg.lstm.bias_ih_l0 + seg.lstm.bias_hh_l0]
                       + q(seg.proj.weight.T, int8_full)
                       + [seg.proj.bias, seg.norm.weight, seg.norm.bias])
            weights = SkimWeights(ws)
            # embed columns of every FiLM block stacked: [E, n_film * 2C];
            # of every Gate block's right_conv: [E, n_gate * Hd]
            stack = lambda cols: torch.cat(cols, 0).T.contiguous() if cols else None
            weights.embed_w = stack(embed_cols)
            weights.gate_embed_w = stack(gate_cols)
        self._fw_cache[(int8_hh, int8_full)] = (key, weights)
        return weights

    def _embed_terms(self, embed, B, dtype, weights: SkimWeights):
        """Frame-invariant conditioning terms (JAX `skim.py:487-520`): FiLM
        se/be [n_blocks, B, C] and Gate ge [n_blocks, B, Hg] (right_conv's
        embed columns on the d-vector), zeros for the other blocks; Hg = 1
        when no block is a Gate. Every Gate block is GATE_HIDDEN wide, the
        one width the kernel takes (`_pack_gate` checks the weights)."""
        n, C = self.n_blocks, self.input_size
        modes = self._fusion_modes()
        Hg = GATE_HIDDEN if "gate" in modes else 1
        dev = weights[0].device
        se = torch.zeros((n, B, C), device=dev, dtype=dtype)
        be = torch.zeros((n, B, C), device=dev, dtype=dtype)
        ge = torch.zeros((n, B, Hg), device=dev, dtype=dtype)
        if embed is None:
            return se, be, ge
        if weights.embed_w is not None:
            terms = (embed @ weights.embed_w.to(embed.dtype)).to(dtype)
            terms = terms.reshape(B, -1, 2, C).permute(2, 1, 0, 3)  # [2, nf, B, C]
            film = [i for i in range(n) if modes[i] == "film"]
            se[film] = terms[0]
            be[film] = terms[1]
        if weights.gate_embed_w is not None:
            terms = (embed @ weights.gate_embed_w.to(embed.dtype)).to(dtype)
            ge[[i for i in range(n) if modes[i] == "gate"]] = (
                terms.reshape(B, -1, Hg).transpose(0, 1))        # [ng, B, Hg]
        return se, be, ge

    def step_frames_fused(self, x: torch.Tensor, embed: Optional[torch.Tensor],
                          state: dict, dot_dtype=torch.float32,
                          int8_hh: bool = False, int8_full: bool = False):
        """The streaming step through `fused_skim_frames`: the CUDA kernel
        for CUDA tensors, its plain version for CPU tensors. F must divide
        seg_size, so a segment boundary only falls at a chunk's end; the
        MemLSTM update at the boundary runs outside the kernel. int8_hh /
        int8_full quantize the kernel's products as JAX's do (`:526-554`)."""
        self._check_streams()
        B, F, C = x.shape
        if self.seg_size % F:
            raise ValueError(f"chunk frames {F} must divide seg_size "
                             f"{self.seg_size}")
        weights = self._fused_weights(int8_hh, int8_full)
        embed = self._norm_embed(embed)
        se, be, ge = self._embed_terms(embed, B, x.dtype, weights)
        y, h_out, c_out = fused_skim_frames(
            x.contiguous(), se, be, ge, torch.cat(state["seg_h"], 0),
            torch.cat(state["seg_c"], 0), weights, self._fusion_modes(),
            dot_dtype=dot_dtype, int8_hh=int8_hh, int8_full=int8_full)
        state = self._advance_clock(state, list(h_out.split(1)),
                                    list(c_out.split(1)), F)
        return self.output_fc(y.transpose(1, 2)), state

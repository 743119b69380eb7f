"""The wide-center masker: CUDA wrapper + plain versions.

Counterpart of puresound_tpu/ops/masker_kernel.py (`_wide_call` `:418`,
pallas_call at `:468`; entries `center_chunk` `:489` and
`dparn_center_chunk` `:536`). One call runs the six stride-1 inner layers
of a DPCRN / DPARN masker for a chunk of K frames of B streams, all at the
bottleneck's F frequencies:

  d2 -> d3 -> d4    causal convs (freq kernel 3, time kernel 2): per output
                    frame six shared-weight [C_in, C_out] products over the
                    frequency taps fo-1..fo+1 of the previous and the current
                    frame; BatchNorm folded into the weights; PReLU
  bottleneck        DPCRN: both dual-path blocks (`dual_path_chunk`'s
                    math); DPARN: per block the attention intra pass added to
                    its input, then the inter LSTM section
  u0 -> u1 -> u2    transpose convs: the time taps flipped in the weights,
                    the frequency relation inverted (in fo+1-df), each with an
                    h part and a skip part (d4, d3, d2 outputs) so the stock
                    path's channel concat never exists

x is the d1 output [F, K, B, C0], y the u2 output [F, K, B, yC]. The 11
carries ([F, B, C] each) are the previous frame of each layer's input: dc
(d2, d3, d4 inputs, doubling as the u2 / u1 skip carries), u0h / u0s (u0's h
and skip), u1h, u2h, then the inter LSTM's h1, h2, c1, c2. Numerics are
JAX's: every dot rounds its operands to `dot_dtype` and sums in float32; the
stage outputs between layers are rounded to the dot dtype (`scr_dt` `:454`),
the d4 output and the bottleneck stay float32 (`x_scr`); y comes back in x's
dtype and the carries in theirs. `conv_weights` is
DualPathStreaming._mk_conv_weights' flat list (66: per down layer W[6],
bias, alpha; per up layer Wh[6], Ws[6], bias, alpha).

`int8_hh` (`center_chunk` only: JAX asserts DPARN has none,
puresound_tpu/nnet/dparn.py:181) runs the DPCRN bottleneck's recurrent
products in int8 as `dual_path_chunk` does (21 weights a block, `n_pb`
`:525`). `xscr_half` stores the bottleneck activation `x_scr` in bfloat16
(`:455`): the d4 output is rounded into it, every residual write rounds, the
u0 h carry enters it rounded, and u0 reads it as its h part.

Dispatch: a CPU tensor runs the plain version; a CUDA tensor launches
`csrc/masker.cu` (built with nvcc at first use) or raises. `conv_plan` picks
each conv's route before the launch (resident bf16 weights on the tensor
cores, else the CUDA-core loop), `dparn_attention_kernel.plan` the DPARN
attention passes'; the C entry computes both again and refuses a plan that
differs. JAX's `b_tile` and its `fc` / `rc` /
`n_ichunk` chunkings are TPU tilings with the same numbers and have no
counterpart; the banded weight builders (`build_layer_blocks`,
`pack_channel_perm`, `_dense_conv_matrix`) are on no path yet.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence

import torch
import torch.nn.functional as Fn

from . import dparn_attention_kernel as dak
from .dparn_attention_kernel import N_WEIGHTS as N_ATTN
from .dparn_attention_kernel import aligned, as_views, check_geometry, check_weights
from .dparn_attention_kernel import intra_core_ref, strides_of
from . import dual_path_kernel as dpk
from .dual_path_kernel import INTER_NAMES, block_names, dual_path_chunk_ref, half_store
from .dual_path_kernel import inter_block_ref, kernel_weights
from .hardware import H100_SMS, SMEM_MAX, sm_count
from .lstm_scan_kernel import _rounder
from .quant import option_key

#: kernel launches since the caller last set it to 0 (one per `_launch`)
LAUNCHES = 0
#: the same launches by option ("" for none; "int8_hh", "xscr_half", ...)
LAUNCHES_BY_OPTION: dict = {}
#: the same launches by path: "attn=<dparn_attention_kernel.plan path>,conv=
#: <the convs' weights, '+'-joined where they differ>" ("conv=..." for DPCRN)
LAUNCHES_BY_PATH: dict = {}

N_CONV = 6                        # (2 time slots) x (3 freq taps)
N_DOWN = N_UP = 3
N_CONV_WEIGHTS = N_DOWN * (N_CONV + 2) + N_UP * (2 * N_CONV + 2)
DPARN_PER_BLOCK = N_ATTN + len(INTER_NAMES)

_KDT = {torch.float32: 0, torch.bfloat16: 1}


def parse_conv_weights(ws: Sequence[torch.Tensor]):
    """([(W[6], bias, alpha)] x 3 down, [(Wh[6], Ws[6], bias, alpha)] x 3 up)."""
    if len(ws) != N_CONV_WEIGHTS:
        raise ValueError(f"{N_CONV_WEIGHTS} conv weights expected, got {len(ws)}")
    it = iter(ws)
    nxt = lambda n: [next(it) for _ in range(n)]
    down = [(nxt(N_CONV), next(it), next(it)) for _ in range(N_DOWN)]
    up = [(nxt(N_CONV), nxt(N_CONV), next(it), next(it)) for _ in range(N_UP)]
    return down, up


def conv_stage_ref(h, s, Wh, Ws, bias, alpha, kind: str, rnd):
    """One fused layer on stages [F, K + 1, B, C] (the carried frame first):
    out[fo, k] = PReLU(bias + sum_{t, df} h[f_in, k + t] @ Wh[3t + df] (+ the
    skip part)), f_in = fo - 1 + df ('conv') or fo + 1 - df ('tconv')."""
    F, K = h.shape[0], h.shape[1] - 1
    cdt = h.dtype
    pad = lambda a: Fn.pad(a, (0, 0, 0, 0, 0, 0, 1, 1))
    hp = pad(h)
    sp = pad(s) if s is not None else None
    acc = bias.to(cdt)
    for t in range(2):
        for df in range(3):
            f0 = df if kind == "conv" else 2 - df
            acc = acc + rnd(hp[f0:f0 + F, t:t + K]) @ rnd(Wh[3 * t + df])
            if sp is not None:
                acc = acc + rnd(sp[f0:f0 + F, t:t + K]) @ rnd(Ws[3 * t + df])
    a = alpha.to(cdt).reshape(())
    return torch.where(acc >= 0, acc, a * acc)


def _wide_ref(x, dc, u0h, u0s, u1h, u2h, conv_weights, bottleneck, dot_dtype,
              xscr_half: bool = False):
    """The conv envelope around `bottleneck(d4_out) -> out`, all in the
    compute dtype: (y, [dc'], u0h', u0s', u1h', u2h'). xscr_half: the u0 h
    carry enters the bfloat16 scratch, so it is rounded to it."""
    cdt, rnd = _rounder(x.dtype, dot_dtype)
    if xscr_half:
        u0h = half_store(cdt)(u0h.to(cdt))
    stage = lambda frames, carry: torch.cat([carry.to(cdt)[:, None], frames], dim=1)
    (down, up) = parse_conv_weights(conv_weights)
    x_st = stage(rnd(x.to(cdt)), rnd(dc[0].to(cdt)))
    d2_st = stage(rnd(conv_stage_ref(x_st, None, down[0][0], None, *down[0][1:],
                                     "conv", rnd)), rnd(dc[1].to(cdt)))
    d3_st = stage(rnd(conv_stage_ref(d2_st, None, down[1][0], None, *down[1][1:],
                                     "conv", rnd)), rnd(dc[2].to(cdt)))
    d4 = conv_stage_ref(d3_st, None, down[2][0], None, *down[2][1:], "conv", rnd)
    xb = bottleneck(d4)
    u0_in, u0_skip = stage(xb, u0h), stage(rnd(d4), rnd(u0s.to(cdt)))
    u0 = rnd(conv_stage_ref(u0_in, u0_skip, *up[0], "tconv", rnd))
    u1_in = stage(u0, rnd(u1h.to(cdt)))
    u1 = rnd(conv_stage_ref(u1_in, d3_st, *up[1], "tconv", rnd))
    u2_in = stage(u1, rnd(u2h.to(cdt)))
    y = conv_stage_ref(u2_in, d2_st, *up[2], "tconv", rnd)
    last = lambda st, like: st[:, -1].to(like.dtype)
    dc_out = [last(st, c) for st, c in zip((x_st, d2_st, d3_st), dc)]
    return (y.to(x.dtype), dc_out, last(u0_in, u0h), last(u0_skip, u0s),
            last(u1_in, u1h), last(u2_in, u2h))


def center_chunk_ref(x, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights, dp_weights,
                     dot_dtype=torch.float32, int8_hh: bool = False,
                     xscr_half: bool = False):
    """Plain DPCRN wide center: (y, dc', u0h', u0s', u1h', u2h', h', c')."""
    carries = {}

    def bottleneck(d4):
        y, carries["h"], carries["c"] = dual_path_chunk_ref(d4, h_in, c_in, dp_weights,
                                                            dot_dtype, int8_hh, xscr_half)
        return y

    out = _wide_ref(x, dc, u0h, u0s, u1h, u2h, conv_weights, bottleneck, dot_dtype,
                    xscr_half)
    return (*out, carries["h"], carries["c"])


def dparn_center_chunk_ref(x, pe, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights,
                           block_weights, heads: int, dot_dtype=torch.float32,
                           xscr_half: bool = False):
    """Plain DPARN wide center: (y, dc', u0h', u0s', u1h', u2h', h', c')."""
    cdt, rnd = _rounder(x.dtype, dot_dtype)
    store = half_store(cdt) if xscr_half else (lambda a: a)
    h_out: List[torch.Tensor] = []
    c_out: List[torch.Tensor] = []

    def bottleneck(xs):
        F, K, B, CH = xs.shape
        xs = store(xs)
        for b in range(len(h_in)):
            w = list(block_weights[b * DPARN_PER_BLOCK:(b + 1) * DPARN_PER_BLOCK])
            rows = xs.permute(1, 2, 0, 3).reshape(K * B, F, CH)
            rows = store(rows + intra_core_ref(rows, pe.to(xs.dtype), w[:N_ATTN], heads, rnd))
            xs = rows.reshape(K, B, F, CH).permute(2, 0, 1, 3)
            xs, h, c = inter_block_ref(xs, h_in[b], c_in[b], w[N_ATTN:], rnd, store=store)
            h_out.append(h.to(h_in[b].dtype))
            c_out.append(c.to(c_in[b].dtype))
        return xs

    out = _wide_ref(x, dc, u0h, u0s, u1h, u2h, conv_weights, bottleneck, dot_dtype,
                    xscr_half)
    return (*out, h_out, c_out)


# -------------------------------------------------------------------- plan
TC_TM = 128                  # rows a tile on the tensor cores, or half (csrc/masker.cu)
SMEM_PER_SM, BLOCK_RESERVE = 233472, 1024


class MaskerPlanError(ValueError):
    """A wide-center conv for which no route of csrc/masker.cu fits."""


@dataclass(frozen=True)
class ConvPlan:
    """How one conv of the wide center runs: "resident" weights (a
    persistent CTA stages its share of the layer's bf16 weights once; tiles of
    `tm` rows gathered through a ring of `stages` cp.async buffers; wgmma)
    or "streamed" (the CUDA-core loop: each tap's weights staged per tile of
    `tm` rows, one buffer); `co_split` CTAs share a row tile's C_out; shared
    bytes and CTAs of the launch."""
    weights: str
    co_split: int
    tm: int
    stages: int
    smem: int
    ctas: int

    def ints(self):
        return [int(self.weights == "resident"), self.co_split, self.tm, self.stages,
                self.smem, self.ctas]


def _tile_width(c: int) -> bool:
    """Channel counts the swizzled tiles take (csrc/masker.cu `tile_width`):
    32, 64, 128, 256."""
    return c in (32, 64, 128, 256)


def conv_plan(Ch: int, Cs: int, Co: int, rows: int, tensor_cores: bool,
              sms: int = H100_SMS) -> ConvPlan:
    """The route of one conv (`conv_plan` in csrc/masker.cu computes the
    same): Ch / Cs the h and skip parts' input channels (Cs 0: no skip), Co
    the output channels, `rows` = F * K * B output rows, `tensor_cores` bf16
    dots and weights. Resident weights on wgmma take input channels of 32,
    64, 128 or 256 and N = C_out / co_split of 32, 64 or 128: the fewest
    co_split CTAs, then tiles of 128 rows before 64 (each warpgroup then N /
    2 columns, so N >= 64), then 3 ring buffers before 2, that fit 232,448
    bytes (1 KB of it the tiles' alignment); at most 2 CTAs an SM (228 KB an
    SM, 1 KB kept a CTA), persistent, a multiple of co_split. Else the
    CUDA-core loop. Raises MaskerPlanError where neither fits."""
    if rows <= 0 or Ch <= 0 or Cs < 0 or Co <= 0:
        raise MaskerPlanError(f"no route for Ch={Ch}, Cs={Cs}, Co={Co}, rows={rows}")
    cmax = max(Ch, Cs)
    if tensor_cores and _tile_width(Ch) and (Cs == 0 or _tile_width(Cs)):
        for cs in (1, 2, 4):
            n = 0 if Co % cs else Co // cs
            if n not in (32, 64, 128):
                continue
            for tm, ns in ((TC_TM, 3), (TC_TM, 2), (TC_TM // 2, 3), (TC_TM // 2, 2)):
                smem = 1024 + 2 * 6 * n * (Ch + Cs) + 2 * ns * tm * cmax
                if smem > SMEM_MAX or (tm < TC_TM and n < 64):
                    continue
                per_sm = min(2, SMEM_PER_SM // (smem + BLOCK_RESERVE))
                ctas = min(-(-rows // tm) * cs, sms * per_sm)
                return ConvPlan("resident", cs, tm, ns, smem, ctas - ctas % cs)
    tm = min(8192 // Co, 256) & ~3
    smem = 4 * (cmax * (tm + 4) + cmax * Co)
    if smem > SMEM_MAX or tm == 0:
        raise MaskerPlanError(f"Ch={Ch}, Cs={Cs}, Co={Co}: no conv route fits "
                              f"{SMEM_MAX} bytes of shared memory")
    return ConvPlan("streamed", 1, tm, 1, smem, -(-rows // tm))


def conv_layers(chans):
    """(Ch, Cs, Co) of d2, d3, d4, u0, u1, u2 for channel counts (C0, C2, C3,
    C4, CH, Cu2, yC)."""
    C0, C2, C3, C4, CH, Cu2, yC = chans
    return [(C0, 0, C2), (C2, 0, C3), (C3, 0, CH), (CH, CH, C4), (C4, C3, Cu2),
            (Cu2, C2, yC)]


def conv_plans(F: int, K: int, B: int, chans, tensor_cores: bool,
               sms: int = H100_SMS):
    """The six convs' plans (d2, d3, d4, u0, u1, u2)."""
    return tuple(conv_plan(h, s, o, F * K * B, tensor_cores, sms)
                 for h, s, o in conv_layers(chans))


def pack_elems(Ch: int, Cs: int, Co: int) -> int:
    """bf16 elements of a resident conv's weight image (`pack_elems` in
    csrc/masker.cu): each part's [C_out blocks][6 taps][N][C] swizzled."""
    return 6 * Co * (Ch + Cs)


def path_key(attn, convs) -> str:
    """LAUNCHES_BY_PATH's key of a launch."""
    ws = "+".join(sorted({c.weights for c in convs}, key=("resident", "streamed").index))
    return (f"attn={attn.path}," if attn is not None else "") + f"conv={ws}"


# -------------------------------------------------------------------- CUDA
def _lib():
    from ._build import load

    lib = load("masker")
    if not getattr(lib, "_bound", False):
        p = ctypes.c_void_p
        lib.masker_center_chunk.argtypes = [p] * 20
        lib.masker_center_chunk.restype = ctypes.c_int
        lib.masker_error_string.argtypes = [ctypes.c_int]
        lib.masker_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _geometry(x, carries, conv_weights, y_C):
    """Channel counts (C0, C2, C3, C4, CH, Cu2, yC) and the shape checks of
    the conv envelope."""
    if x.dim() != 4:
        raise ValueError(f"x must be [F, K, B, C], got {tuple(x.shape)}")
    F, K, B, C0 = x.shape
    C2, C3, CH = carries[1].shape[-1], carries[2].shape[-1], carries[3].shape[-1]
    C4, Cu2 = carries[5].shape[-1], carries[6].shape[-1]
    ins = [C0, C2, C3]
    outs = [C2, C3, CH]
    up_in = [(CH, CH), (C4, C3), (Cu2, C2)]
    up_out = [C4, Cu2, y_C]
    cdt = carries[0].dtype
    for i, t in enumerate(carries):
        want = [C0, C2, C3, CH, CH, C4, Cu2][i] if i < 7 else t.shape[-1]
        if t.shape != (F, B, want) or t.dtype != cdt or t.device != x.device:
            raise ValueError(f"carry {i} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"not {(F, B, want)} {cdt} on {x.device}")
    down, up = parse_conv_weights(conv_weights)
    wdt = conv_weights[0].dtype
    shapes = []
    for (W, b, a), ci, co in zip(down, ins, outs):
        shapes += [(w, (ci, co)) for w in W] + [(b, (co,)), (a, (1,))]
    for (Wh, Ws, b, a), (ch, cs), co in zip(up, up_in, up_out):
        shapes += ([(w, (ch, co)) for w in Wh] + [(w, (cs, co)) for w in Ws]
                   + [(b, (co,)), (a, (1,))])
    for i, (w, want) in enumerate(shapes):
        if tuple(w.shape) != want or w.dtype != wdt or w.device != x.device:
            raise ValueError(f"conv weight {i} is {tuple(w.shape)} {w.dtype}, not "
                             f"{want} {wdt} on {x.device}")
    for c in (C0, C2, C3, C4, CH, Cu2, y_C):
        if not 0 < c <= 256 or c % 8:
            raise ValueError(f"the kernel takes channel counts in (0, 256] in steps of "
                             f"8, got {c}")
    if F * K * B * max(CH, 4 * carries[7].shape[-1]) >= 2 ** 31:
        raise ValueError("the chunk has 2^31 elements or more")
    return F, K, B, (C0, C2, C3, C4, CH, Cu2, y_C), wdt


def _launch(kind, x, pe, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights,
            bneck_weights, heads, dot_dtype, int8_hh: bool = False,
            xscr_half: bool = False):
    global LAUNCHES
    carries = list(dc) + [u0h, u0s, u1h, u2h] + list(h_in) + list(c_in)
    if len(dc) != 3 or len(h_in) != 2 or len(c_in) != 2:
        raise ValueError("3 dc carries and 2 blocks' h / c carries expected")
    y_C = conv_weights[-2].shape[0]
    F, K, B, chans, wdt = _geometry(x, carries, conv_weights, y_C)
    C0, C2, C3, C4, CH, Cu2, _ = chans
    H = h_in[0].shape[-1]
    if x.dtype not in _KDT or carries[0].dtype not in _KDT or dot_dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, carries "
                        f"{carries[0].dtype}, dot {dot_dtype})")
    if kind == 0:
        from .dual_path_kernel import _check as dp_check

        # the bottleneck's input is the float32 d4 output: check its shape
        # with a one-element view
        d4 = torch.empty((1, 1, 1, 1), device=x.device).expand(F, K, B, CH)
        dp_check(d4, h_in, c_in, bneck_weights, dot_dtype, int8_hh)
        FFD = 0
    else:
        if len(bneck_weights) != 2 * DPARN_PER_BLOCK:
            raise ValueError(f"{2 * DPARN_PER_BLOCK} DPARN weights expected, got "
                             f"{len(bneck_weights)}")
        for b in range(2):
            w = bneck_weights[b * DPARN_PER_BLOCK:(b + 1) * DPARN_PER_BLOCK]
            FFD, awdt = check_weights(w[:N_ATTN], CH, x.device)
            inter = [(CH, 4 * H), (H, 4 * H), (4 * H,), (H, CH), (CH,), (CH,), (CH,)]
            for v, want in zip(w[N_ATTN:], inter):
                if tuple(v.shape) != want or v.dtype != awdt or v.device != x.device:
                    raise ValueError(f"inter weight {tuple(v.shape)} {v.dtype}, not "
                                     f"{want} {awdt}")
        check_geometry(F, CH, FFD, heads)
        if tuple(pe.shape) != (F, CH) or pe.dtype not in _KDT or pe.device != x.device:
            raise ValueError(f"pe must be [F, CH] = {(F, CH)} float32/bfloat16 on "
                             f"{x.device}")
        if not 0 < H <= 512 or (awdt == torch.bfloat16 and H % 2):
            raise ValueError(f"the inter LSTM takes 0 < H <= 512 (even for bf16), got {H}")
    if bneck_weights[0].dtype != wdt:
        raise TypeError("the conv and bottleneck weights must share one dtype")
    dev = x.device
    sms = sm_count(dev)
    tc = wdt == torch.bfloat16 and dot_dtype == torch.bfloat16
    convs = conv_plans(F, K, B, chans, tc, sms)
    attn = (dak.plan(K * B, F, CH, FFD, heads, wdt == torch.bfloat16,
                     dot_dtype == torch.bfloat16, sms) if kind == 1 else None)
    dpp = dpk._plan(F, K, B, CH, H, wdt == torch.bfloat16, dot_dtype == torch.bfloat16,
                    int8_hh, sms)
    dp_tc = dpp.route == "mma"
    plan_ints = (attn.ints() if attn is not None else [0] * 7) + sum(
        (c.ints() for c in convs), []) + dpp.ints()
    packed = dak.packed_scratch(attn, dev, 2) if attn is not None else None
    n_pack = sum(pack_elems(*l) for l, c in zip(conv_layers(chans), convs)
                 if c.weights == "resident")
    conv_pack = (torch.empty(n_pack, device=dev, dtype=torch.bfloat16) if n_pack
                 else None)
    x = x.contiguous()
    pe = pe.contiguous() if pe is not None else x
    carries = [t.contiguous() for t in carries]
    # resident convs and the wgmma attention repack their matrices from any
    # strides; the CUDA-core passes stage contiguous rows
    resident = all(c.weights == "resident" for c in convs)
    cw = as_views(conv_weights) if resident else aligned(conv_weights)
    if kind == 0:
        bw, scales = kernel_weights(bneck_weights, int8_hh, dp_tc)
        dp_img = dpk.tc_images(bneck_weights, int8_hh, 2) if dp_tc else None
    else:
        blocks = [bneck_weights[b * DPARN_PER_BLOCK:(b + 1) * DPARN_PER_BLOCK]
                  for b in range(2)]
        if attn.path == "wgmma":
            bw, scales = [], []
            for w in blocks:
                bw += as_views(w[:N_ATTN]) + aligned(w[N_ATTN:])
        else:
            bw, scales = aligned(bneck_weights), []
        # the inter pass's images: w_ih, w_hh, pw_i of each block
        dp_img = (sum((dpk.inter_images(*w[N_ATTN:N_ATTN + 2], w[N_ATTN + 3])
                       for w in blocks), []) if dp_tc else None)
    y = torch.empty((F, K, B, y_C), device=dev, dtype=x.dtype)
    outs = [torch.empty_like(t) for t in carries]
    sdt = torch.bfloat16 if dot_dtype == torch.bfloat16 else torch.float32
    n = F * K * B
    # the stage outputs d2, d3, u0, u1 (+ bf16 copies of u0's float32 inputs
    # when its weights are resident)
    scr = torch.empty(n * (C2 + C3 + C4 + Cu2 + (2 * CH if convs[3].weights == "resident"
                                                  else 0)), device=dev, dtype=sdt)
    f32 = torch.empty(n * (CH + (2 * H if kind == 0 and not dp_tc else 0)), device=dev,
                      dtype=torch.float32)                  # d4 (, yf / yb)
    # the tensor-core dual-path passes: bf16 yf / yb (DPCRN), x_scr's bf16 copy
    dp16 = (torch.empty(n * ((2 * H if kind == 0 else 0) + (0 if xscr_half else CH)),
                        device=dev, dtype=torch.bfloat16) if dp_tc else None)
    xs = torch.empty(n * CH, device=dev,                    # the bottleneck's x_scr
                     dtype=torch.bfloat16 if xscr_half else torch.float32)
    geo = [kind, F, K, B, C0, C2, C3, C4, CH, Cu2, y_C, H, FFD, heads,
           _KDT[x.dtype], _KDT[carries[0].dtype], _KDT[wdt], _KDT[dot_dtype],
           _KDT.get(pe.dtype, 0), int(xscr_half)]
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.masker_center_chunk(
            (ctypes.c_int * len(geo))(*geo), x.data_ptr(), pe.data_ptr(), arr(carries),
            arr(outs), arr(cw), arr(bw), arr(scales) if int8_hh else None, y.data_ptr(),
            scr.data_ptr(), f32.data_ptr(), xs.data_ptr(),
            (ctypes.c_int * len(plan_ints))(*plan_ints),
            None if packed is None else packed.data_ptr(), strides_of(cw),
            strides_of(bw) if kind == 1 else None,
            None if conv_pack is None else conv_pack.data_ptr(),
            arr(dp_img) if dp_tc else None, None if dp16 is None else dp16.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("wide-center launch failed: "
                           + lib.masker_error_string(err).decode())
    LAUNCHES += 1
    key = option_key(int8_hh=int8_hh, xscr_half=xscr_half)
    LAUNCHES_BY_OPTION[key] = LAUNCHES_BY_OPTION.get(key, 0) + 1
    pk = path_key(attn, convs)
    LAUNCHES_BY_PATH[pk] = LAUNCHES_BY_PATH.get(pk, 0) + 1
    dpk.count_passes(dpp, 2, "ABC" if kind == 0 else "C")
    return (y, outs[0:3], outs[3], outs[4], outs[5], outs[6], outs[7:9], outs[9:11])


def center_chunk(x, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights, dp_weights,
                 dot_dtype=torch.float32, int8_hh: bool = False,
                 xscr_half: bool = False):
    """DPCRN wide center: d2..d4 convs -> both dual-path blocks -> u0..u2
    transpose convs, one call. x [F, K, B, C0]; dc a list of 3 carries;
    u0h / u0s / u1h / u2h [F, B, C]; h_in / c_in per-block [F, B, H];
    dp_weights `dual_path_chunk`'s flat list (`block_names(int8_hh)` a
    block). Returns (y [F, K, B, yC], dc', u0h', u0s', u1h', u2h', h', c')."""
    if x.device.type == "cpu":
        return center_chunk_ref(x, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights,
                                dp_weights, dot_dtype, int8_hh, xscr_half)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    if len(dp_weights) != 2 * len(block_names(int8_hh)):
        raise ValueError(f"{2 * len(block_names(int8_hh))} dual-path weights expected")
    return _launch(0, x, None, dc, u0h, u0s, u1h, u2h, h_in, c_in, list(conv_weights),
                   list(dp_weights), 0, dot_dtype, int8_hh, xscr_half)


def dparn_center_chunk(x, pe, dc, u0h, u0s, u1h, u2h, h_in, c_in, conv_weights,
                       block_weights, heads: int, dot_dtype=torch.float32,
                       xscr_half: bool = False):
    """DPARN wide center: the envelope of `center_chunk` around 2 x
    (attention intra + inter LSTM); `pe` [F, CH] feeds the first encoder
    layer, `block_weights` is flat (DPARN_PER_BLOCK per block)."""
    if x.device.type == "cpu":
        return dparn_center_chunk_ref(x, pe, dc, u0h, u0s, u1h, u2h, h_in, c_in,
                                      conv_weights, block_weights, heads, dot_dtype,
                                      xscr_half)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch(1, x, pe, dc, u0h, u0s, u1h, u2h, h_in, c_in, list(conv_weights),
                   list(block_weights), heads, dot_dtype, False, xscr_half)

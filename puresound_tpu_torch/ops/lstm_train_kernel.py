"""LSTM scans for training: CUDA wrappers + plain versions.

Counterpart of puresound_tpu/ops/lstm_train_kernel.py. Two variants of one
kernel pair (forward and backward), per step t (T-1 .. 0 under `reverse`):

    gates = x_t @ w_ih + bias + h @ w_hh      (fused projection: *_fp)
    gates = xp_t + h @ w_hh                   (hoisted projection)
    (i, f, g, o; bias = b_ih + b_hh);  c = f * c + i * g;  h = o * tanh(c)

- `lstm_scan_train_fp` (`:643`; bodies `_fwd_kernel_fp` `:382`,
  `_bwd_kernel_fp` `:427`, VJP `_bwd_rule_fp` `:684`): x [B, T, C] in, y
  [B, T, H] out; its VJP returns dx, dh0, dc0, dw_ih, dbias and dw_hh.
  `lstm_scan_train_fp_tm` (`:708`) is the same kernel on time-major x_t
  [T, B, C] / y_t [T, B, H] (and dy_t / dx_t).
- `lstm_scan_train_tm` (`:264`; bodies `_fwd_kernel` `:36`, `_bwd_kernel`
  `:83`, VJP `_bwd_rule` `:323`): the projection hoisted out, xp_t
  [T, B, 4H] in, y_t [T, B, H] out; its VJP returns dxp_t (the dgates, in
  the gates' dtype), dh0, dc0 and dw_hh, and autograd through the caller's
  projection gives the rest. `lstm_scan_train` (`:357`) is its batch-major
  wrapper, which swaps xp and y around it as JAX's does.

The forward stores y, the ACTIVATED gates and the cell states (in the
input's dtype); the backward reads them as stored, takes h_prev / c_prev
from the neighbouring y / cseq entries (h0 / c0 at the forward's first
step; the hoisted variant rounds c0 to the input dtype there, as JAX's
concatenation does), and builds no shifted copy. The dot dtype follows the
input: bfloat16 for bfloat16, else float32; each dot's operands are
rounded to it and summed in float32 (the math runs in float32, float64
stays float64 in the plain versions). Under bf16 a hoisted xp arrives
already rounded, where the fused kernel never rounds it: the two routes
differ there by design. Weights are JAX's layout: w_ih [C, 4H], bias
[4H], w_hh [H, 4H]; h0/c0 [B, H]; gates [T, B, 4H], cseq [T, B, H].

Dispatch: one `torch.autograd.Function` per variant for both devices. A
CPU tensor runs the plain forward and backward below; a CUDA tensor
launches `csrc/lstm_train.cu` (built with nvcc at first use) or raises.
Without a gradient to compute the forward skips the residual stores and
goes through the `torch.library` ops `puresound_tpu_torch::lstm_scan_train_fp`
(both layouts, `time_major`) and `puresound_tpu_torch::lstm_scan_train_tm`,
whose bodies are that same dispatch: `torch.export` records the op. The
kernels' layout (cluster size, units and rows a cluster, buffers) comes
from `_plan`, which raises `LstmPlanError` (a ValueError) for a shape no
layout fits; the source checks it again at each launch.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable

#: forward / backward kernel launches by entry since the caller last cleared
#: them (the wrappers add one per launch): "fp" (lstm_scan_train_fp),
#: "fp_tm" (lstm_scan_train_fp_tm), "hoisted" (lstm_scan_train_tm and its
#: batch-major wrapper lstm_scan_train)
FWD_BY_ENTRY: dict = {}
BWD_BY_ENTRY: dict = {}


def _dot_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _rounder(x: torch.Tensor):
    """(compute dtype, the cast of a dot operand: rounded through bf16 when
    the dot dtype is bf16)."""
    cdt = torch.promote_types(x.dtype, torch.float32)
    if _dot_dtype(x) == torch.bfloat16:
        return cdt, lambda a: a.to(torch.bfloat16).to(cdt)
    return cdt, lambda a: a.to(cdt)


def _split(gates, H):
    return gates[..., :H], gates[..., H:2 * H], gates[..., 2 * H:3 * H], gates[..., 3 * H:]


# ------------------------------------------------------------------- plain
def _steps(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def _fwd_ref(inp, h0, c0, w_ih, bias, w_hh, reverse, time_major):
    """The forward of both variants: `w_ih` None means `inp` is the hoisted
    xp_t [T, B, 4H]; else x, batch- or time-major."""
    cdt, rnd = _rounder(inp)
    T, H = inp.shape[0 if time_major else 1], w_hh.shape[0]
    wh = rnd(w_hh)
    if w_ih is not None:
        wi, b = rnd(w_ih), bias.to(cdt)
    h, c = h0.to(cdt), c0.to(cdt)
    ys, gs, cs = [None] * T, [None] * T, [None] * T
    for t in _steps(T, reverse):
        x_t = inp[t] if time_major else inp[:, t]
        if w_ih is None:
            pre = x_t.to(cdt) + rnd(h) @ wh
        else:
            pre = rnd(x_t) @ wi + b + rnd(h) @ wh
        i, f, g, o = _split(pre, H)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t] = h.to(inp.dtype)
        gs[t] = torch.cat([i, f, g, o], dim=-1).to(inp.dtype)
        cs[t] = c.to(inp.dtype)
    return (torch.stack(ys, dim=0 if time_major else 1), h.to(h0.dtype),
            c.to(c0.dtype), torch.stack(gs), torch.stack(cs))


def _bwd_ref(inp, h0, c0, w_ih, w_hh, y, gates, cseq, dy, dhT, dcT, reverse,
             time_major):
    """The backward of both variants (`_bwd_kernel_fp` / `_bwd_kernel`):
    (dx, dh0, dc0, dw_ih, dbias, dw_hh) with the projection in the kernel,
    (dxp_t, dh0, dc0, dw_hh) with it hoisted (`w_ih` None)."""
    cdt, rnd = _rounder(inp)
    proj = w_ih is not None
    T, H = gates.shape[0], w_hh.shape[0]
    wh = rnd(w_hh)
    at = (lambda a, t: a[t]) if time_major else (lambda a, t: a[:, t])
    dh_c = dhT.to(cdt) if dhT is not None else h0.new_zeros(h0.shape, dtype=cdt)
    dc_c = dcT.to(cdt) if dcT is not None else c0.new_zeros(c0.shape, dtype=cdt)
    dwh = torch.zeros(wh.shape, dtype=cdt, device=inp.device)
    if proj:
        wi = rnd(w_ih)
        dwi = torch.zeros(wi.shape, dtype=cdt, device=inp.device)
        db = torch.zeros(wh.shape[1], dtype=cdt, device=inp.device)
    # the forward's first step reads h0 / c0; the hoisted variant's c0 as
    # JAX concatenates it onto cseq, in cseq's dtype
    c_first = c0.to(cdt) if proj else c0.to(cseq.dtype).to(cdt)
    first = T - 1 if reverse else 0
    outs = [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = _split(gates[t].to(cdt), H)
        c_new = cseq[t].to(cdt)
        if t == first:
            c_prev, h_prev = c_first, h0.to(cdt)
        else:
            tp = t + 1 if reverse else t - 1
            c_prev, h_prev = cseq[tp].to(cdt), at(y, tp).to(cdt)
        tanh_c = torch.tanh(c_new)
        dh = dh_c + at(dy, t).to(cdt)
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), dh * tanh_c * o * (1.0 - o)],
                           dim=-1)
        dg = rnd(dgates)
        dh_c = dg @ wh.T
        dc_c = dc * f
        dwh += rnd(h_prev).T @ dg
        if proj:
            outs[t] = (dg @ wi.T).to(inp.dtype)
            dwi += rnd(at(inp, t)).T @ dg
            db += dgates.sum(dim=0)
        else:
            outs[t] = dgates.to(gates.dtype)
    grad_in = torch.stack(outs, dim=0 if time_major or not proj else 1)
    dh0, dc0 = dh_c.to(h0.dtype), dc_c.to(c0.dtype)
    if not proj:
        return grad_in, dh0, dc0, dwh.to(w_hh.dtype)
    return grad_in, dh0, dc0, dwi.to(w_ih.dtype), db, dwh.to(w_hh.dtype)


def lstm_scan_train_fp_ref(x, h0, c0, w_ih, bias, w_hh, reverse: bool = False,
                           time_major: bool = False):
    """Plain forward with the kernel's cast points.

    Returns (y [B, T, H] (time-major: y_t [T, B, H]), hT, cT, gates
    [T, B, 4H], cseq [T, B, H])."""
    return _fwd_ref(x, h0, c0, w_ih, bias, w_hh, reverse, time_major)


def lstm_scan_train_fp_bwd_ref(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq,
                               dy, dhT=None, dcT=None, reverse: bool = False,
                               time_major: bool = False):
    """Plain backward from the stored residuals (`_bwd_kernel_fp`).

    Returns (dx, dh0, dc0, dw_ih, dbias, dw_hh) in the dtypes of x, h0, c0,
    w_ih, bias and w_hh."""
    dx, dh0, dc0, dwi, db, dwh = _bwd_ref(x, h0, c0, w_ih, w_hh, y, gates, cseq,
                                          dy, dhT, dcT, reverse, time_major)
    return dx, dh0, dc0, dwi, db.to(bias.dtype), dwh


def lstm_scan_train_ref(xp_t, h0, c0, w_hh, reverse: bool = False):
    """Plain forward of the hoisted variant (`_fwd_kernel`): xp_t [T, B, 4H]
    -> (y_t [T, B, H], hT, cT, gates [T, B, 4H], cseq [T, B, H])."""
    return _fwd_ref(xp_t, h0, c0, None, None, w_hh, reverse, True)


def lstm_scan_train_bwd_ref(xp_t, h0, c0, w_hh, y_t, gates, cseq, dy_t,
                            dhT=None, dcT=None, reverse: bool = False):
    """Plain backward of the hoisted variant (`_bwd_kernel`, `_bwd_rule`):
    (dxp_t [T, B, 4H] in the gates' dtype, dh0, dc0, dw_hh). xp_t is read
    for its dtype and device only."""
    return _bwd_ref(xp_t, h0, c0, None, w_hh, y_t, gates, cseq, dy_t, dhT, dcT,
                    reverse, True)


# -------------------------------------------------------------------- CUDA
_KDT = {torch.float32: 0, torch.bfloat16: 1}
_RB = 32         # rows per stage of the weight-gradient product
_SPLIT_ROWS = 2048
_SMEM_MAX = 232448   # shared memory a block may use on the H100 (bytes)
_THREADS, _XCH = 256, 8   # csrc/lstm_train.cu: threads, x chunks a thread
_H100_SMS = 132


class LstmPlanError(ValueError):
    """A scan shape for which no layout of `csrc/lstm_train.cu` fits."""


@dataclass(frozen=True)
class ChainPlan:
    """One chain kernel's layout: M rows a cluster, `nbuf` h (forward) or
    partial-dh (backward) buffers, `xproj` (forward only: x @ W_ih + bias
    made for every step first by the product kernel, float32 where W_ih does
    not fit beside the tile; the chain then has the hoisted layout), its
    shared-memory bytes and row tiles."""
    M: int
    nbuf: int
    xproj: int
    smem: int
    n_tiles: int


@dataclass(frozen=True)
class Plan:
    """The layout of one scan shape: clusters of CL CTAs, U hidden units a CTA
    (H padded to CL * U), C padded to Cp, each chain kernel's ChainPlan, and
    the clusters that fit on the card at once (each launch takes at most as
    many as it has row tiles; a cluster walks its tiles)."""
    CL: int
    U: int
    Cp: int
    fwd: ChainPlan
    bwd: ChainPlan
    clusters: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fwd_smem(bf16, CL, U, M, Cp, nbuf):
    """Bytes of the forward's shared memory (`fwd_smem_bytes` in the source):
    the weight slice, nbuf [x | h] tiles, the bias slice."""
    Hp, NC = CL * U, 4 * U
    Kp = Cp + Hp
    if bf16:
        return NC * (Kp + 8) * 2 + nbuf * M * (Kp + 8) * 2 + NC * 4
    return Kp * NC * 4 + nbuf * Kp * M * 4 + NC * 4


def _bwd_smem(bf16, CL, U, M, nbuf):
    """Bytes of the backward chain's shared memory (`bwd_smem_bytes`): the
    W_hh slice, the tile's dgates, nbuf sets of CL partial dh."""
    Hp, NC = CL * U, 4 * U
    part = nbuf * CL * M * U * 4
    if bf16:
        return Hp * (NC + 8) * 2 + M * (NC + 8) * 2 + part
    return NC * Hp * 4 + NC * M * 4 + part


def _plan(B: int, C: int, H: int, bf16: bool, clusters=None) -> Plan:
    """The layout of the chain kernels for B rows, C input channels (0: the
    hoisted variant) and H units, under 227 KB of shared memory a CTA.

    The cluster is the smallest of 1, 2, 4, 8 CTAs with 8 units each that
    covers H (8 from H = 33), each CTA owning U units (a multiple of 8). The
    rows per cluster M (a multiple of 16 under bf16, of 4 under float32) are
    the fewest that put every row tile in one wave of `clusters` (a callable
    of the cluster size: the clusters that fit on the card at once; without
    it 132 SMs / CL, but 15 at CL = 8, as an H100 SXM reports), within the
    threads' tiles and the x staging. Each chain then takes the first layout
    that fits: double buffers, else one buffer and two barriers a step; the
    float32 forward with the projection keeps W_ih resident where it fits and
    else projects x first (`xproj`, the chain in the hoisted layout); a
    smaller M where none fits. Raises LstmPlanError when none does."""
    if B <= 0 or H <= 0 or C < 0:
        raise LstmPlanError(f"no layout for B={B}, C={C}, H={H}")
    CL = next((c for c in (1, 2, 4) if 8 * c >= H), 8)
    U = _cdiv(_cdiv(H, CL), 8) * 8
    if (CL * U) % 16:
        U += 8
    Cp = _cdiv(C, 16) * 16 if bf16 else C
    mstep = 16 if bf16 else 4
    # threads' tiles: bf16 (M / 16) * (U / 8) pairs over 8 warps, two each, f32
    # (M / 4) * (U / 2) over 256 threads, one each; x staged in _XCH 16-byte chunks
    cap = min(64, 2048 // U,
              (_XCH * _THREADS) // max(1, _cdiv(C, 8 if bf16 else 4)))
    cap -= cap % mstep
    if cap < mstep:
        raise LstmPlanError(f"no layout for C={C}, H={H}: U={U} units a CTA leave "
                            f"fewer than {mstep} rows a cluster")
    n_cl = max(1, clusters(CL) if clusters is not None
               else (15 if CL == 8 else _H100_SMS // CL))
    m0 = min(cap, _cdiv(_cdiv(B, n_cl), mstep) * mstep)
    opts = [(2, 0), (1, 0)] + ([(2, 1), (1, 1)] if not bf16 and C > 0 else [])

    def first(sizes):
        for M in range(m0, 0, -mstep):
            for nbuf, xproj in sizes:
                smem = (_fwd_smem(bf16, CL, U, M, 0 if xproj else Cp, nbuf)
                        if xproj is not None else _bwd_smem(bf16, CL, U, M, nbuf))
                if smem <= _SMEM_MAX:
                    return ChainPlan(M, nbuf, xproj or 0, smem, _cdiv(B, M))
        return None

    fwd = first(opts)
    bwd = first([(2, None), (1, None)])
    if fwd is None or bwd is None:
        raise LstmPlanError(f"no layout for C={C}, H={H} under {_SMEM_MAX} bytes of "
                            f"shared memory ({'bf16' if bf16 else 'float32'})")
    return Plan(CL, U, Cp, fwd, bwd, n_cl)


_CLUSTERS: dict = {}   # (device, CL) -> clusters of the forward kernel at once
_PLANS: dict = {}


def _plan_on(dev, B, C, H, dt) -> Plan:
    """`_plan` with the card's own count of clusters in flight (cached)."""
    key = (dev, B, C, H, dt)
    if key not in _PLANS:
        _PLANS[key] = _plan_counted(dev, B, C, H, dt)
    return _PLANS[key]


def _plan_counted(dev, B, C, H, dt) -> Plan:
    def clusters(CL):
        key = (dev, CL)
        if key not in _CLUSTERS:
            with torch.cuda.device(dev):
                n = _lib().lstm_train_clusters(1, 1, 1, CL, _SMEM_MAX)
            if n < 1:
                raise RuntimeError("lstm_train_clusters failed: "
                                   + _lib().lstm_train_error_string(-n).decode())
            _CLUSTERS[key] = n
        return _CLUSTERS[key]

    return _plan(B, C, H, dt == torch.bfloat16, clusters)


def _lib():
    from ._build import load

    lib = load("lstm_train")
    if not getattr(lib, "_bound", False):
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.lstm_train_fwd.argtypes = [p] * 12 + [i] * 15 + [l, i, p]
        lib.lstm_train_fwd.restype = i
        lib.lstm_train_bwd.argtypes = [p] * 20 + [i] * 15 + [l, i, p]
        lib.lstm_train_bwd.restype = i
        lib.lstm_train_clusters.argtypes = [i, i, i, i, l]
        lib.lstm_train_clusters.restype = i
        lib.lstm_train_error_string.argtypes = [i]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def clusters_in_flight(B, T, C, H, dt, dev) -> tuple:
    """(forward, backward chain) clusters that fit on the card at once for
    the plan of this shape (cudaOccupancyMaxActiveClusters), beside the
    plan's row tiles: more tiles than clusters run in several waves."""
    pl = _plan_on(dev, B, C, H, dt)
    lib, bf = _lib(), int(dt == torch.bfloat16)
    with torch.cuda.device(dev):
        return (lib.lstm_train_clusters(1, bf, int(C > 0), pl.CL, pl.fwd.smem),
                lib.lstm_train_clusters(0, bf, int(C > 0), pl.CL, pl.bwd.smem))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(inp, h0, c0, w_ih, bias, w_hh, time_major):
    """(B, T, C, H) of a scan; C is 0 for the hoisted variant (w_ih None,
    inp the time-major xp_t [T, B, 4H])."""
    H = w_hh.shape[0]
    if time_major:
        T, B, K = inp.shape
    else:
        B, T, K = inp.shape
    C = 0 if w_ih is None else K
    for name, t in (("h0", h0), ("c0", c0), ("w_ih", w_ih), ("bias", bias),
                    ("w_hh", w_hh)):
        if t is not None and t.device != inp.device:
            raise ValueError(f"{name} is on {t.device}, the input on {inp.device}")
    if inp.dtype not in _KDT or h0.dtype not in _KDT or c0.dtype != h0.dtype:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (input "
                        f"{inp.dtype}, h0 {h0.dtype}, c0 {c0.dtype})")
    bad = (w_hh.shape != (H, 4 * H) or h0.shape != (B, H) or c0.shape != (B, H)
           or (w_ih is None and K != 4 * H)
           or (w_ih is not None and (w_ih.shape != (C, 4 * H)
                                     or bias.shape != (4 * H,))))
    if bad:
        raise ValueError(f"shape mismatch: input {tuple(inp.shape)}, h0 "
                         f"{tuple(h0.shape)}, w_ih "
                         f"{None if w_ih is None else tuple(w_ih.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}")
    if B == 0 or T == 0 or K == 0 or H == 0:
        raise ValueError(f"empty scan: input {tuple(inp.shape)}, H {H}")
    if B * T >= 2 ** 31:
        raise ValueError(f"B * T = {B * T} rows: the kernel indexes them with int")
    return B, T, C, H


def _entry(proj, time_major):
    return ("fp_tm" if time_major else "fp") if proj else "hoisted"


def _count(counts, key):
    counts[key] = counts.get(key, 0) + 1


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lstm_train_error_string(err).decode())


def _launch_fwd(x, h0, c0, w_ih, bias, w_hh, reverse, residuals,
                time_major=False):
    """One forward launch. `w_ih` and `bias` None: the hoisted variant on
    x = xp_t [T, B, 4H] (time_major must be set)."""
    proj = w_ih is not None
    if not (proj or time_major):
        raise ValueError("the hoisted scan takes time-major xp_t")
    B, T, C, H = _check(x, h0, c0, w_ih, bias, w_hh, time_major)
    dt, dev = x.dtype, x.device
    x = x.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    wi = w_ih.to(dt).contiguous() if proj else None
    b = bias.to(torch.float32).contiguous() if proj else None
    wh = w_hh.to(dt).contiguous()
    y = torch.empty((T, B, H) if time_major else (B, T, H), device=dev, dtype=dt)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    gates = torch.empty((T, B, 4 * H), device=dev, dtype=dt) if residuals else None
    cseq = torch.empty((T, B, H), device=dev, dtype=dt) if residuals else None
    pl = _plan_on(dev, B, C, H, dt)
    f = pl.fwd
    # float32 without W_ih resident: x @ W_ih + bias for every step (scratch)
    xp = torch.empty((T, B, 4 * H), device=dev, dtype=torch.float32) if f.xproj else None
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lstm_train_fwd(
            x.data_ptr(), h0.data_ptr(), c0.data_ptr(), _ptr(wi), _ptr(b),
            wh.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), _ptr(gates),
            _ptr(cseq), _ptr(xp), B, T, C, H, int(reverse), _KDT[dt], _KDT[h0.dtype],
            int(proj), int(time_major), pl.CL, pl.U, f.M, 0 if f.xproj else pl.Cp, f.nbuf,
            f.xproj, f.smem, min(f.n_tiles, pl.clusters), _stream(dev))
    _raise_on(err, lib, "lstm_train_fwd")
    _count(FWD_BY_ENTRY, _entry(proj, time_major))
    return y, hT, cT, gates, cseq


def _split_rows(R: int):
    """(n_split, rows per split) of the weight-gradient product's T*B rows:
    fixed ranges, a multiple of the stage depth, summed in a fixed order."""
    n = min(32, math.ceil(R / _SPLIT_ROWS))
    rows = math.ceil(math.ceil(R / n) / _RB) * _RB
    return math.ceil(R / rows), rows


def _launch_bwd(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq, dy, dhT, dcT,
                reverse, time_major=False):
    """One backward launch: (dx, dh0, dc0, dw_ih, dbias, dw_hh), or with
    `w_ih` None (the hoisted variant, x = xp_t) (dxp_t, dh0, dc0, dw_hh)."""
    proj = w_ih is not None
    B, T, C, H = _check(x, h0, c0, w_ih, bias, w_hh, time_major or not proj)
    dt, dev, G = x.dtype, x.device, 4 * H
    f32 = dict(device=dev, dtype=torch.float32)
    x = x.contiguous() if proj else None    # the hoisted backward reads no xp
    h0, c0 = h0.contiguous(), c0.contiguous()
    wi = w_ih.to(dt).contiguous() if proj else None     # [C, 4H]
    wh = w_hh.to(dt).contiguous()                      # [H, 4H]
    dy = dy.to(dt).contiguous()
    dhT = (dhT.to(torch.float32).contiguous() if dhT is not None
           else torch.zeros((B, H), **f32))
    dcT = (dcT.to(torch.float32).contiguous() if dcT is not None
           else torch.zeros((B, H), **f32))
    pl = _plan_on(dev, B, C, H, dt)
    n_split, rows = _split_rows(B * T)
    dx = torch.empty_like(x) if proj else None    # in x's layout
    dh0, dc0 = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    dw_ih = torch.empty((C, G), **f32) if proj else None
    dw_hh = torch.empty((H, G), **f32)
    dbias = torch.empty((G,), **f32) if proj else None
    # dgates rounded to the dot dtype: scratch, or the hoisted variant's dxp_t
    dg = torch.empty((T, B, G), device=dev, dtype=dt)
    db_part = torch.empty((B, G), **f32) if proj else None         # scratch
    w_part = torch.empty((n_split, H + C, G), **f32)                # scratch
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lstm_train_bwd(
            _ptr(x), h0.data_ptr(), c0.data_ptr(), _ptr(wi),
            wh.data_ptr(), y.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
            dy.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), _ptr(dx),
            dh0.data_ptr(), dc0.data_ptr(), _ptr(dw_ih), dw_hh.data_ptr(),
            _ptr(dbias), dg.data_ptr(), _ptr(db_part), w_part.data_ptr(),
            B, T, C, H, int(reverse), _KDT[dt], _KDT[h0.dtype], n_split, rows,
            int(proj), int(time_major or not proj), pl.CL, pl.U, pl.bwd.M, pl.bwd.nbuf,
            pl.bwd.smem, min(pl.bwd.n_tiles, pl.clusters), _stream(dev))
    _raise_on(err, lib, "lstm_train_bwd")
    _count(BWD_BY_ENTRY, _entry(proj, time_major))
    if not proj:
        return dg, dh0.to(h0.dtype), dc0.to(c0.dtype), dw_hh.to(w_hh.dtype)
    return (dx, dh0.to(h0.dtype), dc0.to(c0.dtype), dw_ih.to(w_ih.dtype),
            dbias.to(bias.dtype), dw_hh.to(w_hh.dtype))


# ---------------------------------------------------------------- dispatch
def _on_card(x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return True


class _ScanFP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, bias, w_hh, reverse, time_major):
        args = (x, h0, c0, w_ih, bias, w_hh, reverse)
        if _on_card(x):
            out = _launch_fwd(*args, residuals=True, time_major=time_major)
        else:
            out = lstm_scan_train_fp_ref(*args, time_major)
        y, hT, cT, gates, cseq = out
        ctx.save_for_backward(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq)
        ctx.reverse, ctx.time_major = reverse, time_major
        return y, hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dhT, dcT):
        args = (*ctx.saved_tensors, dy, dhT, dcT, ctx.reverse)
        bwd = _launch_bwd if _on_card(args[0]) else lstm_scan_train_fp_bwd_ref
        return (*bwd(*args, time_major=ctx.time_major), None, None)


class _ScanHoisted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp_t, h0, c0, w_hh, reverse):
        if _on_card(xp_t):
            out = _launch_fwd(xp_t, h0, c0, None, None, w_hh, reverse,
                              residuals=True, time_major=True)
        else:
            out = lstm_scan_train_ref(xp_t, h0, c0, w_hh, reverse)
        y_t, hT, cT, gates, cseq = out
        ctx.save_for_backward(xp_t, h0, c0, w_hh, y_t, gates, cseq)
        ctx.reverse = reverse
        return y_t, hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dy_t, dhT, dcT):
        xp_t, h0, c0, w_hh, y_t, gates, cseq = ctx.saved_tensors
        if _on_card(xp_t):
            grads = _launch_bwd(xp_t, h0, c0, None, None, w_hh, y_t, gates, cseq,
                                dy_t, dhT, dcT, ctx.reverse, time_major=True)
        else:
            grads = lstm_scan_train_bwd_ref(xp_t, h0, c0, w_hh, y_t, gates, cseq,
                                            dy_t, dhT, dcT, ctx.reverse)
        return (*grads, None)


def _needs_grad(*args):
    return torch.is_grad_enabled() and any(a.requires_grad for a in args)


# ------------------------------------------------------------ library ops
# The no-grad forwards are `torch.library` ops, so that `torch.export` (and
# any later capture) records one node a scan instead of the ctypes launch or
# the plain version's unrolled step loop. Each op's body is the dispatch
# above: a CUDA tensor launches the kernel (and counts it in FWD_BY_ENTRY),
# a CPU tensor runs the plain version, any other device raises. The fake
# bodies give shapes and dtypes only; nothing builds at registration.
def _fp_forward(x, h0, c0, w_ih, bias, w_hh, reverse, time_major):
    args = (x, h0, c0, w_ih, bias, w_hh, reverse)
    if _on_card(x):
        out = _launch_fwd(*args, residuals=False, time_major=time_major)
    else:
        out = lstm_scan_train_fp_ref(*args, time_major)
    return out[:3]


def _hoisted_forward(xp_t, h0, c0, w_hh, reverse):
    if _on_card(xp_t):
        out = _launch_fwd(xp_t, h0, c0, None, None, w_hh, reverse,
                          residuals=False, time_major=True)
    else:
        out = lstm_scan_train_ref(xp_t, h0, c0, w_hh, reverse)
    return out[:3]


# one dispatcher entry a kernel key, no Python wrapper around the op: a
# `torch.library.custom_op` adds its own checks on the host to every call
_LIB = torch.library.Library("puresound_tpu_torch", "FRAGMENT")
_LIB.define("lstm_scan_train_fp(Tensor x, Tensor h0, Tensor c0, Tensor w_ih, Tensor bias, "
            "Tensor w_hh, bool reverse, bool time_major) -> (Tensor, Tensor, Tensor)")
_LIB.define("lstm_scan_train_tm(Tensor xp_t, Tensor h0, Tensor c0, Tensor w_hh, "
            "bool reverse) -> (Tensor, Tensor, Tensor)")
for _key in ("CPU", "CUDA"):
    _LIB.impl("lstm_scan_train_fp", _fp_forward, _key)
    _LIB.impl("lstm_scan_train_tm", _hoisted_forward, _key)
_fp_op = torch.ops.puresound_tpu_torch.lstm_scan_train_fp.default
_hoisted_op = torch.ops.puresound_tpu_torch.lstm_scan_train_tm.default


@torch.library.register_fake("puresound_tpu_torch::lstm_scan_train_fp", lib=_LIB)
def _(x, h0, c0, w_ih, bias, w_hh, reverse, time_major):
    return (x.new_empty((x.shape[0], x.shape[1], w_hh.shape[0])), h0.new_empty(h0.shape),
            c0.new_empty(c0.shape))


@torch.library.register_fake("puresound_tpu_torch::lstm_scan_train_tm", lib=_LIB)
def _(xp_t, h0, c0, w_hh, reverse):
    return (xp_t.new_empty((xp_t.shape[0], xp_t.shape[1], w_hh.shape[0])),
            h0.new_empty(h0.shape), c0.new_empty(c0.shape))


def _scan_fp(x, h0, c0, w_ih, bias, w_hh, reverse, time_major):
    args = (x, h0, c0, w_ih, bias, w_hh)
    if _needs_grad(*args):
        return _ScanFP.apply(*args, reverse, time_major)
    return _fp_op(*args, reverse, time_major)


def lstm_scan_train_fp(x, h0, c0, w_ih, bias, w_hh, reverse: bool = False):
    """Differentiable LSTM scan with the input projection in the kernel.

    x [B, T, C], h0/c0 [B, H], w_ih [C, 4H], bias [4H] (= b_ih + b_hh),
    w_hh [H, 4H]. Returns (y [B, T, H], hT [B, H], cT [B, H]).
    """
    return _scan_fp(x, h0, c0, w_ih, bias, w_hh, reverse, False)


def lstm_scan_train_fp_tm(x_t, h0, c0, w_ih, bias, w_hh, reverse: bool = False):
    """Time-major `lstm_scan_train_fp`: x_t [T, B, C] -> (y_t [T, B, H], hT,
    cT), its VJP's dx_t time-major too. The same kernel with another index
    arithmetic for x / y / dy / dx, so the same arithmetic as the
    batch-major entry."""
    return _scan_fp(x_t, h0, c0, w_ih, bias, w_hh, reverse, True)


def lstm_scan_train_tm(xp_t, h0, c0, w_hh, reverse: bool = False):
    """Differentiable LSTM scan on the hoisted projection, time-major end to
    end: xp_t [T, B, 4H] (x @ w_ih + b_ih + b_hh), h0/c0 [B, H], w_hh
    [H, 4H] -> (y_t [T, B, H], hT, cT)."""
    if _needs_grad(xp_t, h0, c0, w_hh):
        return _ScanHoisted.apply(xp_t, h0, c0, w_hh, reverse)
    return _hoisted_op(xp_t, h0, c0, w_hh, reverse)


def lstm_scan_train(xp, h0, c0, w_hh, reverse: bool = False):
    """Batch-major wrapper: xp [B, T, 4H] -> (y [B, T, H], hT, cT). As JAX's
    (`:357-368`) it swaps xp to time-major (on the card a [B, T, 4H] copy)
    and y back (a view)."""
    y_t, hT, cT = lstm_scan_train_tm(xp.transpose(0, 1), h0, c0, w_hh, reverse)
    return y_t.transpose(0, 1), hT, cT

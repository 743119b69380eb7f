"""LSTM scan for training, input projection in the kernel: CUDA wrapper + plain versions.

Counterpart of puresound_tpu/ops/lstm_train_kernel.py::lstm_scan_train_fp
(`:643`; forward body `_fwd_kernel_fp` `:382`, backward body
`_bwd_kernel_fp` `:427`, VJP `_bwd_rule_fp` `:684`). Per step t (T-1 .. 0
under `reverse`):

    gates = x_t @ w_ih + bias + h @ w_hh      (i, f, g, o; bias = b_ih + b_hh)
    c = f * c + i * g;  h = o * tanh(c)

The forward stores y, the ACTIVATED gates and the cell states (in x's
dtype); the backward reads them as stored, takes h_prev / c_prev from the
neighbouring y / cseq entries (h0 / c0 at the forward's first step), and
returns dx, dh0, dc0, dw_ih, dbias and dw_hh. The dot dtype follows x:
bfloat16 for bfloat16 x, else float32; each dot's operands are rounded to
it and summed in float32 (the math runs in float32, float64 stays float64
in the plain versions). Layouts are JAX's: x [B, T, C], w_ih [C, 4H],
bias [4H], w_hh [H, 4H], h0/c0 [B, H]; gates [T, B, 4H], cseq [T, B, H].

Dispatch: one `torch.autograd.Function` for both devices. A CPU tensor
runs the plain forward and backward below; a CUDA tensor launches
`csrc/lstm_train.cu` (built with nvcc at first use) or raises. Without a
gradient to compute the forward skips the residual stores.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

#: forward / backward kernel launches since the caller last set them to 0
#: (the wrappers add one per launch)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0


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
def lstm_scan_train_fp_ref(x, h0, c0, w_ih, bias, w_hh, reverse: bool = False):
    """Plain forward with the kernel's cast points.

    Returns (y [B, T, H], hT, cT, gates [T, B, 4H], cseq [T, B, H])."""
    cdt, rnd = _rounder(x)
    T, H = x.shape[1], w_hh.shape[0]
    wi, wh, b = rnd(w_ih), rnd(w_hh), bias.to(cdt)
    h, c = h0.to(cdt), c0.to(cdt)
    ys, gs, cs = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        pre = rnd(x[:, t]) @ wi + b + rnd(h) @ wh
        i, f, g, o = _split(pre, H)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t] = h.to(x.dtype)
        gs[t] = torch.cat([i, f, g, o], dim=-1).to(x.dtype)
        cs[t] = c.to(x.dtype)
    return (torch.stack(ys, dim=1), h.to(h0.dtype), c.to(c0.dtype),
            torch.stack(gs), torch.stack(cs))


def lstm_scan_train_fp_bwd_ref(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq,
                               dy, dhT=None, dcT=None, reverse: bool = False):
    """Plain backward from the stored residuals (`_bwd_kernel_fp`).

    Returns (dx, dh0, dc0, dw_ih, dbias, dw_hh) in the dtypes of x, h0, c0,
    w_ih, bias and w_hh."""
    cdt, rnd = _rounder(x)
    T, H = x.shape[1], w_hh.shape[0]
    wi, wh = rnd(w_ih), rnd(w_hh)
    dh_c = dhT.to(cdt) if dhT is not None else h0.new_zeros(h0.shape, dtype=cdt)
    dc_c = dcT.to(cdt) if dcT is not None else c0.new_zeros(c0.shape, dtype=cdt)
    dwi = torch.zeros(wi.shape, dtype=cdt, device=x.device)
    dwh = torch.zeros(wh.shape, dtype=cdt, device=x.device)
    db = torch.zeros(wh.shape[1], dtype=cdt, device=x.device)
    first = T - 1 if reverse else 0      # the forward's first step
    dxs = [None] * T
    for t in (range(T) if reverse else range(T - 1, -1, -1)):
        i, f, g, o = _split(gates[t].to(cdt), H)
        c_new = cseq[t].to(cdt)
        if t == first:
            c_prev, h_prev = c0.to(cdt), h0.to(cdt)
        else:
            tp = t + 1 if reverse else t - 1
            c_prev, h_prev = cseq[tp].to(cdt), y[:, tp].to(cdt)
        tanh_c = torch.tanh(c_new)
        dh = dh_c + dy[:, t].to(cdt)
        dc = dc_c + dh * o * (1.0 - tanh_c * tanh_c)
        dgates = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g), dh * tanh_c * o * (1.0 - o)],
                           dim=-1)
        dg = rnd(dgates)
        dxs[t] = (dg @ wi.T).to(x.dtype)
        dh_c = dg @ wh.T
        dc_c = dc * f
        dwh += rnd(h_prev).T @ dg
        dwi += rnd(x[:, t]).T @ dg
        db += dgates.sum(dim=0)
    return (torch.stack(dxs, dim=1), dh_c.to(h0.dtype), dc_c.to(c0.dtype),
            dwi.to(w_ih.dtype), db.to(bias.dtype), dwh.to(w_hh.dtype))


# -------------------------------------------------------------------- CUDA
_KDT = {torch.float32: 0, torch.bfloat16: 1}
_BT = 8          # rows per CTA (csrc/lstm_train.cu)
_RB = 32         # rows per stage of the weight-gradient product
_SPLIT_ROWS = 2048


def _lib():
    from ._build import load

    lib = load("lstm_train")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_train_fwd.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.lstm_train_fwd.restype = i
        lib.lstm_train_bwd.argtypes = [p] * 20 + [i] * 9 + [p]
        lib.lstm_train_bwd.restype = i
        lib.lstm_train_error_string.argtypes = [i]
        lib.lstm_train_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(x, h0, c0, w_ih, bias, w_hh):
    B, T, C = x.shape
    H = w_hh.shape[0]
    for name, t in (("h0", h0), ("c0", c0), ("w_ih", w_ih), ("bias", bias),
                    ("w_hh", w_hh)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _KDT or h0.dtype not in _KDT or c0.dtype != h0.dtype:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, "
                        f"h0 {h0.dtype}, c0 {c0.dtype})")
    if (w_ih.shape != (C, 4 * H) or w_hh.shape != (H, 4 * H)
            or bias.shape != (4 * H,) or h0.shape != (B, H) or c0.shape != (B, H)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, h0 {tuple(h0.shape)}, "
                         f"w_ih {tuple(w_ih.shape)}, bias {tuple(bias.shape)}, "
                         f"w_hh {tuple(w_hh.shape)}")
    if B == 0 or T == 0 or C == 0 or H == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, H {H}")
    if B * T >= 2 ** 31:
        raise ValueError(f"B * T = {B * T} rows: the kernel indexes them with int")
    return B, T, C, H


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.lstm_train_error_string(err).decode())


def _launch_fwd(x, h0, c0, w_ih, bias, w_hh, reverse, residuals):
    global FWD_LAUNCHES
    B, T, C, H = _check(x, h0, c0, w_ih, bias, w_hh)
    dt = x.dtype
    x = x.contiguous()
    h0, c0 = h0.contiguous(), c0.contiguous()
    wi = w_ih.to(dt).contiguous()
    wh = w_hh.to(dt).contiguous()
    b = bias.to(torch.float32).contiguous()
    y = torch.empty((B, T, H), device=x.device, dtype=dt)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    gates = torch.empty((T, B, 4 * H), device=x.device, dtype=dt) if residuals else None
    cseq = torch.empty((T, B, H), device=x.device, dtype=dt) if residuals else None
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.lstm_train_fwd(
            x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wi.data_ptr(), b.data_ptr(),
            wh.data_ptr(), y.data_ptr(), hT.data_ptr(), cT.data_ptr(), _ptr(gates),
            _ptr(cseq), B, T, C, H, int(reverse), _KDT[dt], _KDT[h0.dtype],
            _stream(x.device))
    _raise_on(err, lib, "lstm_train_fwd")
    FWD_LAUNCHES += 1
    return y, hT, cT, gates, cseq


def _split_rows(R: int):
    """(n_split, rows per split) of the weight-gradient product's T*B rows:
    fixed ranges, a multiple of the stage depth, summed in a fixed order."""
    n = min(16, math.ceil(R / _SPLIT_ROWS))
    rows = math.ceil(math.ceil(R / n) / _RB) * _RB
    return math.ceil(R / rows), rows


def _launch_bwd(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq, dy, dhT, dcT,
                reverse):
    global BWD_LAUNCHES
    B, T, C, H = _check(x, h0, c0, w_ih, bias, w_hh)
    dt, dev, G = x.dtype, x.device, 4 * H
    f32 = dict(device=dev, dtype=torch.float32)
    x, h0, c0 = x.contiguous(), h0.contiguous(), c0.contiguous()
    wi_t = w_ih.t().to(dt).contiguous()     # [4H, C]: torch's weight_ih_l0
    wh_t = w_hh.t().to(dt).contiguous()     # [4H, H]
    dy = dy.to(dt).contiguous()
    dhT = (dhT.to(torch.float32).contiguous() if dhT is not None
           else torch.zeros((B, H), **f32))
    dcT = (dcT.to(torch.float32).contiguous() if dcT is not None
           else torch.zeros((B, H), **f32))
    n_tiles = -(-B // _BT)
    n_split, rows = _split_rows(B * T)
    dx = torch.empty_like(x)
    dh0, dc0 = torch.empty((B, H), **f32), torch.empty((B, H), **f32)
    dw_ih, dw_hh = torch.empty((C, G), **f32), torch.empty((H, G), **f32)
    dbias = torch.empty((G,), **f32)
    dg = torch.empty((T, B, G), device=dev, dtype=dt)          # scratch
    db_part = torch.empty((n_tiles, G), **f32)                  # scratch
    w_part = torch.empty((n_split, H + C, G), **f32)            # scratch
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.lstm_train_bwd(
            x.data_ptr(), h0.data_ptr(), c0.data_ptr(), wi_t.data_ptr(),
            wh_t.data_ptr(), y.data_ptr(), gates.data_ptr(), cseq.data_ptr(),
            dy.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), dx.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), dw_ih.data_ptr(), dw_hh.data_ptr(),
            dbias.data_ptr(), dg.data_ptr(), db_part.data_ptr(), w_part.data_ptr(),
            B, T, C, H, int(reverse), _KDT[dt], _KDT[h0.dtype], n_split, rows,
            _stream(dev))
    _raise_on(err, lib, "lstm_train_bwd")
    BWD_LAUNCHES += 1
    return (dx, dh0.to(h0.dtype), dc0.to(c0.dtype), dw_ih.to(w_ih.dtype),
            dbias.to(bias.dtype), dw_hh.to(w_hh.dtype))


# ---------------------------------------------------------------- dispatch
def _forward(x, h0, c0, w_ih, bias, w_hh, reverse, residuals):
    if x.device.type == "cpu":
        return lstm_scan_train_fp_ref(x, h0, c0, w_ih, bias, w_hh, reverse)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch_fwd(x, h0, c0, w_ih, bias, w_hh, reverse, residuals)


def _backward(*args):
    x = args[0]
    if x.device.type == "cpu":
        return lstm_scan_train_fp_bwd_ref(*args)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch_bwd(*args)


class _ScanFP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0, c0, w_ih, bias, w_hh, reverse):
        y, hT, cT, gates, cseq = _forward(x, h0, c0, w_ih, bias, w_hh, reverse,
                                          residuals=True)
        ctx.save_for_backward(x, h0, c0, w_ih, bias, w_hh, y, gates, cseq)
        ctx.reverse = reverse
        return y, hT, cT

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dhT, dcT):
        grads = _backward(*ctx.saved_tensors, dy, dhT, dcT, ctx.reverse)
        return (*grads, None)


def lstm_scan_train_fp(x, h0, c0, w_ih, bias, w_hh, reverse: bool = False):
    """Differentiable LSTM scan with the input projection in the kernel.

    x [B, T, C], h0/c0 [B, H], w_ih [C, 4H], bias [4H] (= b_ih + b_hh),
    w_hh [H, 4H]. Returns (y [B, T, H], hT [B, H], cT [B, H]).
    """
    args = (x, h0, c0, w_ih, bias, w_hh)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _ScanFP.apply(*args, reverse)
    y, hT, cT, _, _ = _forward(*args, reverse, residuals=False)
    return y, hT, cT

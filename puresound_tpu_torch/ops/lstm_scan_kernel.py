"""LSTM recurrence over pre-projected inputs: CUDA wrapper + plain version.

Counterpart of puresound_tpu/ops/lstm_scan_kernel.py::lstm_scan (`:77`,
pallas_call at `:109`), the serving scan of DPCRN's
`DPRNNblock2D.step_chunk(fused=True)`. Per step t (T-1 .. 0 under
`reverse`, y stays input-aligned):

    gates = xp[:, t] + h @ w_hh          (i, f, g, o)
    c = f * c + i * g;  h = o * tanh(c)

h and c are carried in float32 (float64 stays float64 in the plain
version); the dot's operands are cast to `dot_dtype` (float32 by default:
bf16 serving runs the recurrent dot on float32 operands of bf16 weights, as
JAX does) and summed in float32. y comes back in xp's dtype, hT / cT in
h0's. Layouts are JAX's: xp [B, T, 4H], h0 / c0 [B, H], w_hh [H, 4H].

Dispatch: a CPU tensor runs `lstm_scan_ref`; a CUDA tensor launches
`csrc/lstm_scan.cu` (built with nvcc at first use) or raises.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches since the caller last set it to 0 (one per `_launch`)
LAUNCHES = 0

_KDT = {torch.float32: 0, torch.bfloat16: 1}


def _rounder(dtype, dot_dtype):
    """(compute dtype, the cast of a dot operand)."""
    cdt = torch.promote_types(dtype, torch.float32)
    if dot_dtype == torch.bfloat16:
        return cdt, lambda a: a.to(torch.bfloat16).to(cdt)
    return cdt, lambda a: a.to(cdt)


def lstm_cell(gates, c):
    """(h, c) from the gate pre-activations (i, f, g, o)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_scan_ref(xp, h0, c0, w_hh, reverse: bool = False,
                  dot_dtype=torch.float32):
    """Plain version with the kernel's cast points: (y, hT, cT)."""
    cdt, rnd = _rounder(torch.promote_types(xp.dtype, h0.dtype), dot_dtype)
    T = xp.shape[1]
    wh = rnd(w_hh)
    h, c = h0.to(cdt), c0.to(cdt)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = lstm_cell(xp[:, t].to(cdt) + rnd(h) @ wh, c)
        ys[t] = h.to(xp.dtype)
    return torch.stack(ys, dim=1), h.to(h0.dtype), c.to(c0.dtype)


# -------------------------------------------------------------------- CUDA
def _lib():
    from ._build import load

    lib = load("lstm_scan")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan.argtypes = [p] * 7 + [i] * 7 + [p]
        lib.lstm_scan.restype = i
        lib.lstm_scan_error_string.argtypes = [i]
        lib.lstm_scan_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _check(xp, h0, c0, w_hh, dot_dtype):
    if xp.dim() != 3 or xp.shape[-1] % 4:
        raise ValueError(f"xp must be [B, T, 4H], got {tuple(xp.shape)}")
    B, T, G = xp.shape
    H = G // 4
    for name, t in (("h0", h0), ("c0", c0), ("w_hh", w_hh)):
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    if (xp.dtype not in _KDT or h0.dtype not in _KDT or c0.dtype != h0.dtype
            or w_hh.dtype not in _KDT or dot_dtype not in _KDT):
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (xp {xp.dtype}, "
                        f"h0 {h0.dtype}, c0 {c0.dtype}, w_hh {w_hh.dtype}, "
                        f"dot {dot_dtype})")
    if h0.shape != (B, H) or c0.shape != (B, H) or w_hh.shape != (H, G):
        raise ValueError(f"shape mismatch: xp {tuple(xp.shape)}, h0 "
                         f"{tuple(h0.shape)}, c0 {tuple(c0.shape)}, w_hh "
                         f"{tuple(w_hh.shape)}")
    if B == 0 or T == 0 or H == 0 or H > 512:
        raise ValueError(f"the kernel takes 0 < H <= 512 and a non-empty "
                         f"scan: xp {tuple(xp.shape)}")
    if B * T * G >= 2 ** 31:
        raise ValueError("xp has 2^31 elements or more")
    return B, T, H


def _launch(xp, h0, c0, w_hh, reverse, dot_dtype):
    global LAUNCHES
    B, T, H = _check(xp, h0, c0, w_hh, dot_dtype)
    xp, h0, c0 = xp.contiguous(), h0.contiguous(), c0.contiguous()
    w = w_hh.float().contiguous()       # exact for bf16 weights
    if w.data_ptr() % 16:               # the kernel stages it with 16-byte copies
        w = w.clone()
    y = torch.empty((B, T, H), device=xp.device, dtype=xp.dtype)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    lib = _lib()
    with torch.cuda.device(xp.device):
        err = lib.lstm_scan(xp.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(),
                            y.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H,
                            int(reverse), _KDT[xp.dtype], _KDT[h0.dtype],
                            _KDT[dot_dtype],
                            torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_scan launch failed: "
                           + lib.lstm_scan_error_string(err).decode())
    LAUNCHES += 1
    return y, hT, cT


def lstm_scan(xp, h0, c0, w_hh, reverse: bool = False, dot_dtype=torch.float32):
    """Run an LSTM recurrence over pre-projected inputs.

    xp [B, T, 4H] (x @ w_ih + b_ih + b_hh), h0 / c0 [B, H], w_hh [H, 4H].
    Returns (y [B, T, H], hT [B, H], cT [B, H])."""
    if xp.device.type == "cpu":
        return lstm_scan_ref(xp, h0, c0, w_hh, reverse, dot_dtype)
    if xp.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {xp.device}")
    return _launch(xp, h0, c0, w_hh, reverse, dot_dtype)

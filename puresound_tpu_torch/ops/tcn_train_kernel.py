"""Residual TCN block for training: CUDA wrapper + plain versions.

Counterpart of puresound_tpu/ops/tcn_train_kernel.py::tcn_block_train
(`:403`; forward body `_make_fwd_kernel` `:213`, backward body
`_make_bwd_kernel` `:224`, VJP `_vjp_fwd` / `_vjp_bwd` `:420-440`). For
x [B, C, T]:

    h1 = w_in @ x                     a1 = PReLU(al1)(gLN(g1, b1)(h1))
    h2 = dwconv(w_dw, dilation)(a1) + b_dw
    a2 = PReLU(al2)(gGN(g2, b2)(h2))  h3 = w_pw @ a2 + b_pw
    a3 = PReLU(al3)(gGN(g3, b3)(h3))  y = w_out @ a3 + b_out + x

The depthwise taps read a1 at t + j*dilation - ((k-1)/2)*dilation, zero
outside the sample; every norm is global per sample over (Ch, T) with the
single-pass variance max(E[h^2] - mean^2, 0) and eps 1e-8. The math runs in
float32 (float64 stays float64 in the plain versions); each operand of a
1x1 product is rounded to the dot dtype (bfloat16 for bfloat16 x, else
float32) and summed in float32, the statistics stay in full precision. The
backward recomputes the forward (nothing is stored) and returns dx in x's
dtype and the 16 parameter gradients summed over the batch, each in its
parameter's dtype. Parameter layouts are JAX's: w_in [Ch, C], w_dw [Ch, k],
w_pw [Ch, Ch], w_out [C, Ch], gammas / betas / biases [width], alphas [1].

Dispatch: one `torch.autograd.Function` for both devices. A CPU tensor
runs the plain forward and backward below; a CUDA tensor launches
`csrc/tcn_train.cu` (built with nvcc at first use) or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence

import torch
from torch.autograd.function import once_differentiable

#: forward / backward kernel launches since the caller last set them to 0
#: (the wrappers add one per launch)
FWD_LAUNCHES = 0
BWD_LAUNCHES = 0

_EPS = 1e-8
PARAM_NAMES = ("w_in", "g1", "b1", "al1", "w_dw", "b_dw", "g2", "b2", "al2",
               "w_pw", "b_pw", "g3", "b3", "al3", "w_out", "b_out")


def _rounder(x: torch.Tensor, compute_dtype=None):
    """(compute dtype, the cast of a dot operand: rounded through bf16 when
    x is bf16)."""
    cdt = compute_dtype or torch.promote_types(x.dtype, torch.float32)
    if x.dtype == torch.bfloat16:
        return cdt, lambda a: a.to(torch.bfloat16).to(cdt)
    return cdt, lambda a: a.to(cdt)


def _shifts(kw: int, dilation: int) -> List[int]:
    pad = ((kw - 1) // 2) * dilation
    return [j * dilation - pad for j in range(kw)]


def _shift(a: torch.Tensor, s: int) -> torch.Tensor:
    """Columns t <- a[..., t + s], zero outside the sample."""
    if s == 0:
        return a
    T = a.shape[-1]
    n = min(abs(s), T)
    z = a.new_zeros(a.shape[:-1] + (n,))
    if s > 0:
        return torch.cat([a[..., n:], z], dim=-1)
    return torch.cat([z, a[..., :T - n]], dim=-1)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, 1)


def _stats(h: torch.Tensor, count: float):
    s1 = h.sum(dim=(1, 2), keepdim=True)
    s2 = (h * h).sum(dim=(1, 2), keepdim=True)
    mean = s1 / count
    var = torch.clamp(s2 / count - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + _EPS)


def _prelu(y, al):
    return torch.where(y >= 0, y, al * y)


def _forward_parts(x, params, dilation, compute_dtype=None):
    """Every value of the forward (`_fwd_tile`), in the compute dtype."""
    cdt, rnd = _rounder(x, compute_dtype)
    (w_in, g1, b1, al1, w_dw, b_dw, g2, b2, al2, w_pw, b_pw, g3, b3, al3,
     w_out, b_out) = [p.to(cdt) for p in params]
    xt = x.to(cdt)
    count = float(w_in.shape[0] * x.shape[-1])
    shifts = _shifts(w_dw.shape[1], dilation)
    it = {"x": xt, "count": count, "shifts": shifts}
    h1 = torch.matmul(rnd(w_in), rnd(xt))
    mean1, rstd1 = _stats(h1, count)
    it["xhat1"] = xhat1 = (h1 - mean1) * rstd1
    it["y1"] = y1 = xhat1 * _col(g1) + _col(b1)
    it["a1"] = a1 = _prelu(y1, al1)
    dwo = _col(w_dw[:, 0]) * _shift(a1, shifts[0])
    for j in range(1, len(shifts)):
        dwo = dwo + _col(w_dw[:, j]) * _shift(a1, shifts[j])
    h2 = dwo + _col(b_dw)
    mean2, rstd2 = _stats(h2, count)
    it["xhat2"] = xhat2 = (h2 - mean2) * rstd2
    it["y2"] = y2 = xhat2 * _col(g2) + _col(b2)
    it["a2"] = a2 = _prelu(y2, al2)
    h3 = torch.matmul(rnd(w_pw), rnd(a2)) + _col(b_pw)
    mean3, rstd3 = _stats(h3, count)
    it["xhat3"] = xhat3 = (h3 - mean3) * rstd3
    it["y3"] = y3 = xhat3 * _col(g3) + _col(b3)
    it["a3"] = a3 = _prelu(y3, al3)
    it["out"] = torch.matmul(rnd(w_out), rnd(a3)) + _col(b_out)
    it.update(rstd1=rstd1, rstd2=rstd2, rstd3=rstd3)
    return it


# ------------------------------------------------------------------- plain
def tcn_block_train_ref(x, *params, dilation: int = 1, compute_dtype=None):
    """Plain forward with the kernel's cast points; y in x's dtype.

    `compute_dtype` (float32 by default, float64 for float64 x) is the
    dtype the math runs in; where it is given, y comes back in it. With
    float64 it is the exact reference of the kernel at x's dtype: bfloat16
    x keeps its bfloat16 dot operands."""
    it = _forward_parts(x, params, dilation, compute_dtype)
    return (it["out"] + it["x"]).to(compute_dtype or x.dtype)


def _norm_bwd(dyn, xhat, rstd, g, count):
    dgamma = (dyn * xhat).sum(dim=(0, 2))
    dbeta = dyn.sum(dim=(0, 2))
    dxhat = dyn * _col(g)
    m1 = dxhat.sum(dim=(1, 2), keepdim=True) / count
    m2 = (dxhat * xhat).sum(dim=(1, 2), keepdim=True) / count
    return rstd * (dxhat - m1 - xhat * m2), dgamma, dbeta


def _prelu_bwd(da, y, al):
    dal = (da * torch.where(y < 0, y, torch.zeros_like(y))).sum().reshape(1)
    return da * torch.where(y >= 0, torch.ones_like(y), al * torch.ones_like(y)), dal


def tcn_block_train_bwd_ref(x, dy, *params, dilation: int = 1, compute_dtype=None):
    """Plain backward from the recomputed forward (`_make_bwd_kernel`).

    Returns (dx, the 16 parameter gradients), dx in x's dtype and each
    gradient in its parameter's dtype, or all in `compute_dtype` where one
    is given (as in `tcn_block_train_ref`)."""
    cdt, rnd = _rounder(x, compute_dtype)
    it = _forward_parts(x, params, dilation, compute_dtype)
    (w_in, g1, _, al1, w_dw, _, g2, _, al2, w_pw, _, g3, _, al3, w_out,
     _) = [p.to(cdt) for p in params]
    count, shifts = it["count"], it["shifts"]
    d_out = dy.to(cdt)
    mm = lambda a, b: torch.matmul(rnd(a), rnd(b))
    # out 1x1 (+ residual)
    dw_out = mm(d_out, it["a3"].transpose(1, 2)).sum(0)
    db_out = d_out.sum(dim=(0, 2))
    da3 = mm(w_out.T, d_out)
    dy3, dal3 = _prelu_bwd(da3, it["y3"], al3)
    d_pw, dg3, dbt3 = _norm_bwd(dy3, it["xhat3"], it["rstd3"], g3, count)
    # pointwise 1x1
    db_pw = d_pw.sum(dim=(0, 2))
    dw_pw = mm(d_pw, it["a2"].transpose(1, 2)).sum(0)
    da2 = mm(w_pw.T, d_pw)
    dy2, dal2 = _prelu_bwd(da2, it["y2"], al2)
    d_dw, dg2, dbt2 = _norm_bwd(dy2, it["xhat2"], it["rstd2"], g2, count)
    # depthwise dilated conv
    db_dw = d_dw.sum(dim=(0, 2))
    dw_dw = torch.stack([(d_dw * _shift(it["a1"], s)).sum(dim=(0, 2))
                         for s in shifts], dim=1)
    da1 = _col(w_dw[:, 0]) * _shift(d_dw, -shifts[0])
    for j in range(1, len(shifts)):
        da1 = da1 + _col(w_dw[:, j]) * _shift(d_dw, -shifts[j])
    dy1, dal1 = _prelu_bwd(da1, it["y1"], al1)
    dh1, dg1, dbt1 = _norm_bwd(dy1, it["xhat1"], it["rstd1"], g1, count)
    # in 1x1 (no bias)
    dw_in = mm(dh1, it["x"].transpose(1, 2)).sum(0)
    dx = (mm(w_in.T, dh1) + d_out).to(compute_dtype or x.dtype)
    grads = (dw_in, dg1, dbt1, dal1, dw_dw, db_dw, dg2, dbt2, dal2,
             dw_pw, db_pw, dg3, dbt3, dal3, dw_out, db_out)
    return (dx, *[g.reshape(p.shape).to(compute_dtype or p.dtype)
                  for g, p in zip(grads, params)])


# -------------------------------------------------------------------- CUDA
_KDT = {torch.float32: 0, torch.bfloat16: 1}
_RB = 32               # columns per stage of the weight-gradient product
_SPLIT_COLS = 4096


def _lib():
    from ._build import load

    lib = load("tcn_train")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tcn_train_scratch_floats.argtypes = [i] * 7
        lib.tcn_train_scratch_floats.restype = ctypes.c_long
        lib.tcn_train_fwd.argtypes = [p, p] + [i] * 7 + [p]
        lib.tcn_train_fwd.restype = i
        lib.tcn_train_bwd.argtypes = [p, p] + [i] * 9 + [p]
        lib.tcn_train_bwd.restype = i
        lib.tcn_train_error_string.argtypes = [i]
        lib.tcn_train_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _check(x, params: Sequence[torch.Tensor]):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    if x.dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 x, not {x.dtype}")
    Ch, kw = params[0].shape[0], params[4].shape[1]
    want = {"w_in": (Ch, C), "w_dw": (Ch, kw), "w_pw": (Ch, Ch), "w_out": (C, Ch),
            "b_out": (C,)}
    for name, p in zip(PARAM_NAMES, params):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        shape = want.get(name, (1,) if name.startswith("al") else (Ch,))
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, not {shape}")
    if kw % 2 == 0 or kw > 8:
        raise ValueError(f"the kernel takes an odd number of taps up to 7, not {kw}")
    if B == 0 or C == 0 or Ch == 0 or T == 0:
        raise ValueError(f"empty block: x {tuple(x.shape)}, Ch {Ch}")
    if B * T >= 2 ** 31:
        raise ValueError(f"B * T = {B * T} columns: the kernel indexes them with int")
    return B, C, Ch, T, kw


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.tcn_train_error_string(err).decode())


def _split_cols(R: int):
    """(n_split, columns per split) of the weight-gradient product's B*T
    columns: fixed ranges, a multiple of the stage depth, summed in a fixed
    order."""
    n = max(1, min(32, math.ceil(R / _SPLIT_COLS)))
    cols = math.ceil(math.ceil(R / n) / _RB) * _RB
    return math.ceil(R / cols), cols


def _launch_fwd(x, params, dilation):
    global FWD_LAUNCHES
    B, C, Ch, T, kw = _check(x, params)
    x = x.contiguous()
    p32 = [p.detach().to(torch.float32).contiguous() for p in params]
    y = torch.empty_like(x)
    lib = _lib()
    scratch = torch.empty(lib.tcn_train_scratch_floats(B, C, Ch, T, kw, 0, 0),
                          device=x.device, dtype=torch.float32)
    ptrs = _ptrs([x, *p32, y])
    with torch.cuda.device(x.device):
        err = lib.tcn_train_fwd(ctypes.addressof(ptrs), scratch.data_ptr(), B, C,
                                Ch, T, kw, dilation, _KDT[x.dtype],
                                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "tcn_train_fwd")
    FWD_LAUNCHES += 1
    return y


def _launch_bwd(x, dy, params, dilation):
    global BWD_LAUNCHES
    B, C, Ch, T, kw = _check(x, params)
    f32 = dict(device=x.device, dtype=torch.float32)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    p32 = [p.detach().to(torch.float32).contiguous() for p in params]
    w_t = [p32[i].t().contiguous() for i in (0, 9, 14)]   # W_in^T, W_pw^T, W_out^T
    dx = torch.empty_like(x)
    grads = [torch.empty(p.shape, **f32) for p in params]
    n_split, cols = _split_cols(B * T)
    lib = _lib()
    scratch = torch.empty(lib.tcn_train_scratch_floats(B, C, Ch, T, kw, 1, n_split),
                          **f32)
    ptrs = _ptrs([x, dy, *p32, *w_t, dx, *grads])
    with torch.cuda.device(x.device):
        err = lib.tcn_train_bwd(ctypes.addressof(ptrs), scratch.data_ptr(), B, C,
                                Ch, T, kw, dilation, _KDT[x.dtype], n_split, cols,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, "tcn_train_bwd")
    BWD_LAUNCHES += 1
    return (dx, *[g.to(p.dtype) for g, p in zip(grads, params)])


# ---------------------------------------------------------------- dispatch
def _forward(x, params, dilation):
    if x.device.type == "cpu":
        return tcn_block_train_ref(x, *params, dilation=dilation)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch_fwd(x, params, dilation)


def _backward(x, dy, params, dilation):
    if x.device.type == "cpu":
        return tcn_block_train_bwd_ref(x, dy, *params, dilation=dilation)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch_bwd(x, dy, params, dilation)


class _TcnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dilation, *params):
        ctx.save_for_backward(x, *params)
        ctx.dilation = dilation
        return _forward(x, params, dilation)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dx, *grads = _backward(x, dy, params, ctx.dilation)
        return (dx, None, *grads)


def tcn_block_train(x, w_in, g1, b1, al1, w_dw, b_dw, g2, b2, al2, w_pw, b_pw,
                    g3, b3, al3, w_out, b_out, dilation: int = 1):
    """Differentiable fused TCN block: x [B, C, T] -> y [B, C, T], the
    non-causal, embedding-free TCN block with gain+bias global norms."""
    params = (w_in, g1, b1, al1, w_dw, b_dw, g2, b2, al2, w_pw, b_pw, g3, b3,
              al3, w_out, b_out)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return _TcnBlock.apply(x, dilation, *params)
    return _forward(x, params, dilation)

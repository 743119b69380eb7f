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
`csrc/tcn_train.cu` (built with nvcc at first use) on the route `_plan`
gives by shape and dtype (bf16 at C, Ch in {64, 128, 256}: the 1x1
products and their weight gradients on wgmma; else CUDA cores), or raises.
Without a gradient the forward goes through the `torch.library` op
`puresound_tpu_torch::tcn_block_train`, whose body is that same dispatch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

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
#: the plan's constants; csrc/tcn_train.cu holds the same numbers
H100_SMS = 132           # persistent CTAs of a wgmma pass
SMEM_MAX = 232448        # bytes of shared memory a block may use
WG_COLS = 64             # columns a weight-gradient chunk on the wgmma route
DW_SEG = 2048            # columns a depthwise segment
ALIGN_F = 64             # floats: every scratch region starts on 256 bytes
SPLIT_COLS = 4096        # CUDA-core weight gradient: columns a split, at least
MAX_SPLIT = 32           # and at most this many splits
STAGE_BYTES = 8 * 16 * 40 * 4   # a wgmma product's epilogue staging: 16 rows x 40 floats a warp
_TILE, _RB, _MAXK = 64, 32, 8
ROUTES = ("cuda_cores", "wgmma")

#: launches by (direction, route) since the caller last cleared it: ("fwd",
#: "wgmma"), ("bwd", "cuda_cores"), ...
LAUNCHES_BY_ROUTE: Dict[Tuple[str, str], int] = {}


class TcnPlanError(ValueError):
    """No route of csrc/tcn_train.cu takes the shape."""


@dataclass(frozen=True)
class GemmPlan:
    O: int
    K: int
    ncol: int     # columns a tile (wgmma) or the CUDA-core tile's 64
    smem: int     # dynamic shared bytes (0: the CUDA-core kernel's static tiles)

    def tiles(self, T: int) -> int:
        """Column tiles of one sample."""
        return -(-T // self.ncol)


@dataclass(frozen=True)
class WgradPlan:
    O: int
    K: int
    n_split: int     # fixed column ranges, summed in order
    per_split: int   # wgmma: WG_COLS-column chunks of a sample a range; CUDA cores: flat columns
    n_ob: int        # O-blocks (wgmma), 1 on CUDA cores
    smem: int


@dataclass(frozen=True)
class TcnPlan:
    route: str                     # "wgmma" or "cuda_cores"
    pitch: int                     # Tp: float32 scratch row length, T rounded up to 8
    gemms: Tuple[GemmPlan, ...]    # `_gemm_dims`' order
    wgrads: Tuple[WgradPlan, ...]  # `_wgrad_dims`' order
    dw_smem: Tuple[int, int]       # depthwise forward / backward shared bytes
    fwd_scratch: int               # float32 scratch of a forward call
    bwd_scratch: int               # ... and of a backward call

    def ints(self) -> List[int]:
        """The fields in csrc/tcn_train.cu's order (`make_plan`)."""
        out = [ROUTES.index(self.route), self.pitch]
        for g in self.gemms:
            out += [g.ncol, g.smem]
        for w in self.wgrads:
            out += [w.n_split, w.per_split, w.n_ob, w.smem]
        return out + list(self.dw_smem)


def _gemm_dims(C: int, Ch: int):
    """(O, K) of the six 1x1 products' W [O][K]: forward W_in, W_pw, W_out;
    backward W_out^T, W_pw^T, W_in^T."""
    return ((Ch, C), (Ch, Ch), (C, Ch), (Ch, C), (Ch, Ch), (C, Ch))


def _wgrad_dims(C: int, Ch: int):
    """(O, K) of the weight gradients dW_out, dW_pw, dW_in."""
    return ((C, Ch), (Ch, Ch), (Ch, C))


def _al(n: int) -> int:
    return -(-n // ALIGN_F) * ALIGN_F


def _param_sizes(C: int, Ch: int, k: int) -> List[int]:
    return [Ch * C, Ch, Ch, 1, Ch * k, Ch, Ch, Ch, 1, Ch * Ch, Ch, Ch, Ch, 1, C * Ch, C]


def _scratch_floats(route, B, C, Ch, T, k, Tp, gemms, wgrads, backward: bool) -> int:
    """Float32 scratch of one call: csrc/tcn_train.cu `carve`'s regions, each
    rounded up to ALIGN_F floats, in its order."""
    wg = route == "wgmma"
    N = B * Ch * Tp
    n = _al(N) * (5 if backward else 3)
    pst = max([Ch, gemms[0].tiles(T), gemms[1].tiles(T)] if wg
              else [Ch, -(-T // _TILE) * -(-Ch // _TILE)])
    n += _al(B * pst * 2) + _al(6 * B) + sum(_al(s) for s in _param_sizes(C, Ch, k))
    if backward:
        n += _al(6 * B) + _al(B * Ch * 3)
        if wg:
            n += _al(B * max(gemms[3].tiles(T), gemms[4].tiles(T)) * Ch * 3)
        n += _al(B * Ch * (1 + k))
        n += _al(max(w.n_split * w.O * w.K for w in wgrads))
        n += _al(max(w.n_split * w.O for w in wgrads))
        if not wg:
            n += _al(C * Ch) + _al(Ch * Ch) + _al(Ch * C)
    if wg:
        n += sum(_al(g.O * g.K // 2) for g in gemms[:6 if backward else 3])
    return n


@functools.lru_cache(maxsize=256)
def _plan(B: int, C: int, Ch: int, T: int, k: int, dtype, dilation: int = 1) -> TcnPlan:
    """The route and launch geometry of one call (`make_plan` in
    csrc/tcn_train.cu computes the same and refuses a plan that differs).

    bf16 x with C and Ch in {64, 128, 256} takes the wgmma route: each 1x1
    product keeps its weight resident and walks column tiles of 128 columns
    of a sample (64 where O = 256: two m-blocks a warpgroup, or where 128
    do not fit), two tile buffers and the epilogue's staging within
    SMEM_MAX; each weight gradient splits the B * ceil(T / 64) chunks of 64
    columns into at most H100_SMS / (O-blocks) fixed ranges, O-blocks of 128
    rows where K = 256, else 256. Everything else (float32, other widths)
    takes the CUDA cores: 64 x 64 tiles, the weight gradients over ranges of
    at least SPLIT_COLS flat B*T columns (at most MAX_SPLIT). Raises
    TcnPlanError where no route takes the shape."""
    if dtype not in _KDT:
        raise TcnPlanError(f"the kernel takes float32/bfloat16 x, not {dtype}")
    if (k % 2 == 0 or k > _MAXK - 1 or min(B, C, Ch, T, k, dilation) <= 0
            or B * T >= 2 ** 31):
        raise TcnPlanError(f"no route for B={B} C={C} Ch={Ch} T={T} k={k} "
                           f"dilation={dilation}")
    wg = dtype == torch.bfloat16 and C in (64, 128, 256) and Ch in (64, 128, 256)
    gemms = []
    for O, K in _gemm_dims(C, Ch):
        if not wg:
            gemms.append(GemmPlan(O, K, _TILE, 0))
            continue
        for nc in ((64,) if O > 128 else (128, 64)):
            smem = 1024 + 2 * O * K + 2 * 2 * nc * K + STAGE_BYTES
            if smem <= SMEM_MAX:
                break
        else:
            raise TcnPlanError(f"O={O} K={K}: no column tile fits {SMEM_MAX} bytes")
        gemms.append(GemmPlan(O, K, nc, smem))
    wgrads = []
    for O, K in _wgrad_dims(C, Ch):
        if wg:
            ob = 128 * (1 if K // 64 >= 4 else 2)
            n_ob = -(-O // ob)
            nch = B * -(-T // WG_COLS)
            n = max(1, min(H100_SMS // n_ob, nch))
            per = -(-nch // n)
            wgrads.append(WgradPlan(O, K, -(-nch // per), per, n_ob,
                                    1024 + 2 * (ob + K) * 128))
        else:
            R = B * T
            n = max(1, min(MAX_SPLIT, -(-R // SPLIT_COLS)))
            per = -(-(-(-R // n)) // _RB) * _RB
            wgrads.append(WgradPlan(O, K, -(-R // per), per, 1, 0))
    pad = ((k - 1) // 2) * dilation
    dw = (4 * (DW_SEG + 2 * pad), 4 * (2 * (DW_SEG + 2 * pad) + DW_SEG))
    if dw[1] > SMEM_MAX:
        raise TcnPlanError(f"dilation {dilation}: the depthwise halo does not fit "
                           f"{SMEM_MAX} bytes")
    route = "wgmma" if wg else "cuda_cores"
    Tp = -(-T // 8) * 8
    scr = [_scratch_floats(route, B, C, Ch, T, k, Tp, gemms, wgrads, bw)
           for bw in (False, True)]
    return TcnPlan(route, Tp, tuple(gemms), tuple(wgrads), dw, *scr)


def _lib():
    from ._build import load

    lib = load("tcn_train")
    if not getattr(lib, "_bound", False):
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.tcn_train_plan_fields.restype = i
        lib.tcn_train_plan.argtypes = [i] * 7 + [p, p]
        lib.tcn_train_plan.restype = i
        lib.tcn_train_fwd.argtypes = [p, p, p, l] + [i] * 8 + [p]
        lib.tcn_train_fwd.restype = i
        lib.tcn_train_bwd.argtypes = [p, p, p, l] + [i] * 8 + [p]
        lib.tcn_train_bwd.restype = i
        lib.tcn_train_error_string.argtypes = [i]
        lib.tcn_train_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def source_plan(B, C, Ch, T, k, dilation, dtype):
    """(plan fields, (forward, backward) scratch floats) as the CUDA source
    computes them, or None where it takes no route: the card-side check of
    `_plan` (the library is built on first use)."""
    lib = _lib()
    n = lib.tcn_train_plan_fields()
    fields, scr = (ctypes.c_int * n)(), (ctypes.c_long * 2)()
    if not lib.tcn_train_plan(B, C, Ch, T, k, dilation, _KDT[dtype],
                              ctypes.addressof(fields), ctypes.addressof(scr)):
        return None
    return list(fields), tuple(scr)


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


def _params(params):
    """(the parameters as the kernel reads them, 1 where they are bf16): one
    dtype for all, float32 or bfloat16, else float32 copies."""
    dt = params[0].dtype
    if dt not in _KDT or any(p.dtype != dt for p in params):
        dt = torch.float32
    return [p if p.dtype == dt and p.is_contiguous() else p.detach().to(dt).contiguous()
            for p in params], _KDT[dt]


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.tcn_train_error_string(err).decode())


def _count(direction: str, route: str):
    key = (direction, route)
    LAUNCHES_BY_ROUTE[key] = LAUNCHES_BY_ROUTE.get(key, 0) + 1


def _launch(fn, x, ptrs, pl, backward, dims, p_bf16):
    lib = _lib()
    n = pl.bwd_scratch if backward else pl.fwd_scratch
    scratch = torch.empty(n, device=x.device, dtype=torch.float32)
    fields = pl.ints()
    plan = (ctypes.c_int * len(fields))(*fields)
    with torch.cuda.device(x.device):
        err = getattr(lib, fn)(ctypes.addressof(ptrs), ctypes.addressof(plan),
                               scratch.data_ptr(), n, *dims, _KDT[x.dtype], p_bf16,
                               torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib, fn)


def _launch_fwd(x, params, dilation):
    global FWD_LAUNCHES
    B, C, Ch, T, kw = _check(x, params)
    pl = _plan(B, C, Ch, T, kw, x.dtype, dilation)
    x = x.contiguous()
    ps, p_bf16 = _params(params)
    y = torch.empty_like(x)
    ptrs = _ptrs([x, *ps, y])
    _launch("tcn_train_fwd", x, ptrs, pl, False,
            (B, C, Ch, T, kw, dilation), p_bf16)
    FWD_LAUNCHES += 1
    _count("fwd", pl.route)
    return y


def _launch_bwd(x, dy, params, dilation):
    global BWD_LAUNCHES
    B, C, Ch, T, kw = _check(x, params)
    pl = _plan(B, C, Ch, T, kw, x.dtype, dilation)
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    ps, p_bf16 = _params(params)
    dx = torch.empty_like(x)
    flat = torch.empty(sum(p.numel() for p in params), device=x.device, dtype=ps[0].dtype)
    grads = list(torch.split(flat, [p.numel() for p in params]))
    grads = [g.view(p.shape) for g, p in zip(grads, params)]
    ptrs = _ptrs([x, dy, *ps, dx, *grads])
    _launch("tcn_train_bwd", x, ptrs, pl, True,
            (B, C, Ch, T, kw, dilation), p_bf16)
    BWD_LAUNCHES += 1
    _count("bwd", pl.route)
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


# The no-grad forward is the `torch.library` op puresound_tpu_torch::tcn_block_train,
# so that `torch.export` records one node a block; its body is `_forward`
# (the kernel on a CUDA tensor, counted in FWD_LAUNCHES, the plain version on
# a CPU tensor), registered on the dispatcher's CPU and CUDA keys; its fake
# body gives the shape only.
_LIB = torch.library.Library("puresound_tpu_torch", "FRAGMENT")
_LIB.define("tcn_block_train(Tensor x, Tensor[] params, int dilation) -> Tensor")
for _key in ("CPU", "CUDA"):
    _LIB.impl("tcn_block_train", _forward, _key)
_tcn_op = torch.ops.puresound_tpu_torch.tcn_block_train.default


@torch.library.register_fake("puresound_tpu_torch::tcn_block_train", lib=_LIB)
def _(x, params, dilation):
    return x.new_empty(x.shape)


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
    return _tcn_op(x, list(params), dilation)

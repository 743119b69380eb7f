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
`csrc/lstm_scan.cu` (built with nvcc at first use) or raises. `_plan`
picks the route before the launch and the C entry computes it again: a
bfloat16 xp and W_hh with H in `TC_WIDTHS` (16, 32, 64, 128) take the
tensor cores (`mma.sync` on h split into exact bf16 pieces, three under float32
dots and one under bfloat16 dots, W_hh's `tc_image` resident in shared
memory); float32 weights or xp and other widths the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .hardware import H100_SMS, SMEM_MAX, sm_count

#: kernel launches since the caller last set it to 0 (one per `_launch`)
LAUNCHES = 0
#: the same launches by route: "tc" (tensor cores) or "cuda" (CUDA cores)
LAUNCHES_BY_ROUTE: dict = {}

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


def split_pieces(h: torch.Tensor, pieces: int = 3) -> list:
    """The tensor-core route's bfloat16 pieces of a float32 h, as the kernel
    writes them: hi = bf16(h), then the rounding of each exact residual. Three
    pieces sum to h exactly (hi + mid + lo == h); one is the bf16 dot's
    rounding of h."""
    out, r = [], h.float()
    for _ in range(pieces):
        out.append(r.to(torch.bfloat16))
        r = r - out[-1].float()
    return out


# -------------------------------------------------------------------- plan
RB = 8               # rows a thread of the CUDA-core kernel (csrc/lstm_gates.cuh)
TC_ROWS = 16         # the tensor-core route's rows a tile (csrc/lstm_scan.cu)
TC_GROUPS = 2        # its groups of warps a CTA, each walking its own tiles
TC_H_MAX = 128       # its widest H
#: the widths it takes: H / 8 chunks of 16 bytes a row, a power of two, so
#: that the row swizzle (chunk j at j ^ (row % min(H / 8, 8))) keeps each
#: chunk in its row; at H = 48, 80, 96 or 112 it would not
TC_WIDTHS = (16, 32, 64, 128)


class LstmScanPlanError(ValueError):
    """An lstm_scan shape for which no route of csrc/lstm_scan.cu fits."""


@dataclass(frozen=True)
class LstmScanPlan:
    """How a call runs (`make_plan` in csrc/lstm_scan.cu computes the same).
    route "tc": persistent CTAs (`grid` = min(tiles / TC_GROUPS, SMs)), each
    of TC_GROUPS groups of warps walking its own tiles of `rows` rows on
    mma.sync over `pieces` bf16 pieces of h; route "cuda": one CTA of `rows`
    rows (row groups of 8) each. `smem`: shared bytes a CTA."""
    route: str
    pieces: int
    rows: int
    grid: int
    smem: int

    def ints(self):
        return [int(self.route == "tc"), self.pieces, self.rows, self.grid, self.smem]


def tc_smem(H: int, pieces: int) -> int:
    """The tensor-core route's shared bytes: W_hh's image (4H x H bf16),
    each group's two h tiles of `pieces` pieces [TC_ROWS][H] bf16 and its
    xp stage (TC_ROWS rows of 4H bf16, each padded by 16 bytes)."""
    return 8 * H * H + TC_GROUPS * (4 * pieces * TC_ROWS * H + TC_ROWS * (8 * H + 16))


@functools.lru_cache(maxsize=256)
def _plan(B: int, H: int, x_bf16: bool, w_bf16: bool, dot_bf16: bool,
          sms: int = H100_SMS) -> LstmScanPlan:
    """The route and layout of a call over B rows (the step count changes
    neither). Tensor cores under bfloat16 xp and W_hh with H a power of two
    from 16 to TC_H_MAX (`TC_WIDTHS`; a float32 xp's stage would not fit
    beside W_hh): 3
    pieces of h under float32 dots, 1 under bfloat16 dots, tiles of TC_ROWS
    rows, TC_GROUPS a CTA, one CTA an SM at most. Else the CUDA cores: row
    groups of 8 as `lstm_gates.cuh` `row_groups` picks them, W_hh (float32)
    staged in tiles of up to 32 rows. Raises LstmScanPlanError where the
    CUDA-core kernel's bytes do not fit."""
    if x_bf16 and w_bf16 and H in TC_WIDTHS:
        pieces = 1 if dot_bf16 else 3
        tiles = -(-B // TC_ROWS)
        return LstmScanPlan("tc", pieces, TC_ROWS, min(-(-tiles // TC_GROUPS), sms),
                            tc_smem(H, pieces))
    from .dual_path_kernel import _row_groups   # (it imports this module)

    bt = RB * _row_groups(B, H, 1, sms)
    smem = 4 * (2 * min(max(65536 // (16 * H), 1), 32) * 4 * H + 2 * H * (bt + 4))
    if smem > SMEM_MAX:
        raise LstmScanPlanError(f"H={H}: the CUDA-core kernel needs {smem} bytes of shared "
                                f"memory, more than {SMEM_MAX}")
    return LstmScanPlan("cuda", 0, bt, -(-B // bt), smem)


def tc_image(w_hh: torch.Tensor) -> torch.Tensor:
    """A bf16 W_hh [H, 4H] as the tensor-core route's shared-memory image
    [4H, H]: `dual_path_kernel.gate_image`'s column order (row n = unit
    group * 32 + gate * 8 + unit in group, K-contiguous), each row's 16-byte
    chunks XOR-swizzled by the row (chunk j at j ^ (n % 8), `hopper::swz2`),
    so the ldmatrix.x4 loads of the B fragments are free of bank conflicts."""
    from .dual_path_kernel import gate_image

    if w_hh.shape[0] not in TC_WIDTHS:
        raise ValueError(f"H={w_hh.shape[0]}: the swizzle keeps a row's chunks in the row "
                         f"only at H in {TC_WIDTHS}")
    img = gate_image(w_hh, ranks=1)[0]
    G, H = img.shape
    nch = H // 8
    n, j = torch.arange(G, device=img.device), torch.arange(nch, device=img.device)
    src = j[None, :] ^ (n[:, None] & (min(nch, 8) - 1))
    return img.view(G, nch, 8).gather(1, src[:, :, None].expand(G, nch, 8)).reshape(G, H)


def tc_weight(w_hh: torch.Tensor) -> torch.Tensor:
    """`tc_image(w_hh)`, cached on the weight's storage and version
    (`dual_path_kernel._cached`): packed once per weight version."""
    from .dual_path_kernel import _cached

    return _cached([w_hh], lambda: tc_image(w_hh))


# -------------------------------------------------------------------- CUDA
def _lib():
    from ._build import load

    lib = load("lstm_scan")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_scan.argtypes = [p] * 7 + [i] * 8 + [p, p]
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
    bf = torch.bfloat16
    plan = _plan(B, H, xp.dtype == bf, w_hh.dtype == bf, dot_dtype == bf,
                 sm_count(xp.device))
    xp, h0, c0 = xp.contiguous(), h0.contiguous(), c0.contiguous()
    if plan.route == "tc":
        w = tc_weight(w_hh)             # 16-byte aligned: a fresh tensor
        if xp.data_ptr() % 16:          # xp's rows come in by bulk copies
            xp = xp.clone()
        # h0 / c0 are read two units at a time (float2 / bf16x2)
        h0, c0 = (t if t.data_ptr() % 8 == 0 else t.clone() for t in (h0, c0))
    else:
        w = w_hh.float().contiguous()   # exact for bf16 weights
        if w.data_ptr() % 16:           # the kernel stages it with 16-byte copies
            w = w.clone()
    y = torch.empty((B, T, H), device=xp.device, dtype=xp.dtype)
    hT, cT = torch.empty_like(h0), torch.empty_like(c0)
    plan_ints = plan.ints()
    lib = _lib()
    with torch.cuda.device(xp.device):
        err = lib.lstm_scan(xp.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(),
                            y.data_ptr(), hT.data_ptr(), cT.data_ptr(), B, T, H,
                            int(reverse), _KDT[xp.dtype], _KDT[h0.dtype],
                            _KDT[w_hh.dtype], _KDT[dot_dtype],
                            (ctypes.c_int * len(plan_ints))(*plan_ints),
                            torch.cuda.current_stream(xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError("lstm_scan launch failed: "
                           + lib.lstm_scan_error_string(err).decode())
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[plan.route] = LAUNCHES_BY_ROUTE.get(plan.route, 0) + 1
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

"""Fused SkiM streaming frames: CUDA kernel wrapper + plain PyTorch version.

Counterpart of puresound_tpu/ops/skim_stream_kernel.py::fused_skim_frames
(`:198`, body `_make_kernel` `:45`). Per frame and block:

    FiLM block:  xn = LN(x); x = (xn @ Wsx + se) * xn + (xn @ Wbx + be)
    Gate block:  u = x @ Win; left = PReLU(LN'(u @ Wl));
                 right = sigmoid(PReLU(LN'(u @ Wrx + ge)));
                 x = x + (left * right) @ Wout      (LN' has eps 1e-8)
    every block: gates = x @ W_ih + h @ W_hh + b   (i, f, g, o)
                 c = f * c + i * g;  h = o * tanh(c)
                 x = x + LN(h @ proj_w + proj_b)

with the (h, c) of every block carried across the F frames. Every LayerNorm
is the kernel's two-pass one (`:34-37`), where the module's cLN is
single-pass: fused and unfused Gate streaming differ at rounding level.
Loads are in the input dtype (float32 or bfloat16), elementwise math in
float32; with `dot_dtype=bfloat16` each dot's operands are rounded to bf16
and summed in float32. h/c are written back in the state's dtype and y in
x's dtype.

`int8_hh` runs the recurrent h @ W_hh as int8 x int8 -> int32 (JAX's
`dot_hh`, `:71-78`): h quantized at the fixed scale 1/127 (clip(round(h *
127), +-127), round half to even), W_hh per output column
(`ops/quant.py::quantize_cols`),
the sum times scale / 127^2. `int8_full` also quantizes the FiLM dots, W_ih
(per-row dynamic scale of the unbounded activation, `dot_dyn` `:80-85`) and
the projection (fixed scale); the other dots keep `dot_dtype`, the Gate's
four among them (`:63-64`). The int8 weights replace their float ones in
the flat tuple, each followed by its [N] column scales (`block_names`).

Dispatch: a CPU tensor goes to `fused_skim_frames_ref`; a CUDA tensor
launches `csrc/skim_stream.cu` (built with nvcc at first use) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

from .quant import DYN_DIV, HH_DIV, dot_dyn_ref, dot_hh_ref, option_key, pack_int8

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0
#: the same launches by option ("" for none; "int8_hh", "xscr_half", ...)
LAUNCHES_BY_OPTION: dict = {}

#: the dots that int8_full quantizes with a per-row dynamic activation scale
#: (the rest of the quantized dots take h at the fixed 1/127)
_DYN = ("wsx", "wbx", "w_ih")
#: the vectors of a block, kept in float32 whatever the dot dtype
_VEC = ("fg", "fb", "b", "proj_b", "ln_g", "ln_b",
        "g_lg", "g_lb", "g_la", "g_rg", "g_rb", "g_ra")
#: a Gate block's arrays in JAX's order (`:117-120`)
GATE_NAMES = ("g_win", "g_wl", "g_lg", "g_lb", "g_la", "g_wrx", "g_rg",
              "g_rb", "g_ra", "g_wout")


class SkimWeights(tuple):
    """The kernel's flat weight tuple (JAX order) with per-device packed
    copies cached on it, so a caller that keeps the tuple packs once. Its
    tensors must not change in place afterwards (`SkiM._fused_weights`
    builds a new tuple when a parameter does)."""

    def __new__(cls, items):
        obj = super().__new__(cls, items)
        obj.packed = {}
        return obj


def _check_options(fusion_modes: Sequence[str]):
    bad = [m for m in fusion_modes if m not in ("", "film", "gate")]
    if bad:
        raise ValueError(f"unknown fusion modes {bad}")


def block_names(mode: str, int8_hh: bool = False,
                int8_full: bool = False) -> tuple:
    """One block's weight names in JAX's flat order (`:93-120`): a quantized
    matrix is followed by its column scales (`<name>_s`)."""
    int8_hh = int8_hh or int8_full
    q = lambda name, on: (name, name + "_s") if on else (name,)
    if mode == "film":
        fusion = q("wsx", int8_full) + q("wbx", int8_full) + ("fg", "fb")
    else:
        fusion = GATE_NAMES if mode == "gate" else ()
    return (fusion + q("w_ih", int8_full) + q("w_hh", int8_hh) + ("b",)
            + q("proj_w", int8_full) + ("proj_b", "ln_g", "ln_b"))


def _unpack(weights: Sequence[torch.Tensor], fusion_modes: Sequence[str],
            int8_hh: bool = False,
            int8_full: bool = False) -> List[Dict[str, torch.Tensor]]:
    blocks, idx = [], 0
    for mode in fusion_modes:
        names = block_names(mode, int8_hh, int8_full)
        blocks.append(dict(zip(names, weights[idx:idx + len(names)])))
        idx += len(names)
    if idx != len(weights):
        raise ValueError(f"weight tuple has {len(weights)} entries, the "
                         f"fusion modes {tuple(fusion_modes)} need {idx}")
    return blocks


def _ln(x, g, b, eps=1e-5):
    """The kernel's two-pass LayerNorm (`skim_stream_kernel.py:34-37`)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def _prelu(x, alpha):
    """PReLU with one slope, as the kernel writes it (`:40-42`)."""
    return x.clamp_min(0.0) + alpha * x.clamp_max(0.0)


def dequant_scale(name: str, scale: torch.Tensor) -> torch.Tensor:
    """A column scale as the kernel multiplies it in, divided in its own
    dtype as JAX divides it: scale / 127 for the dynamic dots (`dot_dyn`),
    scale / 127^2 for the fixed-scale ones (`dot_hh`)."""
    return scale / (DYN_DIV if name in _DYN else HH_DIV)


def fused_skim_frames_ref(x, se, be, ge, seg_h, seg_c, weights,
                          fusion_modes, dot_dtype=torch.float32,
                          int8_hh: bool = False, int8_full: bool = False):
    """Plain PyTorch version of `fused_skim_frames`: a loop over frames and
    blocks with the kernel's cast points. Math runs in float32 (float64
    inputs stay float64)."""
    _check_options(fusion_modes)
    cdt = torch.promote_types(x.dtype, torch.float32)
    rnd = ((lambda a: a.to(torch.bfloat16).to(cdt))
           if dot_dtype == torch.bfloat16 else (lambda a: a.to(cdt)))

    def prep(k, v):
        if k.endswith("_s"):
            return dequant_scale(k[:-2], v).to(cdt)
        return v.to(cdt) if k in _VEC or v.dtype == torch.int8 else rnd(v)

    blocks = [{k: prep(k, v) for k, v in blk.items()}
              for blk in _unpack(weights, fusion_modes, int8_hh, int8_full)]

    def dot(a, blk, name):
        """a @ W, through the int8 product when W is quantized."""
        if name + "_s" not in blk:
            return rnd(a) @ blk[name]
        fn = dot_dyn_ref if name in _DYN else dot_hh_ref
        return fn(a, blk[name], blk[name + "_s"])

    h = list(seg_h.to(cdt).unbind(0))
    c = list(seg_c.to(cdt).unbind(0))
    H = seg_h.shape[-1]
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t].to(cdt)
        for i, blk in enumerate(blocks):
            if fusion_modes[i] == "film":
                xn = _ln(xt, blk["fg"], blk["fb"])
                scale = dot(xn, blk, "wsx") + se[i].to(cdt)
                bias = dot(xn, blk, "wbx") + be[i].to(cdt)
                xt = scale * xn + bias
            elif fusion_modes[i] == "gate":
                u = dot(xt, blk, "g_win")
                left = _prelu(_ln(dot(u, blk, "g_wl"), blk["g_lg"], blk["g_lb"],
                                  eps=1e-8), blk["g_la"])
                right = torch.sigmoid(_prelu(
                    _ln(dot(u, blk, "g_wrx") + ge[i].to(cdt), blk["g_rg"],
                        blk["g_rb"], eps=1e-8), blk["g_ra"]))
                xt = xt + dot(left * right, blk, "g_wout")
            gates = dot(xt, blk, "w_ih") + dot(h[i], blk, "w_hh") + blk["b"]
            ii = torch.sigmoid(gates[:, :H])
            ff = torch.sigmoid(gates[:, H:2 * H])
            gg = torch.tanh(gates[:, 2 * H:3 * H])
            oo = torch.sigmoid(gates[:, 3 * H:])
            c[i] = ff * c[i] + ii * gg
            h[i] = oo * torch.tanh(c[i])
            proj = dot(h[i], blk, "proj_w") + blk["proj_b"]
            xt = xt + _ln(proj, blk["ln_g"], blk["ln_b"])
        ys.append(xt.to(x.dtype))
    return (torch.stack(ys, dim=1), torch.stack(h).to(seg_h.dtype),
            torch.stack(c).to(seg_c.dtype))


# ------------------------------------------------------------------- CUDA
_KDT = {torch.float32: 0, torch.bfloat16: 1}


def _pack(weights, fusion_modes, C, H, dot_dtype, device, int8_hh, int8_full):
    """One matrix buffer in dot_dtype and one float32 vector buffer, with a
    fixed per-block stride (FiLM slots zero for unconditioned blocks) —
    the layout `csrc/skim_stream.cu` indexes. Under int8_hh / int8_full also
    an int32 buffer of the quantized matrices (`pack_int8`, wsx wbx w_ih
    w_hh proj_w a block; a float matrix's slot is zero there and a quantized
    one's zero in the matrix buffer) and a float32 buffer of their scales
    as `dequant_scale` gives them. A Gate block's arrays go to `_pack_gate`."""
    mats, vecs, qmats, scales = [], [], [], []
    zeros = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt, device=device)
    shapes = {"wsx": (C, C), "wbx": (C, C), "w_ih": (C, 4 * H),
              "w_hh": (H, 4 * H), "proj_w": (H, C)}
    quantized = int8_hh or int8_full
    blocks = _unpack(weights, fusion_modes, int8_hh, int8_full)
    for mode, blk in zip(fusion_modes, blocks):
        for name, shape in shapes.items():
            w = blk.get(name)
            if w is None:                          # an unconditioned block's FiLM
                w = zeros(*shape)
            q = name + "_s" in blk
            mats.append(zeros(*shape) if q else w)
            if quantized:
                qmats.append(pack_int8(w.to(device)) if q else
                             zeros(shape[0] // 4, shape[1], dt=torch.int32))
                scales.append(dequant_scale(name, blk[name + "_s"]).float() if q else
                              zeros(shape[1]))
        if mode == "film":
            vecs += [blk["fg"], blk["fb"]]
        else:
            vecs.append(zeros(2 * C))
        vecs += [blk["b"], blk["proj_b"], blk["ln_g"], blk["ln_b"]]
    w_mat = torch.cat([m.reshape(-1).to(device=device, dtype=dot_dtype)
                       for m in mats])
    w_vec = torch.cat([v.reshape(-1).to(device=device, dtype=torch.float32)
                       for v in vecs])
    n = len(fusion_modes)
    if (w_mat.numel() != n * (2 * C * C + 4 * H * C + 4 * H * H + H * C)
            or w_vec.numel() != n * (2 * C + 4 * H + 3 * C)):
        raise ValueError("weight shapes do not match C/H of the state")
    if not quantized:
        return w_mat, w_vec, None, None
    w_q = torch.cat([m.reshape(-1) for m in qmats])
    w_s = torch.cat([v.reshape(-1).to(device) for v in scales])
    return w_mat, w_vec, w_q, w_s


def _pack_gate(weights, fusion_modes, C, dot_dtype, device, int8_hh, int8_full):
    """The Gate blocks' arrays as `csrc/skim_stream.cu` indexes them: a
    matrix buffer in dot_dtype (win [C, Hg], wl, wrx [Hg, Hg], wout [Hg, C]
    a block) and a float32 vector buffer (lg lb rg rb [Hg], la ra a block),
    zero for the other blocks; (None, None, 0) without a Gate block. All
    Gate blocks share one width Hg."""
    blocks = _unpack(weights, fusion_modes, int8_hh, int8_full)
    Hg = next((blk["g_win"].shape[1] for blk in blocks if "g_win" in blk), 0)
    if not Hg:
        return None, None, 0
    shapes = {"g_win": (C, Hg), "g_wl": (Hg, Hg), "g_wrx": (Hg, Hg),
              "g_wout": (Hg, C), "g_lg": (Hg,), "g_lb": (Hg,), "g_rg": (Hg,),
              "g_rb": (Hg,), "g_la": (1,), "g_ra": (1,)}
    mats, vecs = [], []
    for blk in blocks:
        for name, shape in shapes.items():
            w = blk.get(name, torch.zeros(shape, device=device))
            if tuple(w.shape) != shape:
                raise ValueError(f"Gate weight {name} is {tuple(w.shape)}, the kernel "
                                 f"takes one width Hg = {Hg}: {shape}")
            (mats if w.dim() == 2 else vecs).append(w)
    cat = lambda ts, dt: torch.cat([t.reshape(-1).to(device=device, dtype=dt)
                                    for t in ts])
    return cat(mats, dot_dtype), cat(vecs, torch.float32), Hg


def _packed(weights, fusion_modes, C, H, dot_dtype, device, int8_hh, int8_full):
    key = (tuple(fusion_modes), dot_dtype, str(device), int8_hh, int8_full)
    cache = getattr(weights, "packed", None)
    if cache is not None and key in cache:
        return cache[key]
    with torch.no_grad():
        buf = (_pack(weights, fusion_modes, C, H, dot_dtype, device, int8_hh,
                     int8_full)
               + _pack_gate(weights, fusion_modes, C, dot_dtype, device, int8_hh,
                            int8_full))
    if cache is not None:
        cache[key] = buf
    return buf


def _lib():
    from ._build import load

    lib = load("skim_stream")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skim_stream_frames.argtypes = [p] * 15 + [i] * 12 + [p]
        lib.skim_stream_frames.restype = i
        lib.skim_dp4a_rate.argtypes = [p, i, i, p]
        lib.skim_dp4a_rate.restype = i
        lib.skim_stream_error_string.argtypes = [i]
        lib.skim_stream_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _launch(x, se, be, ge, seg_h, seg_c, weights, fusion_modes, dot_dtype,
            int8_hh: bool = False, int8_full: bool = False):
    global LAUNCHES
    B, F, C = x.shape
    n, _, H = seg_h.shape
    dev = x.device
    for name, t in (("se", se), ("be", be), ("ge", ge), ("seg_h", seg_h),
                    ("seg_c", seg_c)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype not in _KDT or seg_h.dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, "
                        f"state {seg_h.dtype})")
    if (se.dtype != x.dtype or be.dtype != x.dtype or ge.dtype != x.dtype
            or seg_c.dtype != seg_h.dtype):
        raise TypeError("se/be/ge must share x's dtype and seg_c seg_h's")
    if dot_dtype not in _KDT:
        raise TypeError(f"dot_dtype must be float32 or bfloat16, not {dot_dtype}")
    if (se.shape != (n, B, C) or be.shape != (n, B, C) or seg_c.shape != seg_h.shape
            or seg_h.shape[1] != B or len(fusion_modes) != n
            or ge.dim() != 3 or ge.shape[:2] != (n, B)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, se "
                         f"{tuple(se.shape)}, ge {tuple(ge.shape)}, seg_h "
                         f"{tuple(seg_h.shape)}, {len(fusion_modes)} fusion modes")
    if B == 0 or F == 0:
        raise ValueError("empty stream batch or chunk")
    int8_hh = int8_hh or int8_full
    if int8_hh and (C % 4 or H % 4):
        raise ValueError(f"the int8 products take C and H in steps of 4 (C {C}, H {H})")
    w_mat, w_vec, w_q, w_s, g_mat, g_vec, Hg = _packed(
        weights, fusion_modes, C, H, dot_dtype, dev, int8_hh, int8_full)
    if Hg and ge.shape[2] != Hg:
        raise ValueError(f"ge is {tuple(ge.shape)}, the Gate weights are {Hg} wide")
    y = torch.empty_like(x)
    h_out = torch.empty_like(seg_h)
    c_out = torch.empty_like(seg_c)
    mask = lambda kind: sum(1 << i for i, m in enumerate(fusion_modes) if m == kind)
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.skim_stream_frames(
            x.data_ptr(), se.data_ptr(), be.data_ptr(), ge.data_ptr(),
            seg_h.data_ptr(), seg_c.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), w_mat.data_ptr(), w_vec.data_ptr(), ptr(w_q),
            ptr(w_s), ptr(g_mat), ptr(g_vec),
            B, F, C, H, ge.shape[2], n, mask("film"), mask("gate"),
            _KDT[x.dtype], _KDT[seg_h.dtype], _KDT[dot_dtype],
            int(int8_hh) | (int(int8_full) << 1), stream)
    if err != 0:
        raise RuntimeError("skim_stream_frames launch failed: "
                           + lib.skim_stream_error_string(err).decode())
    LAUNCHES += 1
    key = option_key(int8_hh=int8_hh and not int8_full, int8_full=int8_full)
    LAUNCHES_BY_OPTION[key] = LAUNCHES_BY_OPTION.get(key, 0) + 1
    return y, h_out, c_out


def fused_skim_frames(x, se, be, ge, seg_h, seg_c, weights, fusion_modes,
                      dot_dtype=torch.float32, int8_hh: bool = False,
                      int8_full: bool = False):
    """Run F frames through all SkiM blocks with the per-block (h, c) kept
    on chip for the whole chunk.

    Args:
        x: [B, F, C] input frames.
        se/be: [n_blocks, B, C] frame-invariant FiLM embed terms (zeros for
            unconditioned blocks).
        ge: [n_blocks, B, Hg] frame-invariant Gate embed terms (the embed
            columns of right_conv; zeros for other blocks, Hg = 1 when no
            block is a Gate).
        seg_h/seg_c: [n_blocks, B, H] SegLSTM carries.
        weights: flat per-block tuple in `block_names` order: [wsx, wbx, fg,
            fb] for FiLM blocks, `GATE_NAMES` for Gate blocks, then [w_ih,
            w_hh, b, proj_w, proj_b, ln_g, ln_b], each quantized matrix
            followed by its scales; pass a
            `SkimWeights` to pack it once per device.
        fusion_modes: per block "", "film" or "gate".
        int8_hh / int8_full: the int8 products (module doc).

    Returns: (y [B, F, C], seg_h' [n_blocks, B, H], seg_c').
    """
    _check_options(fusion_modes)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, se, be, ge, seg_h, seg_c, *weights)):
        raise NotImplementedError(
            "fused_skim_frames is a serving kernel with no backward, by design "
            "as in JAX (ROADMAP: training runs lstm_scan_train_fp); call it "
            "under torch.no_grad()")
    if x.device.type == "cpu":
        return fused_skim_frames_ref(x, se, be, ge, seg_h, seg_c, weights,
                                     fusion_modes, dot_dtype, int8_hh, int8_full)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch(x, se, be, ge, seg_h, seg_c, weights, fusion_modes, dot_dtype,
                   int8_hh, int8_full)


def dp4a_rate(out: torch.Tensor, iters: int) -> int:
    """Launch `csrc/skim_stream.cu`'s __dp4a issue-rate loop on `out` (int32
    on a card, a multiple of 256 elements: one CTA of 256 threads per 256)
    and return the dp4a it issues, each 4 multiply-adds; time it to read the
    card's int8 rate on the CUDA cores. A probe, not a serving kernel: it
    adds to no launch count."""
    if not (out.is_cuda and out.dtype == torch.int32 and out.is_contiguous()
            and out.numel() % 256 == 0 and iters % 8 == 0):
        raise ValueError("out must be contiguous int32 on a card, numel a multiple "
                         "of 256, and iters a multiple of 8")
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.skim_dp4a_rate(out.data_ptr(), out.numel() // 256, iters,
                                 torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError("dp4a probe launch failed: "
                           + lib.skim_stream_error_string(err).decode())
    return out.numel() * iters * 8

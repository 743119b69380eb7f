"""Fused SkiM streaming frames: CUDA kernel wrapper + plain PyTorch version.

Counterpart of puresound_tpu/ops/skim_stream_kernel.py::fused_skim_frames
(`:198`, body `_make_kernel` `:45`). Per frame and block:

    FiLM block:  xn = LN(x); x = (xn @ Wsx + se) * xn + (xn @ Wbx + be)
    every block: gates = x @ W_ih + h @ W_hh + b   (i, f, g, o)
                 c = f * c + i * g;  h = o * tanh(c)
                 x = x + LN(h @ proj_w + proj_b)

with the (h, c) of every block carried across the F frames. Loads are in
the input dtype (float32 or bfloat16), elementwise math in float32; with
`dot_dtype=bfloat16` each dot's operands are rounded to bf16 and summed in
float32. h/c are written back in the state's dtype and y in x's dtype.

Dispatch: a CPU tensor goes to `fused_skim_frames_ref`; a CUDA tensor
launches `csrc/skim_stream.cu` (built with nvcc at first use) or raises.
Gate conditioning, `int8_hh` and `int8_full` are not ported yet and raise
on both paths (ROADMAP queue 2).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0

_TODO = ("fused_skim_frames {what} is not ported yet (ROADMAP queue 2: "
         "'fused_skim_frames Gate / int8_hh / int8_full')")
_FILM = ("wsx", "wbx", "fg", "fb")
_LSTM = ("w_ih", "w_hh", "b", "proj_w", "proj_b", "ln_g", "ln_b")


class SkimWeights(tuple):
    """The kernel's flat weight tuple (JAX order) with per-device packed
    copies cached on it, so a caller that keeps the tuple packs once. Its
    tensors must not change in place afterwards (`SkiM._fused_weights`
    builds a new tuple when a parameter does)."""

    def __new__(cls, items):
        obj = super().__new__(cls, items)
        obj.packed = {}
        return obj


def _check_options(fusion_modes: Sequence[str], int8_hh: bool, int8_full: bool):
    if any(m == "gate" for m in fusion_modes):
        raise NotImplementedError(_TODO.format(what="Gate fusion"))
    if int8_hh:
        raise NotImplementedError(_TODO.format(what="int8_hh"))
    if int8_full:
        raise NotImplementedError(_TODO.format(what="int8_full"))
    bad = [m for m in fusion_modes if m not in ("", "film")]
    if bad:
        raise ValueError(f"unknown fusion modes {bad}")


def _unpack(weights: Sequence[torch.Tensor],
            fusion_modes: Sequence[str]) -> List[Dict[str, torch.Tensor]]:
    blocks, idx = [], 0
    for mode in fusion_modes:
        names = (_FILM if mode == "film" else ()) + _LSTM
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


def fused_skim_frames_ref(x, se, be, ge, seg_h, seg_c, weights,
                          fusion_modes, dot_dtype=torch.float32,
                          int8_hh: bool = False, int8_full: bool = False):
    """Plain PyTorch version of `fused_skim_frames`: a loop over frames and
    blocks with the kernel's cast points. Math runs in float32 (float64
    inputs stay float64)."""
    _check_options(fusion_modes, int8_hh, int8_full)
    del ge  # Gate conditioning only
    cdt = torch.promote_types(x.dtype, torch.float32)
    rnd = ((lambda a: a.to(torch.bfloat16).to(cdt))
           if dot_dtype == torch.bfloat16 else (lambda a: a.to(cdt)))
    blocks = [{k: v.to(cdt) if k in ("fg", "fb", "b", "proj_b", "ln_g", "ln_b")
               else rnd(v) for k, v in blk.items()}
              for blk in _unpack(weights, fusion_modes)]
    h = list(seg_h.to(cdt).unbind(0))
    c = list(seg_c.to(cdt).unbind(0))
    H = seg_h.shape[-1]
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t].to(cdt)
        for i, blk in enumerate(blocks):
            if fusion_modes[i] == "film":
                xn = _ln(xt, blk["fg"], blk["fb"])
                scale = rnd(xn) @ blk["wsx"] + se[i].to(cdt)
                bias = rnd(xn) @ blk["wbx"] + be[i].to(cdt)
                xt = scale * xn + bias
            gates = rnd(xt) @ blk["w_ih"] + rnd(h[i]) @ blk["w_hh"] + blk["b"]
            ii = torch.sigmoid(gates[:, :H])
            ff = torch.sigmoid(gates[:, H:2 * H])
            gg = torch.tanh(gates[:, 2 * H:3 * H])
            oo = torch.sigmoid(gates[:, 3 * H:])
            c[i] = ff * c[i] + ii * gg
            h[i] = oo * torch.tanh(c[i])
            proj = rnd(h[i]) @ blk["proj_w"] + blk["proj_b"]
            xt = xt + _ln(proj, blk["ln_g"], blk["ln_b"])
        ys.append(xt.to(x.dtype))
    return (torch.stack(ys, dim=1), torch.stack(h).to(seg_h.dtype),
            torch.stack(c).to(seg_c.dtype))


# ------------------------------------------------------------------- CUDA
_KDT = {torch.float32: 0, torch.bfloat16: 1}


def _pack(weights, fusion_modes, C, H, dot_dtype, device):
    """One matrix buffer in dot_dtype and one float32 vector buffer, with a
    fixed per-block stride (FiLM slots zero for unconditioned blocks) —
    the layout `csrc/skim_stream.cu` indexes."""
    mats, vecs = [], []
    for mode, blk in zip(fusion_modes, _unpack(weights, fusion_modes)):
        if mode == "film":
            mats += [blk["wsx"], blk["wbx"]]
            vecs += [blk["fg"], blk["fb"]]
        else:
            mats.append(torch.zeros(2 * C * C, device=device))
            vecs.append(torch.zeros(2 * C, device=device))
        mats += [blk["w_ih"], blk["w_hh"], blk["proj_w"]]
        vecs += [blk["b"], blk["proj_b"], blk["ln_g"], blk["ln_b"]]
    w_mat = torch.cat([m.reshape(-1).to(device=device, dtype=dot_dtype)
                       for m in mats])
    w_vec = torch.cat([v.reshape(-1).to(device=device, dtype=torch.float32)
                       for v in vecs])
    n = len(fusion_modes)
    if (w_mat.numel() != n * (2 * C * C + 4 * H * C + 4 * H * H + H * C)
            or w_vec.numel() != n * (2 * C + 4 * H + 3 * C)):
        raise ValueError("weight shapes do not match C/H of the state")
    return w_mat, w_vec


def _packed(weights, fusion_modes, C, H, dot_dtype, device):
    key = (tuple(fusion_modes), dot_dtype, str(device))
    cache = getattr(weights, "packed", None)
    if cache is not None and key in cache:
        return cache[key]
    with torch.no_grad():
        buf = _pack(weights, fusion_modes, C, H, dot_dtype, device)
    if cache is not None:
        cache[key] = buf
    return buf


def _lib():
    from ._build import load

    lib = load("skim_stream")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skim_stream_frames.argtypes = [p] * 10 + [i] * 9 + [p]
        lib.skim_stream_frames.restype = i
        lib.skim_stream_error_string.argtypes = [i]
        lib.skim_stream_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _launch(x, se, be, seg_h, seg_c, weights, fusion_modes, dot_dtype):
    global LAUNCHES
    B, F, C = x.shape
    n, _, H = seg_h.shape
    dev = x.device
    for name, t in (("se", se), ("be", be), ("seg_h", seg_h), ("seg_c", seg_c)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype not in _KDT or seg_h.dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, "
                        f"state {seg_h.dtype})")
    if se.dtype != x.dtype or be.dtype != x.dtype or seg_c.dtype != seg_h.dtype:
        raise TypeError("se/be must share x's dtype and seg_c seg_h's")
    if dot_dtype not in _KDT:
        raise TypeError(f"dot_dtype must be float32 or bfloat16, not {dot_dtype}")
    if se.shape != (n, B, C) or be.shape != (n, B, C) or seg_c.shape != seg_h.shape \
            or seg_h.shape[1] != B or len(fusion_modes) != n:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, se "
                         f"{tuple(se.shape)}, seg_h {tuple(seg_h.shape)}, "
                         f"{len(fusion_modes)} fusion modes")
    if B == 0 or F == 0:
        raise ValueError("empty stream batch or chunk")
    w_mat, w_vec = _packed(weights, fusion_modes, C, H, dot_dtype, dev)
    y = torch.empty_like(x)
    h_out = torch.empty_like(seg_h)
    c_out = torch.empty_like(seg_c)
    film_mask = sum(1 << i for i, m in enumerate(fusion_modes) if m == "film")
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.skim_stream_frames(
            x.data_ptr(), se.data_ptr(), be.data_ptr(), seg_h.data_ptr(),
            seg_c.data_ptr(), y.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            w_mat.data_ptr(), w_vec.data_ptr(), B, F, C, H, n, film_mask,
            _KDT[x.dtype], _KDT[seg_h.dtype], _KDT[dot_dtype], stream)
    if err != 0:
        raise RuntimeError("skim_stream_frames launch failed: "
                           + lib.skim_stream_error_string(err).decode())
    LAUNCHES += 1
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
        ge: [n_blocks, B, Hg] Gate embed terms (Gate is not ported; unused).
        seg_h/seg_c: [n_blocks, B, H] SegLSTM carries.
        weights: flat per-block tuple, [wsx, wbx, fg, fb] for FiLM blocks,
            then [w_ih, w_hh, b, proj_w, proj_b, ln_g, ln_b]; pass a
            `SkimWeights` to pack it once per device.
        fusion_modes: per block "" or "film".

    Returns: (y [B, F, C], seg_h' [n_blocks, B, H], seg_c').
    """
    _check_options(fusion_modes, int8_hh, int8_full)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, se, be, seg_h, seg_c, *weights)):
        raise NotImplementedError(
            "fused_skim_frames has no backward yet (ROADMAP: training slice); "
            "call it under torch.no_grad()")
    if x.device.type == "cpu":
        return fused_skim_frames_ref(x, se, be, ge, seg_h, seg_c, weights,
                                     fusion_modes, dot_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch(x, se, be, seg_h, seg_c, weights, fusion_modes, dot_dtype)

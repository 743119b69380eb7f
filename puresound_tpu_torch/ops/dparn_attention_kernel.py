"""DPARN's intra-frequency attention pass: CUDA wrapper + plain version.

Counterpart of puresound_tpu/ops/dparn_attention_kernel.py::dparn_intra_pass
(`:220`, pallas_call at `:252`). Per row (one stream's frame) of F frequency
tokens x [F, C], two post-norm transformer encoder layers, then FC +
LayerNorm:

  layer(x, pe):  q, k, v = (x + pe) @ Wq, Wk, Wv       (pe on layer 1 only)
                 per head: p = softmax(q_h k_h^T / sqrt(Dh));  o_h = p v_h
                 x = LN(x + o @ Wo);  x = LN(x + relu(x @ W1 + b1) @ W2 + b2)
  y = LN(x @ Wfc + bfc)

LN is the two-pass LayerNorm with eps 1e-5 (`_ln` `:46`). Every dot rounds
its operands to `dot_dtype` (the attention weights too) and sums in float32;
the softmax and the norms run in float32 (float64 stays float64 in the plain
version); y comes back in x's dtype. The 28 weights are JAX's flat order,
`ATTN_LAYER_NAMES` per layer then (fc_k, fc_b, nrm_g, nrm_b), products laid
out [in, out]. JAX's three `variant`s (perhead, headbatch, blockdiag) are the
same function: all run the one kernel here.

Dispatch: a CPU tensor runs `dparn_intra_pass_ref`; a CUDA tensor launches
`csrc/dparn_attention.cu` (built with nvcc at first use) or raises.
`r_tile` / `interpret` are TPU settings and have no counterpart. `plan`
picks the kernel's route before the launch (wgmma for the model's geometry
under bf16 weights and dots, else CUDA cores, one row a CTA);
the C entry computes the plan again and refuses one that differs.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Sequence

import torch

from .hardware import H100_SMS, SMEM_MAX, sm_count
from .lstm_scan_kernel import _rounder

#: kernel launches since the caller last set it to 0 (one per `_launch`)
LAUNCHES = 0
#: the same launches by the plan's path ("wgmma", "cuda_cores")
LAUNCHES_BY_PATH: dict = {}

ATTN_LAYER_NAMES = ("wqT", "wkT", "wvT", "woT", "ln1_g", "ln1_b",
                    "ff1_k", "ff1_b", "ff2_k", "ff2_b", "ln2_g", "ln2_b")
N_WEIGHTS = 2 * len(ATTN_LAYER_NAMES) + 4
VARIANTS = ("perhead", "headbatch", "blockdiag")
EPS = 1e-5

_KDT = {torch.float32: 0, torch.bfloat16: 1}


def _ln(t, scale, bias):
    mean = t.mean(dim=-1, keepdim=True)
    var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
    return (t - mean) * torch.rsqrt(var + EPS) * scale + bias


def attention_encoder_layer_ref(x, pe, w, heads: int, rnd):
    """One encoder layer on x [R, F, C] in the compute dtype; `pe` [F, C] or
    None; `w` maps ATTN_LAYER_NAMES to weights; `rnd` casts a dot operand."""
    R, F, C = x.shape
    cdt, Dh = x.dtype, C // heads
    xq = x + pe if pe is not None else x
    q, k, v = (rnd(xq) @ rnd(w[n]) for n in ("wqT", "wkT", "wvT"))
    split = lambda a: a.reshape(R, F, heads, Dh).transpose(1, 2)      # [R, h, F, Dh]
    logits = rnd(split(q)) @ rnd(split(k)).transpose(-1, -2) / math.sqrt(Dh)
    p = torch.softmax(logits, dim=-1)
    o = (rnd(p) @ rnd(split(v))).transpose(1, 2).reshape(R, F, C)
    vec = lambda n: w[n].to(cdt)
    x = _ln(x + rnd(o) @ rnd(w["woT"]), vec("ln1_g"), vec("ln1_b"))
    ff = torch.relu(rnd(x) @ rnd(w["ff1_k"]) + vec("ff1_b"))
    return _ln(x + rnd(ff) @ rnd(w["ff2_k"]) + vec("ff2_b"), vec("ln2_g"), vec("ln2_b"))


def intra_core_ref(x, pe, weights, heads: int, rnd):
    """Both layers, FC and LayerNorm on x [R, F, C] in the compute dtype."""
    n = len(ATTN_LAYER_NAMES)
    layers = [dict(zip(ATTN_LAYER_NAMES, weights[i * n:(i + 1) * n])) for i in range(2)]
    fc_k, fc_b, nrm_g, nrm_b = weights[2 * n:]
    x = attention_encoder_layer_ref(x, pe, layers[0], heads, rnd)
    x = attention_encoder_layer_ref(x, None, layers[1], heads, rnd)
    cdt = x.dtype
    return _ln(rnd(x) @ rnd(fc_k) + fc_b.to(cdt), nrm_g.to(cdt), nrm_b.to(cdt))


def _variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")


def dparn_intra_pass_ref(x, pe, weights, heads: int, dot_dtype=torch.float32,
                         variant: str = "perhead"):
    """Plain version with the kernel's cast points: y [R, F, C] in x's dtype."""
    _variant(variant)
    cdt, rnd = _rounder(x.dtype, dot_dtype)
    return intra_core_ref(x.to(cdt), pe.to(cdt), list(weights), heads, rnd).to(x.dtype)


# -------------------------------------------------------------------- plan
PATHS = ("cuda_cores", "wgmma")     # csrc/dparn_attention.cuh `Path`
# the wgmma route's geometry and layout (csrc/dparn_wgmma.cuh)
WG_F, WG_C, WG_HEADS = 64, 128, 8
WG_WARPGROUPS, WG_STAGES, WG_PRODUCTS = 2, 3, 13
WG_SMEM = (1024 + WG_STAGES * WG_C * WG_C * 2 + WG_WARPGROUPS * 4 * WG_F * WG_C * 2
           + 2 * WG_STAGES * 8)


class AttnPlanError(ValueError):
    """A dparn_intra_pass shape for which no route of the kernel fits."""


@dataclass(frozen=True)
class AttnPlan:
    """How `csrc/dparn_attention.cu` runs one call: the path, rows a CTA
    works on at once (one per consumer warpgroup on wgmma), consumer
    warpgroups (0: the one-row kernel's 8 plain warps), stages of the weight
    ring (2: the one-row kernel's double-buffered tiles of `kt` rows), its
    shared-memory bytes and CTAs (persistent on wgmma, one a row else)."""
    path: str
    rows_per_cta: int
    warpgroups: int
    stages: int
    kt: int
    smem: int
    ctas: int

    def ints(self):
        """The plan as the C entry takes it."""
        return [PATHS.index(self.path), self.rows_per_cta, self.warpgroups, self.stages,
                self.kt, self.smem, self.ctas]


def plan(R: int, F: int, C: int, FFD: int, heads: int, w_bf16: bool, dot_bf16: bool,
         sms: int = H100_SMS) -> AttnPlan:
    """The route of one call over R rows of [F, C] (`make_plan` in
    csrc/dparn_attention.cuh computes the same). wgmma takes F = 64, C = FFD
    = 128, 8 heads under bf16 weights and dots: two rows a CTA, one per
    consumer warpgroup, a 3-slot ring of [128 x 128] weight images, at most
    `sms` persistent CTAs. Everything else runs one row a CTA with its
    activations in float32 shared memory and the weights in double-buffered
    tiles of kt rows (the largest power of two up to 64 that fits), on CUDA
    cores. Raises AttnPlanError where nothing fits 232,448 bytes."""
    if R <= 0 or F <= 0 or C <= 0 or FFD <= 0 or heads <= 0:
        raise AttnPlanError(f"no route for R={R}, F={F}, C={C}, FFD={FFD}, heads={heads}")
    if (w_bf16 and dot_bf16 and (F, C, FFD, heads) == (WG_F, WG_C, WG_C, WG_HEADS)):
        return AttnPlan("wgmma", WG_WARPGROUPS, WG_WARPGROUPS, WG_STAGES, 0, WG_SMEM,
                        min((R + 1) // 2, sms))
    CM = max(C, FFD)
    act = 4 * (4 * C + CM + F) * (F + 4)
    wsz = 2 if w_bf16 else 4
    kt = 64
    while kt > 1 and act + wsz * 2 * kt * CM > SMEM_MAX:
        kt //= 2
    smem = act + wsz * 2 * kt * CM
    if smem > SMEM_MAX:
        raise AttnPlanError(f"F={F}, C={C}, FFD={FFD}: one row needs {smem} bytes of "
                            f"shared memory, more than {SMEM_MAX}")
    return AttnPlan("cuda_cores", 1, 0, 2, kt, smem, R)


def packed_scratch(pl: AttnPlan, dev, blocks: int = 1):
    """The wgmma route's repacked weights (13 images of 128 x 128 bf16 a
    block), or None."""
    if pl.path != "wgmma":
        return None
    return torch.empty(blocks * WG_PRODUCTS * WG_C * WG_C, device=dev, dtype=torch.bfloat16)


# -------------------------------------------------------------------- CUDA
def _lib():
    from ._build import load

    lib = load("dparn_attention")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dparn_intra_pass.argtypes = [p] * 5 + [i] * 9 + [p] * 3
        lib.dparn_intra_pass.restype = i
        lib.dparn_attention_error_string.argtypes = [i]
        lib.dparn_attention_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def weight_shapes(C: int, FFD: int):
    """The 28 weights' shapes in the flat order."""
    layer = [(C, C)] * 4 + [(C,), (C,), (C, FFD), (FFD,), (FFD, C), (C,), (C,), (C,)]
    return layer * 2 + [(C, C), (C,), (C,), (C,)]


def check_geometry(F: int, C: int, FFD: int, heads: int):
    """Raise unless the kernel takes this geometry."""
    if not (0 < F <= 64 and F % 4 == 0):
        raise ValueError(f"the kernel takes 0 < F <= 64 tokens in steps of 4, got {F}")
    if not (0 < C <= 128 and C % 8 == 0 and 0 < FFD <= 128 and FFD % 8 == 0):
        raise ValueError(f"the kernel takes C and the feed-forward width in (0, 128] "
                         f"in steps of 8, got {C} / {FFD}")
    if heads <= 0 or C % heads:
        raise ValueError(f"{heads} heads do not split C = {C}")


def check_weights(weights: Sequence[torch.Tensor], C: int, device):
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"{N_WEIGHTS} weights expected, got {len(weights)}")
    FFD = weights[6].shape[-1]
    wdt = weights[0].dtype
    if wdt not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 weights, got {wdt}")
    for i, (w, want) in enumerate(zip(weights, weight_shapes(C, FFD))):
        if tuple(w.shape) != want or w.dtype != wdt or w.device != device:
            raise ValueError(f"weight {i} is {tuple(w.shape)} {w.dtype} on {w.device}, "
                             f"not {want} {wdt} on {device}")
    return FFD, wdt


def aligned(weights):
    """Contiguous weights on 16-byte boundaries (the kernel stages them with
    16-byte copies)."""
    ws = [w.contiguous() for w in weights]
    return [w if w.data_ptr() % 16 == 0 else w.clone() for w in ws]


def as_views(weights):
    """Weights for a kernel that reads matrices through their strides (a
    pack kernel repacks them): matrices as they are, vectors as `aligned`
    makes them."""
    return [w if w.dim() == 2 or (w.is_contiguous() and w.data_ptr() % 16 == 0)
            else aligned([w])[0] for w in weights]


def strides_of(ws):
    """Each weight's (in, out) strides in elements, flat, for the C entry."""
    flat = []
    for w in ws:
        st = w.stride()
        flat += st if len(st) == 2 else (st[0], 0)
    return (ctypes.c_long * len(flat))(*flat)


def _launch(x, pe, weights, heads, dot_dtype):
    global LAUNCHES
    if x.dim() != 3:
        raise ValueError(f"x must be [R, F, C], got {tuple(x.shape)}")
    R, F, C = x.shape
    FFD, wdt = check_weights(weights, C, x.device)
    check_geometry(F, C, FFD, heads)
    if x.dtype not in _KDT or pe.dtype not in _KDT or dot_dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, pe "
                        f"{pe.dtype}, dot {dot_dtype})")
    if tuple(pe.shape) != (F, C) or pe.device != x.device:
        raise ValueError(f"pe must be [F, C] = {(F, C)} on {x.device}")
    if R == 0 or R * F * C >= 2 ** 31:
        raise ValueError(f"the kernel takes 0 < R * F * C < 2^31, x {tuple(x.shape)}")
    pl = plan(R, F, C, FFD, heads, wdt == torch.bfloat16, dot_dtype == torch.bfloat16,
              sm_count(x.device))
    x, pe = x.contiguous(), pe.contiguous()
    # the wgmma path's pack kernel reads the matrices through their strides
    ws = as_views(weights) if pl.path == "wgmma" else aligned(weights)
    y = torch.empty_like(x)
    packed = packed_scratch(pl, x.device)
    ptrs = (ctypes.c_void_p * N_WEIGHTS)(*[w.data_ptr() for w in ws])
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.dparn_intra_pass(
            x.data_ptr(), pe.data_ptr(), ptrs, strides_of(ws), y.data_ptr(), R, F, C, FFD, heads,
            _KDT[x.dtype], _KDT[pe.dtype], _KDT[wdt], _KDT[dot_dtype],
            (ctypes.c_int * 7)(*pl.ints()), None if packed is None else packed.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("dparn_intra_pass launch failed: "
                           + lib.dparn_attention_error_string(err).decode())
    LAUNCHES += 1
    LAUNCHES_BY_PATH[pl.path] = LAUNCHES_BY_PATH.get(pl.path, 0) + 1
    return y


def dparn_intra_pass(x, pe, weights, heads: int, dot_dtype=torch.float32,
                     variant: str = "perhead"):
    """The fused intra pass: x [R, F, C] rows of frequency tokens, pe [F, C]
    (layer 1 only), the 28 flat weights. Returns y [R, F, C], the value
    DPARNblock2D adds to its residual."""
    _variant(variant)
    if x.device.type == "cpu":
        return dparn_intra_pass_ref(x, pe, weights, heads, dot_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch(x, pe, list(weights), heads, dot_dtype)

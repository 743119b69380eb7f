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
`_plan` picks the route before the launch and the C entry computes it again:
under bf16 dots at C = 128 (Hg = 128 with a Gate) and n >= 2 blocks, the
tensor-core kernel of `csrc/skim_stream_tc.cuh` (clusters of K CTAs that split
the hidden units, tiles of M streams, every product on mma.sync, the weights
streamed through a ring from the images `tc_image` packs); else the CUDA-core
kernel. `LAUNCHES_BY_ROUTE` counts the launches by route.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from .hardware import SMEM_MAX
from .quant import DYN_DIV, HH_DIV, dot_dyn_ref, dot_hh_ref, option_key, pack_int8

#: kernel launches since the last reset (the wrapper adds one per launch)
LAUNCHES = 0
#: the same launches by option ("" for none; "int8_hh", "xscr_half", ...)
LAUNCHES_BY_OPTION: dict = {}
#: the same launches by route: "mma" (tensor cores, csrc/skim_stream_tc.cuh)
#: or "cuda" (CUDA cores)
LAUNCHES_BY_ROUTE: dict = {}

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


# -------------------------------------------------------------------- plan
STAGE_ROWS = 256       # a ring stage of the tensor-core route: 256 rows of 64 bytes
STAGE_BYTES = 16384
MAX_DEPTH = 8          # ring stages at most
SCR_LD = 264           # floats a row of the product scratch
TC_C = 128             # the width the tensor-core route takes (its row passes)
TC_HG = 128            # and the Gate's
#: clusters of 2 / 4 / 8 CTAs of the tensor-core kernel in flight on an H100
#: 80GB HBM3 (cudaOccupancyMaxActiveClusters at one CTA an SM, read by
#: chip_smoke.py phase 2): the plan's counts where no card is asked
H100_CLUSTERS = {2: 66, 4: 30, 8: 15}


class SkimPlanError(ValueError):
    """A fused_skim_frames shape for which no route of csrc/skim_stream.cu fits."""


@dataclass(frozen=True)
class SkimPlan:
    """How a call runs (`make_plan` in csrc/skim_stream_tc.cuh computes the
    same). route "mma": clusters of K CTAs over tiles of M streams, a ring of
    `depth` stages, `stages` ring stages a frame; route "cuda": the CUDA-core
    kernel (K = M = depth = stages = 0). `smem`: shared bytes a block."""
    route: str
    K: int
    M: int
    depth: int
    smem: int
    stages: int

    def ints(self):
        return [int(self.route == "mma"), self.K, self.M, self.depth, self.smem,
                self.stages]


def stages_of(kin: int, N: int, int8: bool) -> int:
    """Ring stages of a product of `kin` input rows and N columns: a stage
    holds 256 / N k-slices of 32 bf16 (or 64 int8) values a column."""
    return kin // ((64 if int8 else 32) * (STAGE_ROWS // N))


def _tiles_stages(kin: int, N: int, int8: bool) -> bool:
    return (N > 0 and STAGE_ROWS % N == 0
            and kin % ((64 if int8 else 32) * (STAGE_ROWS // N)) == 0)


def tc_smem(M: int, K: int, C: int, H: int, n: int, q_hh: bool, q_full: bool,
            depth: int) -> int:
    """Shared bytes of a tensor-core CTA: alignment, the ring, x / LN(x) /
    scratch (float32), the A tile (bf16; int8 + row amax under int8_full), the
    gathered h tile and this CTA's h slices of every block (bf16 unless
    int8_full, int8 under int8_hh), c of its units, the mbarriers."""
    U = H // K
    b = 1024 + depth * STAGE_BYTES
    b += 2 * M * C * 4 + M * SCR_LD * 4 + M * 128 * 2
    if q_full:
        b += M * 128 + M * 4
    if not q_full:
        b += M * H * 2 + n * M * U * 2
    if q_hh:
        b += M * H + n * M * U
    return b + n * M * U * 4 + 2 * depth * 8


def gate_passes(U: int) -> int:
    """The passes of a CTA's gate products (4U columns, at most 256 a pass)."""
    return 2 if 4 * U > 256 else 1


def body_stages(C, H, Hg, fusion_modes, K, q_hh, q_full) -> int:
    """Ring stages of one frame: per block W_hh's slice, a projection, the
    fusion's products, W_ih's slice (the slices pass by pass)."""
    P = gate_passes(H // K)
    N = 4 * (H // K) // P
    s = 0
    for mode in fusion_modes:
        s += P * stages_of(H, N, q_hh) + stages_of(H, C, q_full) + P * stages_of(C, N, q_full)
        if mode == "film":
            s += stages_of(C, 2 * C, q_full)
        elif mode == "gate":
            s += stages_of(C, Hg, False) + stages_of(Hg, 2 * Hg, False) + stages_of(Hg, C, False)
    return s


def cuda_smem(C: int, H: int, Hg: int, n: int) -> int:
    """The CUDA-core kernel's shared bytes (8 streams a CTA)."""
    BT, kq = 8, max(C, H) // 4
    return (4 * (2 * n * BT * H + 4 * BT * C + BT * H) + 4 * (BT * kq + BT * H // 4)
            + 4 * (BT + 3 * BT * Hg))


def _plan(B: int, C: int, H: int, Hg: int, fusion_modes: Sequence[str], dot_bf16: bool,
          int8_hh: bool = False, int8_full: bool = False,
          clusters: Optional[Dict[int, int]] = None) -> SkimPlan:
    """The route and layout of a call. Tensor cores under bf16 dots at C =
    TC_C (Hg = TC_HG with a Gate block) and n >= 2 blocks: among (K, M) in
    the order (H/32, 16), (H/64, 16), (H/32, 32), (H/64, 32), (H/128, 16),
    with U = H / K of 32, 64 or 128 (the gate products in two passes, 16
    rows a tile only) and 2 <= K <= 8, the first with the fewest ring stages a CTA
    streams in all: its waves of the clusters of K in flight (`clusters`, the
    card's cudaOccupancyMaxActiveClusters; H100_CLUSTERS where none is given)
    times the stages of a frame (on the H100 a stage costs about the same at
    M = 16 and 32: PERF.md §6); the ring as deep as fits (at most 8).
    Else the CUDA-core kernel, whose bytes must fit too. Raises
    SkimPlanError where nothing does."""
    clusters = clusters or H100_CLUSTERS
    q_hh, q_full = bool(int8_hh or int8_full), bool(int8_full)
    n = len(fusion_modes)
    gate = "gate" in fusion_modes
    best = None
    if dot_bf16 and C == TC_C and (not gate or Hg == TC_HG) and n >= 2:
        for K, M in ((H // 32, 16), (H // 64, 16), (H // 32, 32), (H // 64, 32),
                     (H // 128, 16)):
            if not 2 <= K <= 8 or H % K:
                continue
            U = H // K
            N = 4 * U // gate_passes(U)
            if (U not in (32, 64) and (U, M) != (128, 16)) or not all(_tiles_stages(*a) for a in (
                    (H, N, q_hh), (C, N, q_full), (H, C, q_full), (C, 2 * C, q_full))):
                continue
            if gate and not all(_tiles_stages(*a) for a in (
                    (C, Hg, False), (Hg, 2 * Hg, False), (Hg, C, False))):
                continue
            depth = min(MAX_DEPTH, (SMEM_MAX - tc_smem(M, K, C, H, n, q_hh, q_full, 0))
                        // (STAGE_BYTES + 16))
            if depth < 2 or clusters.get(K, 0) < 1:
                continue
            waves = -(-(-(-B // M)) // clusters[K])
            stages = body_stages(C, H, Hg, fusion_modes, K, q_hh, q_full)
            if best is None or waves * stages < best[0]:
                best = (waves * stages, SkimPlan("mma", K, M, depth,
                                                 tc_smem(M, K, C, H, n, q_hh, q_full, depth),
                                                 stages))
    if best is not None:
        return best[1]
    smem = cuda_smem(C, H, Hg, n)
    if smem > SMEM_MAX:
        raise SkimPlanError(f"C={C}, H={H}, Hg={Hg}, {n} blocks: the CUDA-core kernel "
                            f"needs {smem} bytes of shared memory, more than {SMEM_MAX}")
    return SkimPlan("cuda", 0, 0, 0, smem, 0)


# ------------------------------------------------------------ weight images
def gate_columns(H: int, K: int, rank: int) -> torch.Tensor:
    """The gate columns (q * H + unit) of rank `rank`'s 4U image columns: warp
    w of 8 takes U / 2 of them, 16 a quad of units, i, f of the quad in the
    first 8-column n-tile (unit u at 2u, 2u + 1), g, o in the second, so that
    each thread of the mma.sync layout holds the four gates of its unit."""
    U = H // K
    n = torch.arange(4 * U)
    w, rem = n // (U // 2), n % (U // 2)
    pp, t = rem // 16, rem % 16
    unit = rank * U + w * (U // 8) + 4 * pp + (t % 8) // 2
    gate = 2 * (t // 8) + t % 2
    return gate * H + unit


def stage_image(w: torch.Tensor) -> torch.Tensor:
    """A product's weight w [kin, N] (bf16 or int8, columns in the kernel's
    order) as ring stages [stages, 16384] of bytes: stage s holds k-slices
    s * sps .. of 32 bf16 / 64 int8 values (sps = 256 / N), a 64-byte row per
    column, slice by slice; each row's four 16-byte chunks XOR-swizzled by
    (row / 2) % 4, as the kernel's ldmatrix.x4 addresses read them."""
    kin, N = w.shape
    int8 = w.dtype == torch.int8
    ks, sps = (64 if int8 else 32), STAGE_ROWS // N
    nst = stages_of(kin, N, int8)
    rows = w.reshape(nst, sps, ks, N).permute(0, 1, 3, 2).reshape(nst, STAGE_ROWS, ks)
    rows = rows.contiguous()
    raw = rows.view(torch.uint8) if int8 else rows.view(torch.int16).view(torch.uint8)
    chunks = raw.reshape(nst, STAGE_ROWS, 4, 16)
    r = torch.arange(STAGE_ROWS, device=w.device)[:, None]
    c = torch.arange(4, device=w.device)[None, :]
    return chunks[:, r, c ^ ((r >> 1) & 3)].reshape(nst, STAGE_BYTES)


def unstage_image(img: torch.Tensor, kin: int, N: int, int8: bool) -> torch.Tensor:
    """`stage_image`'s inverse: the [kin, N] weight (bf16, or int8)."""
    ks, sps = (64 if int8 else 32), STAGE_ROWS // N
    nst = img.shape[0]
    chunks = img.reshape(nst, STAGE_ROWS, 4, 16)
    r = torch.arange(STAGE_ROWS, device=img.device)[:, None]
    c = torch.arange(4, device=img.device)[None, :]
    raw = chunks[:, r, c ^ ((r >> 1) & 3)].reshape(nst, STAGE_ROWS, 64).contiguous()
    rows = raw.view(torch.int8) if int8 else raw.view(torch.int16).view(torch.bfloat16)
    rows = rows.reshape(nst, sps, N, ks).permute(0, 1, 3, 2)
    return rows.reshape(kin, N)


def image_products(fusion_modes: Sequence[str], passes: int = 1) -> list:
    """The products of one frame's image in the kernel's order, (block,
    product, pass) triples: per block i "w_hh" pass by pass, the projection
    of block i - 1 (of block n - 1 at i = 0), the fusion ("film", or
    "g_win", "g_lr", "g_wout"), "w_ih" pass by pass."""
    n = len(fusion_modes)
    out = []
    for i, mode in enumerate(fusion_modes):
        out += [(i, "w_hh", p) for p in range(passes)] + [((i - 1) % n, "proj_w", 0)]
        if mode == "film":
            out.append((i, "film", 0))
        elif mode == "gate":
            out += [(i, "g_win", 0), (i, "g_lr", 0), (i, "g_wout", 0)]
        out += [(i, "w_ih", p) for p in range(passes)]
    return out


def product_weight(blk: Dict[str, torch.Tensor], name: str, H: int, K: int, rank: int,
                   int8_hh: bool = False, int8_full: bool = False,
                   gate_pass: int = 0) -> torch.Tensor:
    """One product's [kin, N] weight in the kernel's column order and dtype:
    int8 where the option quantizes it, else bf16; W_hh / W_ih the rank's
    columns of one pass (a pass of a CTA with two takes the columns of
    `gate_columns` at 2K ranks)."""
    q_hh, q_full = int8_hh or int8_full, int8_full
    cast = lambda w, q: w if q else w.to(torch.bfloat16)
    if name in ("w_hh", "w_ih"):
        P = gate_passes(H // K)
        cols = gate_columns(H, K * P, rank * P + gate_pass).to(blk[name].device)
        return cast(blk[name], q_hh if name == "w_hh" else q_full)[:, cols]
    if name == "film":
        return torch.cat([cast(blk["wsx"], q_full), cast(blk["wbx"], q_full)], 1)
    if name == "proj_w":
        return cast(blk[name], q_full)
    if name == "g_lr":
        return torch.cat([blk["g_wl"], blk["g_wrx"]], 1).to(torch.bfloat16)
    return blk[name].to(torch.bfloat16)


def tc_image(weights, fusion_modes, H: int, K: int, int8_hh: bool = False,
             int8_full: bool = False, device=None) -> torch.Tensor:
    """The tensor-core route's weight image: [K ranks, stages a frame, 16384]
    bytes, rank r's stages in the order the kernel consumes them
    (`image_products`), W_hh / W_ih restricted to the rank's gate columns
    (`gate_columns`), the rest whole."""
    blocks = _unpack(weights, fusion_modes, int8_hh, int8_full)
    products = image_products(fusion_modes, gate_passes(H // K))
    ranks = []
    with torch.no_grad():
        for rank in range(K):
            ranks.append(torch.cat([
                stage_image(product_weight(blocks[i], name, H, K, rank, int8_hh, int8_full,
                                           gate_pass).to(device))
                for i, name, gate_pass in products]))
    return torch.stack(ranks).contiguous()


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


def _image(weights, fusion_modes, H, K, device, int8_hh, int8_full):
    """`tc_image` cached on the SkimWeights like `_packed`'s buffers."""
    key = (tuple(fusion_modes), "image", K, str(device), int8_hh, int8_full)
    cache = getattr(weights, "packed", None)
    if cache is not None and key in cache:
        return cache[key]
    img = tc_image(weights, fusion_modes, H, K, int8_hh, int8_full, device)
    if cache is not None:
        cache[key] = img
    return img


_CLUSTERS: dict = {}


def tc_clusters(dev) -> Dict[int, int]:
    """{K: clusters of K CTAs of the tensor-core kernel in flight} on the
    card (cudaOccupancyMaxActiveClusters, asked once per device)."""
    key = str(dev)
    if key not in _CLUSTERS:
        lib = _lib()
        with torch.cuda.device(dev):
            _CLUSTERS[key] = {K: lib.skim_tc_clusters(K) for K in (2, 4, 8)}
    return _CLUSTERS[key]


_PLANS: dict = {}


def plan_on(dev, B, C, H, Hg, fusion_modes, dot_dtype, int8_hh=False,
            int8_full=False) -> SkimPlan:
    """`_plan` with the card's clusters in flight: the plan a launch takes
    (memoized: a serving tick asks for the same one every time)."""
    key = (str(dev), B, C, H, Hg, tuple(fusion_modes), dot_dtype, int8_hh, int8_full)
    if key not in _PLANS:
        _PLANS[key] = _plan(B, C, H, Hg, fusion_modes, dot_dtype == torch.bfloat16, int8_hh,
                            int8_full, tc_clusters(dev))
    return _PLANS[key]


def _lib():
    from ._build import load

    lib = load("skim_stream")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.skim_stream_frames.argtypes = [p] * 15 + [i] * 12 + [p] * 3
        lib.skim_stream_frames.restype = i
        lib.skim_tc_clusters.argtypes = [i]
        lib.skim_tc_clusters.restype = i
        lib.skim_dp4a_rate.argtypes = [p, i, i, p]
        lib.skim_dp4a_rate.restype = i
        lib.skim_stream_error_string.argtypes = [i]
        lib.skim_stream_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def count_launch(plan: SkimPlan, int8_hh: bool = False, int8_full: bool = False):
    """Add one launch to LAUNCHES, LAUNCHES_BY_OPTION and LAUNCHES_BY_ROUTE."""
    global LAUNCHES
    LAUNCHES += 1
    key = option_key(int8_hh=int8_hh and not int8_full, int8_full=int8_full)
    LAUNCHES_BY_OPTION[key] = LAUNCHES_BY_OPTION.get(key, 0) + 1
    LAUNCHES_BY_ROUTE[plan.route] = LAUNCHES_BY_ROUTE.get(plan.route, 0) + 1


def _launch(x, se, be, ge, seg_h, seg_c, weights, fusion_modes, dot_dtype,
            int8_hh: bool = False, int8_full: bool = False):
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
    plan = plan_on(dev, B, C, H, ge.shape[2], fusion_modes, dot_dtype, int8_hh, int8_full)
    img = (_image(weights, fusion_modes, H, plan.K, dev, int8_hh, int8_full)
           if plan.route == "mma" else None)
    # the tensor-core kernel reads x / se / be / ge rows 8 or 16 bytes at a time
    x, se, be, ge = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, se, be, ge))
    y = torch.empty_like(x)
    h_out = torch.empty_like(seg_h)
    c_out = torch.empty_like(seg_c)
    mask = lambda kind: sum(1 << i for i, m in enumerate(fusion_modes) if m == kind)
    ptr = lambda t: t.data_ptr() if t is not None else None
    plan_ints = plan.ints()
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
            int(int8_hh) | (int(int8_full) << 1),
            (ctypes.c_int * len(plan_ints))(*plan_ints), ptr(img), stream)
    if err != 0:
        raise RuntimeError("skim_stream_frames launch failed: "
                           + lib.skim_stream_error_string(err).decode())
    count_launch(plan, int8_hh, int8_full)
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


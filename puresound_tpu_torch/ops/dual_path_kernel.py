"""DPCRN's dual-path bottleneck for one chunk: CUDA wrapper + plain version.

Counterpart of puresound_tpu/ops/dual_path_kernel.py::dual_path_chunk
(`:357`, pallas_call at `:433`, body `dual_path_body` `:94-168`). Per
block, on the activation x [F, K, B, CH] (kept in float32 between passes):

  intra: a bidirectional LSTM over the F axis, rows (frame, stream), zero
         initial state; then x += LN(yf @ pw_f + yb @ pw_b + pb)
  inter: an LSTM over the K frames, rows (freq, stream), from the carried
         h / c [F, B, H]; per frame x += LN(h @ pw_i + pb_i)

LN is the two-pass LayerNorm over CH with eps 1e-5 (`_ln` `:37`). The gate
order is torch's i, f, g, o, the LSTM biases come summed. Every dot rounds
its operands to `dot_dtype` and sums in float32; the carries run in
float32; yf / yb hold the dot dtype's values; y comes back in x's dtype and
the carries in theirs (bf16 serving rounds h / c between chunks, as JAX
does). Layouts and the flat weight order (18 per block, `_PER_BLOCK`
`:52-60`) are JAX's, see `NAMES`.

`int8_hh` runs the three recurrent products of a block (intra forward /
backward, inter) as int8 x int8 -> int32 (JAX's `dot_hh`, `make_dots`
`:63-77`): h at the fixed scale 1/127, each w_hh per output column, so a
block's weights are 21, each w_hh followed by its [4H] scales
(`block_names`, `_block_weights` `:80-92`). `xscr_half` stores the residual
activation (the scratch between passes) in bfloat16 and rounds it at every
write: the first copy of x, the intra residual add and each inter step's
add (`:140-142`, `:165-167`, `:421-424`); the arithmetic stays float32.

Dispatch: a CPU tensor runs `dual_path_chunk_ref`; a CUDA tensor launches
`csrc/dual_path.cu` (built with nvcc at first use) or raises. `_plan` picks
the route before the launch and the C entry computes it again: under bf16
weights and dots at the widths the tensor-core passes take (CH in {64, 128},
H in {32, 64, 128}) the intra and inter scans run on mma.sync in clusters of
2 CTAs and the intra projection on wgmma (`csrc/dual_path_tc.cuh`), with the
weights in the images `tc_images` packs; else the CUDA-core passes. JAX's
`b_tile` / `sub_tiles` are TPU tilings with the same numbers and have no
counterpart here.
"""
from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from typing import List, Sequence

import torch

from .hardware import H100_SMS, SMEM_MAX, sm_count
from .lstm_scan_kernel import _rounder, lstm_cell
from .quant import HH_DIV, dot_hh_ref, option_key, pack_int8

#: kernel launches since the caller last set it to 0 (one per `_launch`)
LAUNCHES = 0
#: the same launches by option ("" for none; "int8_hh", "xscr_half", ...)
LAUNCHES_BY_OPTION: dict = {}
#: pass launches by pass and route, "A:mma" / "B:wgmma" / "C:mma" on the
#: tensor cores, "A:cuda" / ... on the CUDA cores: one per block a pass runs,
#: from this module's and masker_kernel's launches (the DPARN center runs C)
LAUNCHES_BY_PASS: dict = {}

#: one block's weights in JAX's flat order: intra forward / backward LSTM
#: ([CH, 4H], [H, 4H], [4H]), the intra projection split by direction
#: ([H, CH] x 2, [CH]), its LayerNorm, the inter LSTM, its projection
#: ([H, CH], [CH]) and LayerNorm
NAMES = ("w_ih_f", "w_hh_f", "b_f", "w_ih_b", "w_hh_b", "b_b",
         "pw_f", "pw_b", "pb", "ig", "ib",
         "w_ih_i", "w_hh_i", "b_i", "pw_i", "pb_i", "tg", "tb")
PER_BLOCK = len(NAMES)
#: the inter section's weights, the last seven of a block
INTER_NAMES = NAMES[11:]
EPS = 1e-5

_KDT = {torch.float32: 0, torch.bfloat16: 1}


def block_names(int8_hh: bool = False) -> tuple:
    """One block's weight names in JAX's flat order: under int8_hh each
    w_hh is followed by its column scales s_hh_<dir> (`_block_weights`)."""
    if not int8_hh:
        return NAMES
    out = []
    for name in NAMES:
        out.append(name)
        if name.startswith("w_hh_"):
            out.append("s_hh_" + name[-1])
    return tuple(out)


def half_store(cdt):
    """xscr_half's write: round to bfloat16, keep computing in cdt."""
    return lambda a: a.to(torch.bfloat16).to(cdt)


def _ln(t, scale, bias):
    mean = t.mean(dim=-1, keepdim=True)
    var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
    return (t - mean) * torch.rsqrt(var + EPS) * scale + bias


def _hh_dot(rnd, cdt, w_hh, s_hh):
    """h @ w_hh as the kernel takes it: rounded to the dot dtype, or JAX's
    `dot_hh` when s_hh (the column scales of an int8 w_hh) is given."""
    if s_hh is None:
        w = rnd(w_hh)
        return lambda h: rnd(h) @ w
    wq, s = w_hh.to(cdt), (s_hh / HH_DIV).to(cdt)
    return lambda h: dot_hh_ref(h, wq, s)


def inter_block_ref(xs, h, c, weights, rnd, s_hh=None, store=None):
    """The inter section on xs [F, K, B, CH] in the compute dtype: an LSTM
    over the K frames from the carries h / c [F, B, H], and per frame
    x += LN(h @ pw_i + pb_i). `weights` in INTER_NAMES order; s_hh: the
    scales of an int8 w_hh (`dot_hh`); store: the rounding of each written
    frame (xscr_half). Returns (xs', h, c) in the compute dtype."""
    cdt = xs.dtype
    store = store or (lambda a: a)
    w_ih, w_hh, b, pw, pb, g, beta = weights
    hh = _hh_dot(rnd, cdt, w_hh, s_hh)
    w_ih, pw = rnd(w_ih), rnd(pw)
    b, pb, g, beta = (v.to(cdt) for v in (b, pb, g, beta))
    h, c = h.to(cdt), c.to(cdt)
    frames = []
    for k in range(xs.shape[1]):
        h, c = lstm_cell(rnd(xs[:, k]) @ w_ih + hh(h) + b, c)
        frames.append(store(xs[:, k] + _ln(rnd(h) @ pw + pb, g, beta)))
    return torch.stack(frames, dim=1), h, c


def dual_path_chunk_ref(x, h_in: Sequence[torch.Tensor],
                        c_in: Sequence[torch.Tensor], weights,
                        dot_dtype=torch.float32, int8_hh: bool = False,
                        xscr_half: bool = False):
    """Plain version with the kernel's cast points: (y, h_out, c_out)."""
    F, K, B, CH = x.shape
    cdt, rnd = _rounder(x.dtype, dot_dtype)
    store = half_store(cdt) if xscr_half else (lambda a: a)
    names = block_names(int8_hh)
    per = len(names)
    xs = store(x.reshape(F, K * B, CH).to(cdt))
    h_out: List[torch.Tensor] = []
    c_out: List[torch.Tensor] = []
    for blk in range(len(h_in)):
        w = dict(zip(names, weights[blk * per:(blk + 1) * per]))
        dots = {n: rnd(w[n]) for n in ("w_ih_f", "w_ih_b", "pw_f", "pw_b")}
        hh = {d: _hh_dot(rnd, cdt, w["w_hh_" + d], w.get("s_hh_" + d)) for d in "fb"}
        vec = {n: w[n].to(cdt) for n in ("b_f", "b_b", "pb", "ig", "ib")}
        H = w["w_hh_f"].shape[0]
        zero = xs.new_zeros((K * B, H))
        hf, cf, hb, cb = zero, zero, zero, zero
        yf, yb = [None] * F, [None] * F
        for f in range(F):
            hf, cf = lstm_cell(rnd(xs[f]) @ dots["w_ih_f"] + hh["f"](hf) + vec["b_f"], cf)
            yf[f] = rnd(hf)
            fb = F - 1 - f
            hb, cb = lstm_cell(rnd(xs[fb]) @ dots["w_ih_b"] + hh["b"](hb) + vec["b_b"], cb)
            yb[fb] = rnd(hb)
        t = (torch.stack(yf) @ dots["pw_f"] + torch.stack(yb) @ dots["pw_b"]
             + vec["pb"])
        xs = store(xs + _ln(t, vec["ig"], vec["ib"])).reshape(F, K, B, CH)
        xs, h, c = inter_block_ref(xs, h_in[blk], c_in[blk],
                                   [w[n] for n in INTER_NAMES], rnd,
                                   s_hh=w.get("s_hh_i"), store=store)
        xs = xs.reshape(F, K * B, CH)
        h_out.append(h.to(h_in[blk].dtype))
        c_out.append(c.to(c_in[blk].dtype))
    return xs.reshape(F, K, B, CH).to(x.dtype), h_out, c_out


# -------------------------------------------------------------------- plan
RB = 8                 # rows a thread of the CUDA-core passes (lstm_gates.cuh)
B_ROWS = 128           # pass B's rows a tile on wgmma (csrc/dual_path_tc.cuh)
RED_BYTES = 1024       # pass C's LayerNorm sums on the tensor cores
TC_CH, TC_H = (64, 128), (32, 64, 128)   # the widths the tensor-core passes take


class DualPathPlanError(ValueError):
    """A dual-path shape for which no route of csrc/dual_path.cu fits."""


@dataclass(frozen=True)
class DualPathPlan:
    """How the passes of a call run (`make_plan` in csrc/dual_path_tc.cuh
    computes the same). route "mma": A and C on mma.sync chains in clusters
    of 2 CTAs, `a_rows` / `c_rows` rows a tile with `a_xbuf` / `c_xbuf` x
    tile buffers, B on wgmma in tiles of `b_rows`; route "cuda": the
    CUDA-core passes, `*_rows` their row groups of 8 rows. `*_smem`: each
    pass's shared bytes a block."""
    route: str
    a_rows: int
    a_xbuf: int
    a_smem: int
    b_rows: int
    b_smem: int
    c_rows: int
    c_xbuf: int
    c_smem: int

    def ints(self):
        return [int(self.route == "mma"), self.a_rows, self.a_xbuf, self.a_smem,
                self.b_rows, self.b_smem, self.c_rows, self.c_xbuf, self.c_smem]

    @property
    def passes(self) -> dict:
        """{pass: route} (LAUNCHES_BY_PASS's keys)."""
        if self.route == "mma":
            return {"A": "mma", "B": "wgmma", "C": "mma"}
        return {"A": "cuda", "B": "cuda", "C": "cuda"}


def chain_smem(CH: int, H: int, M: int, nbx: int, int8_hh: bool, inter: bool) -> int:
    """Shared bytes of a chain CTA of M rows (pass A, or C with `inter`):
    its halves of W_ih / W_hh, nbx x tiles, two h tiles (bf16, and int8
    under int8_hh), the gate bias (and scales), pass C's PW_i^T, LN sums and
    its bias / LayerNorm vectors (bf16)."""
    NC = 2 * H
    b = NC * CH * 2 + NC * H * (1 if int8_hh else 2) + nbx * M * CH * 2
    b += (2 * M * H * 2 if (not int8_hh or inter) else 0) + (2 * M * H if int8_hh else 0)
    b += NC * 4 * (2 if int8_hh else 1)
    return b + (CH * H * 2 + RED_BYTES + 6 * CH if inter else 0)


def proj_smem(CH: int, H: int) -> int:
    """Pass B on wgmma: 1 KB of alignment, PW^T [CH][2H], two [128][2H] tiles."""
    return 1024 + 4 * CH * H + 2 * B_ROWS * 2 * H * 2


def _pick_rows(rows: int, copies: int, lo: int, hi: int, sms: int) -> int:
    m = lo
    while m < hi:
        if -(-rows // m) * copies <= sms:
            return m
        m *= 2
    return hi


def _row_groups(rows: int, width: int, copies: int, sms: int) -> int:
    """lstm_gates.cuh `row_groups`: row groups of 8 rows a CTA of the
    CUDA-core passes."""
    rg = min(max(512 // width, 1), 64)
    while rg > 1 and -(-rows // (RB * (rg // 2))) * copies <= sms:
        rg //= 2
    return rg


def _plan(F: int, K: int, B: int, CH: int, H: int, w_bf16: bool, dot_bf16: bool,
          int8_hh: bool = False, sms: int = H100_SMS) -> DualPathPlan:
    """The route and layout of a call. Tensor cores under bf16 weights and
    dots with CH in TC_CH and H in TC_H: pass A's row tile the smallest of
    16 .. 128 whose clusters (2 directions x 2 CTAs a tile) fit the SMs once
    (128 where none does), pass C's of 32 or 64 (2 CTAs a tile), each halved
    while it does not fit SMEM_MAX; two x buffers where they fit, else one.
    Else the CUDA-core passes, whose bytes must fit too. Raises
    DualPathPlanError where nothing does."""
    R, NI = K * B, F * B
    NR = F * R
    if w_bf16 and dot_bf16 and CH in TC_CH and H in TC_H:
        ma = _pick_rows(R, 4, 16, 128, sms)
        while ma > 16 and chain_smem(CH, H, ma, 1, int8_hh, False) > SMEM_MAX:
            ma //= 2
        mc = _pick_rows(NI, 2, 32, 64, sms)
        while mc > 32 and chain_smem(CH, H, mc, 1, int8_hh, True) > SMEM_MAX:
            mc //= 2
        if (chain_smem(CH, H, ma, 1, int8_hh, False) <= SMEM_MAX
                and chain_smem(CH, H, mc, 1, int8_hh, True) <= SMEM_MAX
                and proj_smem(CH, H) <= SMEM_MAX):
            xa = 2 if chain_smem(CH, H, ma, 2, int8_hh, False) <= SMEM_MAX else 1
            xc = 2 if chain_smem(CH, H, mc, 2, int8_hh, True) <= SMEM_MAX else 1
            return DualPathPlan("mma", ma, xa, chain_smem(CH, H, ma, xa, int8_hh, False),
                                B_ROWS, proj_smem(CH, H), mc, xc,
                                chain_smem(CH, H, mc, xc, int8_hh, True))
    es = 2 if w_bf16 else 4
    kt = min(max(65536 // (4 * H * es), 1), 32)
    w_bytes = es * 2 * kt * 4 * H
    rg_a, rg_b = _row_groups(R, H, 2, sms), _row_groups(NR, CH, 1, sms)
    rg_c = _row_groups(NI, H, 1, sms)
    bt_a, bt_b, bt_c = RB * rg_a, RB * rg_b, RB * rg_c
    sa = w_bytes + 4 * (CH + 2 * H) * (bt_a + 4)
    sb = 4 * (2 * H * (bt_b + 4) + bt_b * (CH + 1) + 2 * bt_b)
    sc = (w_bytes + 4 * ((CH + 2 * H) * (bt_c + 4) + bt_c * (CH + 1) + 2 * bt_c)
          + (4 * 2 * (H // 4) * (bt_c + 4) if int8_hh else 0))
    if max(sa, sb, sc) > SMEM_MAX:
        raise DualPathPlanError(f"CH={CH}, H={H}: the CUDA-core passes need {sa} / {sb} / "
                                f"{sc} bytes of shared memory, more than {SMEM_MAX}")
    return DualPathPlan("cuda", rg_a, 0, sa, rg_b, sb, rg_c, 0, sc)


def count_passes(plan: DualPathPlan, blocks: int, passes: str = "ABC"):
    """Add a call's pass launches to LAUNCHES_BY_PASS."""
    for p in passes:
        key = f"{p}:{plan.passes[p]}"
        LAUNCHES_BY_PASS[key] = LAUNCHES_BY_PASS.get(key, 0) + blocks


# ------------------------------------------------------------ weight images
def gate_image(w: torch.Tensor, ranks: int = 2) -> torch.Tensor:
    """An LSTM weight [K, 4H] (torch's gate order) as the chain kernel's image
    [ranks, 4H / ranks, K]: rank r's hidden units r*U .. r*U + U - 1 (U = H /
    ranks), row n = unit group * 32 + gate * 8 + unit in group, so that one
    warp's four 8-column n-tiles hold i, f, g, o of the same 8 units; rows are
    K-contiguous (the mma B fragment). Works for bf16 and int8 weights."""
    K, G = w.shape
    H = G // 4
    U = H // ranks
    img = w.t().reshape(4, ranks, U // 8, 8, K).permute(1, 2, 0, 3, 4)
    return img.reshape(ranks, 4 * U, K).contiguous()


def gate_unimage(img: torch.Tensor) -> torch.Tensor:
    """`gate_image`'s inverse: the [K, 4H] weight."""
    ranks, NC, K = img.shape
    U = NC // 4
    w = img.reshape(ranks, U // 8, 4, 8, K).permute(2, 0, 1, 3, 4)
    return w.reshape(4 * ranks * U, K).t().contiguous()


def proj_image(*pws: torch.Tensor) -> torch.Tensor:
    """Projection weights [H_i, CH] stacked along K and transposed: [CH,
    sum H_i], K-contiguous (pass B's [PW_f; PW_b]^T, pass C's PW_i^T)."""
    return torch.cat(pws, dim=0).t().contiguous()


_IMAGES: dict = {}


def _source(w: torch.Tensor) -> torch.Tensor:
    return w._base if w._base is not None else w


def _cached(ws, build):
    """build() memoized on the source tensors: their storage (the view's
    base, held by a weak reference), pointer, strides and in-place version,
    so a changed or freed weight is packed again."""
    key = tuple((id(_source(w)), w.data_ptr(), _source(w)._version, tuple(w.shape),
                 w.stride(), w.dtype) for w in ws)
    hit = _IMAGES.get(key)
    if hit is not None and all(r() is _source(w) for r, w in zip(hit[0], ws)):
        return hit[1]
    out = build()
    if len(_IMAGES) >= 64:
        _IMAGES.pop(next(iter(_IMAGES)))
    _IMAGES[key] = ([weakref.ref(_source(w)) for w in ws], out)
    return out


def tc_images(weights, int8_hh: bool, n_blocks: int) -> list:
    """The tensor-core passes' weight images, 8 a block in the order of
    csrc/dual_path_passes.cuh `IMAGES`: gate_image of W_ih / W_hh of the
    forward, backward and inter LSTMs (each int8 w_hh packed the same way,
    its rows the m16n8k32 B fragment), then proj_image(pw_f, pw_b) and
    proj_image(pw_i). Cached per block on the source weights."""
    names = block_names(int8_hh)
    per = len(names)
    out = []
    for blk in range(n_blocks):
        w = dict(zip(names, weights[blk * per:(blk + 1) * per]))
        mats = [w[n] for n in ("w_ih_f", "w_hh_f", "w_ih_b", "w_hh_b", "w_ih_i", "w_hh_i",
                               "pw_f", "pw_b", "pw_i")]
        out += _cached(mats, lambda m=mats: [gate_image(t) for t in m[:6]]
                       + [proj_image(m[6], m[7]), proj_image(m[8])])
    return out


def inter_images(w_ih, w_hh, pw) -> list:
    """Pass C alone (the DPARN center): gate_image(w_ih), gate_image(w_hh),
    proj_image(pw), cached."""
    return _cached([w_ih, w_hh, pw], lambda: [gate_image(w_ih), gate_image(w_hh),
                                              proj_image(pw)])


# -------------------------------------------------------------------- CUDA
def _lib():
    from ._build import load

    lib = load("dual_path")
    if not getattr(lib, "_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dual_path_chunk.argtypes = [p] * 10 + [i] * 11 + [p] * 4
        lib.dual_path_chunk.restype = i
        lib.dual_path_error_string.argtypes = [i]
        lib.dual_path_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _weight_shape(name: str, CH: int, H: int):
    kind = name[:-2] if name[-2:] in ("_f", "_b", "_i") else name
    return {"w_ih": (CH, 4 * H), "w_hh": (H, 4 * H), "b": (4 * H,),
            "pw": (H, CH), "s_hh": (4 * H,)}.get(kind, (CH,))


def _check(x, h_in, c_in, weights, dot_dtype, int8_hh: bool = False):
    if x.dim() != 4:
        raise ValueError(f"x must be [F, K, B, CH], got {tuple(x.shape)}")
    F, K, B, CH = x.shape
    n = len(h_in)
    names = block_names(int8_hh)
    if n == 0 or len(c_in) != n or len(weights) != len(names) * n:
        raise ValueError(f"{n} blocks need {n} h / c carries and "
                         f"{len(names) * n} weights, got {len(c_in)} / {len(weights)}")
    H = h_in[0].shape[-1]
    sdt, wdt = h_in[0].dtype, weights[0].dtype
    if x.dtype not in _KDT or sdt not in _KDT or wdt not in _KDT or dot_dtype not in _KDT:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16 (x {x.dtype}, "
                        f"carries {sdt}, weights {wdt}, dot {dot_dtype})")
    for t in list(h_in) + list(c_in):
        if t.shape != (F, B, H) or t.dtype != sdt or t.device != x.device:
            raise ValueError(f"carries must be [F, B, H] = {(F, B, H)} of one "
                             f"dtype on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    for i, w in enumerate(weights):
        name = names[i % len(names)]
        want = _weight_shape(name, CH, H)
        dt = (torch.int8 if int8_hh and name.startswith("w_hh") else
              w.dtype if name.startswith("s_hh") and w.dtype in _KDT else wdt)
        if tuple(w.shape) != want or w.dtype != dt or w.device != x.device:
            raise ValueError(f"weight {i} ({name}) is {tuple(w.shape)} {w.dtype} on "
                             f"{w.device}, not {want} {dt} on {x.device}")
    if wdt == torch.bfloat16 and H % 2:
        raise ValueError(f"bfloat16 weights need an even H (16-byte rows), got {H}")
    if int8_hh and H % 4:
        raise ValueError(f"int8_hh packs w_hh 4 rows a word: H must be a multiple of 4, "
                         f"got {H}")
    if not (0 < H <= 512 and 0 < CH <= 512 and F and K and B):
        raise ValueError(f"the kernel takes 0 < H, CH <= 512 and a non-empty "
                         f"chunk: x {tuple(x.shape)}, H {H}")
    if F * K * B * max(CH, 4 * H) >= 2 ** 31:
        raise ValueError("the chunk has 2^31 elements or more")
    return F, K, B, CH, H, n


def kernel_weights(weights, int8_hh: bool, tc: bool = False):
    """The kernel's operands from the flat tuple: PER_BLOCK pointers' worth
    of tensors a block (each int8 w_hh packed into __dp4a words,
    `pack_int8`) and, under int8_hh, the three dequantization scales a block
    (scale / 127^2 in float32); every tensor 16-byte aligned for cp.async.
    `tc`: the tensor-core route, which reads its matrices from `tc_images`
    and only the vectors here (the matrices are passed as they are)."""
    names = block_names(int8_hh)
    mats, scales = [], []
    for i, w in enumerate(weights):
        name = names[i % len(names)]
        if name.startswith("s_hh"):
            scales.append((w / HH_DIV).float().contiguous())
            continue
        if tc and w.dim() == 2:
            mats.append(w)
            continue
        w = pack_int8(w) if int8_hh and name.startswith("w_hh") else w.contiguous()
        mats.append(w if w.data_ptr() % 16 == 0 else w.clone())
    return mats, scales


def _launch(x, h_in, c_in, weights, dot_dtype, int8_hh: bool = False,
            xscr_half: bool = False):
    global LAUNCHES
    F, K, B, CH, H, n = _check(x, h_in, c_in, weights, dot_dtype, int8_hh)
    dev = x.device
    bf = torch.bfloat16
    plan = _plan(F, K, B, CH, H, weights[0].dtype == bf, dot_dtype == bf, int8_hh,
                 sm_count(dev))
    tc = plan.route == "mma"
    x = x.contiguous()
    h_in = [h.contiguous() for h in h_in]
    c_in = [c.contiguous() for c in c_in]
    ws, scales = kernel_weights(weights, int8_hh, tc)
    imgs = tc_images(weights, int8_hh, n) if tc else None
    y = torch.empty_like(x)
    h_out = [torch.empty_like(h) for h in h_in]
    c_out = [torch.empty_like(c) for c in c_in]
    x_scr = torch.empty((F, K * B, CH), device=dev,             # scratch
                        dtype=bf if xscr_half else torch.float32)
    y_dir = torch.empty((2, F, K * B, H), device=dev,           # yf, yb
                        dtype=bf if tc else torch.float32)
    x16 = (torch.empty((F, K * B, CH), device=dev, dtype=bf)   # x_scr's bf16 copy
           if tc and not xscr_half else None)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    plan_ints = plan.ints()
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.dual_path_chunk(
            x.data_ptr(), ptrs(h_in), ptrs(c_in), ptrs(ws),
            ptrs(scales) if int8_hh else None, y.data_ptr(),
            ptrs(h_out), ptrs(c_out), x_scr.data_ptr(), y_dir.data_ptr(),
            n, F, K, B, CH, H, _KDT[x.dtype], _KDT[h_in[0].dtype],
            _KDT[weights[0].dtype], _KDT[dot_dtype], int(xscr_half),
            (ctypes.c_int * len(plan_ints))(*plan_ints), ptrs(imgs) if tc else None,
            None if x16 is None else x16.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("dual_path_chunk launch failed: "
                           + lib.dual_path_error_string(err).decode())
    LAUNCHES += 1
    key = option_key(int8_hh=int8_hh, xscr_half=xscr_half)
    LAUNCHES_BY_OPTION[key] = LAUNCHES_BY_OPTION.get(key, 0) + 1
    count_passes(plan, n)
    return y, h_out, c_out


def dual_path_chunk(x, h_in, c_in, weights, dot_dtype=torch.float32,
                    int8_hh: bool = False, xscr_half: bool = False):
    """Every dual-path block of a chunk.

    x [F, K, B, CH]; h_in / c_in per-block lists of [F, B, H] inter
    carries; weights the flat tuple in `block_names(int8_hh)` order.
    Returns (y [F, K, B, CH], h_out, c_out)."""
    if x.device.type == "cpu":
        return dual_path_chunk_ref(x, h_in, c_in, weights, dot_dtype, int8_hh,
                                   xscr_half)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no kernel for device {x.device}")
    return _launch(x, list(h_in), list(c_in), list(weights), dot_dtype, int8_hh,
                   xscr_half)

"""The launch plan of the serving LSTM scan (`ops/lstm_scan_kernel.py`
`_plan`, which `csrc/lstm_scan.cu` `make_plan` computes again at each
launch) and its tensor-core route's arithmetic: at every shape the port
launches (`chip_smoke.py`'s phase 2d, DPCRN's fused serving at 2,048 slots,
DPARN's at 1,024, a ragged row count), bf16 W_hh at H = 128 takes the
tensor cores (three pieces of h under float32 dots, one under bfloat16
dots), float32 weights, H = 24 and the widths whose rows the swizzle would
not keep (H = 48, 96) the CUDA cores, and the plan equals the one the
source's expressions give. The three bf16 pieces of h sum to h bit
for bit; the product emulated from the packed W_hh image and the h tiles at
the kernel's ldmatrix.x4 addresses (expressions read from the source),
m16n8k16 by its fragment layout, equals the float32 dot within float32
rounding (three pieces) and the bf16 dot (one piece). Pure Python: no card
needed."""
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu_torch.ops import dual_path_kernel as dpk
from puresound_tpu_torch.ops import lstm_scan_kernel as lsk

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
H100_SMS = 132
CSRC = os.path.join(os.path.dirname(os.path.dirname(lsk.__file__)), "csrc")
SRC = open(os.path.join(CSRC, "lstm_scan.cu")).read()
GATES = open(os.path.join(CSRC, "lstm_gates.cuh")).read()
HOPPER = open(os.path.join(CSRC, "hopper.cuh")).read()


# --------------------------------------------------------- the C source
def _ternary(expr: str) -> str:
    """`a ? b : c` (nested in parentheses or not) as Python's `b if a else c`."""
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += ch == "("
        depth -= ch == ")"
        if ch == "?" and depth == 0:
            q = i
        elif ch == ":" and depth == 0 and q is not None:
            return (f"({_ternary(expr[q + 1:i])}) if ({_ternary(expr[:q])}) "
                    f"else ({_ternary(expr[i + 1:])})")
    out, i = "", 0
    while i < len(expr):          # recurse into parentheses
        if expr[i] == "(":
            depth, j = 1, i + 1
            while depth:
                depth += (expr[j] == "(") - (expr[j] == ")")
                j += 1
            out += "(" + _ternary(expr[i + 1:j - 1]) + ")"
            i = j
        else:
            out += expr[i]
            i += 1
    return out


def _py(expr: str) -> str:
    """A C integer expression in Python: no casts or long suffixes, / as //,
    && / || as and / or, ternaries as conditional expressions."""
    expr = re.sub(r"\((?:long|int|size_t)\)", "", expr)
    expr = re.sub(r"\b(\d+)L\b", r"\1", expr)
    expr = expr.replace("&&", " and ").replace("||", " or ").replace(" / ", " // ")
    return _ternary(re.sub(r"\s+", " ", expr).strip())


def _args(text: str) -> list:
    """The comma-separated items of a C list or call, split at depth 0."""
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            out.append(cur)
            cur = ""
        else:
            cur += ch
    return out + [cur]


def _num(name: str, text: str = SRC) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


CONST = {n: _num(n) for n in ("SMEM_MAX", "PLAN_FIELDS", "TC_ROWS", "TC_GROUPS",
                              "TC_H_MAX")}
CONST["RB"] = _num("RB", GATES)


def _row_groups(rows, width, copies, sms):
    """lstm_gates.cuh `row_groups`, run from its source lines."""
    body = re.search(r"inline int row_groups\(.*?\{(.*?)\n\}", GATES, re.S).group(1)
    env = dict(rows=rows, width=width, copies=copies, sms=sms, RB=CONST["RB"])
    env["rg"] = eval(_py(re.search(r"int rg = (.+?);", body).group(1)), {}, env)
    env["rg"] = eval(_py(re.search(r"rg = (rg < 1 .+?);", body).group(1)), {}, env)
    cond = _py(re.search(r"while \((.+?)\) rg /= 2;", body).group(1))
    while eval(cond, {}, env):
        env["rg"] //= 2
    return env["rg"]


def _tile_rows_f32(G):
    """lstm_gates.cuh `tile_rows<float>`, from its source lines."""
    body = re.search(r"inline int tile_rows\(int G\) \{(.*?)\n\}", GATES, re.S).group(1)
    env = dict(G=G)
    env["kt"] = eval(_py(re.search(r"const int kt = (.+?);", body).group(1)
                         .replace("static_cast<int>(sizeof(WT))", "4")), {}, env)
    return eval(_py(re.search(r"return (.+?);", body).group(1)), {}, env)


def source_plan(B, H, x_bf16, w_bf16, dot_bf16, sms=H100_SMS):
    """`make_plan` of csrc/lstm_scan.cu, its expressions evaluated: (fields,
    whether it fits)."""
    body = re.search(r"inline bool make_plan\(.*?\{(.*?)\n\}", SRC, re.S).group(1)
    env = dict(CONST, B=B, H=H, x_bf16=int(x_bf16), w_bf16=int(w_bf16),
               dot_bf16=int(dot_bf16), sms=sms)
    tc_body = re.search(r"inline long tc_smem\(int H, int pieces\) \{\s*return (.+?);",
                        SRC, re.S).group(1)
    tc_smem = lambda H, pieces: eval(_py(tc_body), {}, dict(CONST, H=H, pieces=pieces))
    ev = lambda e: eval(_py(e), {}, dict(env, tc_smem=tc_smem))
    route, rest = body.split("const int bt")
    if ev(re.search(r"if \((.+?)\) \{", route).group(1)):
        for name in ("pieces", "ctas"):
            env[name] = ev(re.search(rf"const int {name} = (.+?);", route).group(1))
        fields = re.search(r"const int v\[PLAN_FIELDS\] = \{(.+?)\};", route, re.S).group(1)
        return [ev(f) for f in _args(fields)], True
    env["bt"] = eval(_py(re.search(r"^ = (.+?);", rest).group(1)
                         .replace("row_groups(B, H, 1, sms)", "rg")), {},
                     dict(env, rg=_row_groups(B, H, 1, sms)))
    smem = _py(re.search(r"const long smem = (.+?);", rest).group(1))
    env["smem"] = eval(smem.replace("tile_rows<float>(4 * H)", str(_tile_rows_f32(4 * H))),
                       {}, env)
    fields = re.search(r"const int v\[PLAN_FIELDS\] = \{(.+?)\};", rest, re.S).group(1)
    fits = ev(re.search(r"return (smem <= SMEM_MAX);", rest).group(1))
    return [ev(f) for f in _args(fields)], fits


# ------------------------------------------------------------- the plan
def _shapes():
    """(label, rows, H) of every lstm_scan launch: phase 2d, the fused
    serving scans of DPCRN (2,048 slots: intra 4,096 x 64 each way, inter
    131,072 x 2) and DPARN (1,024 slots: inter 65,536 x 2; 256: 16,384 x 2),
    a ragged count, the small H = 24 and 16, and H = 48 / 96, multiples of 16
    whose H / 8 chunks a row are no power of two."""
    out = [(f"2d {n}", B, H) for n, B, T, H, *_ in chip_smoke.LSCAN_CASES]
    out += [("DPCRN 2048 intra", 4096, 128), ("DPCRN 2048 inter", 131072, 128),
             ("DPARN 1024 inter", 65536, 128), ("DPARN 256 inter", 16384, 128),
             ("ragged", 1001, 128), ("H=24", 13, 24), ("H=16", 77, 16), ("H=48", 50, 48),
             ("H=96", 300, 96)]
    return out


SHAPES = _shapes()
# (xp bf16, W_hh bf16, dot bf16): the serving route's bf16 xp / W with f32
# dots, then bf16 dots, a float32 xp beside a bf16 W, float32 throughout, and
# float32 weights with bf16 dots
DTYPES = [(True, True, False), (True, True, True), (False, True, False),
          (False, False, False), (True, False, True)]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["x16-w16-dot32", "x16-w16-dot16",
                                                "x32-w16-dot32", "x32-w32-dot32",
                                                "x16-w32-dot16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_plan_route_and_source(shape, dtypes):
    _, B, H = shape
    x_bf16, w_bf16, dot_bf16 = dtypes
    plan = lsk._plan(B, H, x_bf16, w_bf16, dot_bf16)
    fields, fits = source_plan(B, H, x_bf16, w_bf16, dot_bf16)
    assert fits and plan.ints() == fields
    assert len(fields) == CONST["PLAN_FIELDS"] and plan.smem <= SMEM_MAX
    tc = x_bf16 and w_bf16 and H in (16, 32, 64, 128)
    assert lsk.TC_WIDTHS == (16, 32, 64, 128)
    assert plan.route == ("tc" if tc else "cuda")
    if tc:
        # three exact pieces under float32 dots, h's bf16 rounding under bf16
        assert plan.pieces == (1 if dot_bf16 else 3) and plan.rows == 16
        # two groups of warps a CTA, each walking its own 16-row tiles
        assert plan.grid == min(-(-B // 32), H100_SMS)
        # W_hh's image, two h tiles and a padded xp stage a group
        assert plan.smem == 8 * H * H + 2 * (2 * plan.pieces * 16 * H * 2 + 16 * (8 * H + 16))
    else:
        assert plan.pieces == 0 and plan.grid == -(-B // plan.rows)
        assert plan.rows == 8 * dpk._row_groups(B, H, 1, H100_SMS)


def test_serving_points_tile_the_card():
    """The intra scan at 2,048 DPCRN streams is one wave of 128 CTAs, a tile
    a group; the inter scans walk 31-32 (131,072 rows) or 15-16 (65,536)
    tiles a group."""
    for B, grid, per_group in ((4096, 128, 1), (131072, 132, 32), (65536, 132, 16)):
        plan = lsk._plan(B, 128, True, True, False)
        tiles = -(-B // plan.rows)
        assert (plan.grid, -(-tiles // (lsk.TC_GROUPS * plan.grid))) == (grid, per_group)


def test_plan_sms_and_errors():
    assert lsk._plan(4096, 128, True, True, False, sms=114).grid == 114
    assert source_plan(4096, 128, True, True, False, 114)[0] == lsk._plan(
        4096, 128, True, True, False, 114).ints()
    with pytest.raises(lsk.LstmScanPlanError) as e:
        lsk._plan(8, 2048, True, False, False)
    assert isinstance(e.value, ValueError)
    assert not source_plan(8, 2048, True, False, False)[1]


def test_the_plan_constants_are_the_sources():
    assert CONST["SMEM_MAX"] == SMEM_MAX == lsk.SMEM_MAX
    assert (CONST["TC_ROWS"], CONST["TC_GROUPS"], CONST["TC_H_MAX"], CONST["RB"]) == (
        lsk.TC_ROWS, lsk.TC_GROUPS, lsk.TC_H_MAX, lsk.RB)
    assert CONST["PLAN_FIELDS"] == len(lsk._plan(4, 128, True, True, False).ints())
    assert lsk.tc_smem(128, 3) == 213504 and lsk.tc_smem(128, 1) == 180736


# ------------------------------------------------------ the exact split
def _draws():
    rng = np.random.default_rng(7)
    normal = rng.standard_normal(4096).astype(np.float32)
    uniform = rng.uniform(-1, 1, 4096).astype(np.float32)
    # h0 taken from bf16 state: its pieces are (h, 0, 0)
    state = torch.from_numpy(0.3 * rng.standard_normal(4096).astype(np.float32))
    state = state.to(torch.bfloat16).float().numpy()
    tiny = (uniform * np.float32(2.0 ** -60)).astype(np.float32)
    return {"normal": normal, "uniform(-1,1)": uniform, "bf16 state": state, "tiny": tiny}


DRAWS = _draws()


@pytest.mark.parametrize("name", list(DRAWS))
def test_three_pieces_sum_to_h(name):
    h = torch.from_numpy(DRAWS[name])
    hi, mid, lo = lsk.split_pieces(h)
    assert all(p.dtype == torch.bfloat16 for p in (hi, mid, lo))
    assert torch.equal((hi.float() + mid.float()) + lo.float(), h)
    assert torch.equal(hi, h.to(torch.bfloat16))
    # each residual was exact: lo is the rest itself, not a rounding of it
    assert torch.equal(lo.float(), (h - hi.float()) - mid.float())
    if name == "bf16 state":
        assert not mid.float().any() and not lo.float().any()


def test_the_kernel_splits_as_split_pieces():
    """put_h in the source: the bf16 rounding of what remains, P times; three
    pieces under float32 dots, one under bfloat16 dots."""
    body = SRC[SRC.index("auto put_h"):SRC.index("auto take_carries")]
    assert "for (int q = 0; q < P; ++q)" in body
    assert "const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);" in body
    assert "a -= f.x;" in body and "b -= f.y;" in body
    assert "dot_bf16 ? launch_tc<1>(p, pl, s) : launch_tc<3>(p, pl, s)" in SRC


# ------------------------------------------------- fragment emulation
def _tc_exprs() -> dict:
    """The tensor-core kernel's product as the source writes it: the unit
    groups a warp, lane addressing, the swizzle, the fragments each mma.sync
    takes, the cell's row and unit; each expression compiled."""
    k = SRC[SRC.index("lstm_scan_tc_kernel(TcParams p) {"):]
    flat = re.sub(r"\s+", " ", k)
    cell = flat[flat.index("// the cell"):]
    hop = re.sub(r"\s+", " ", HOPPER)
    g = lambda pat, text=flat: re.search(pat, text).group(1)
    ex = dict(
        ugw=g(r"constexpr int UGW = (\d+);", SRC),
        gw=g(r"const int gw = (.+?);"), ug0=g(r", ug0 = (.+?);"),
        a_r=g(r"const int a_r = (.+?), a_hi"), a_hi=g(r", a_hi = (.+?);"),
        b_r=g(r"const int b_r = (.+?), b_hi"), b_hi=g(r", b_hi = (.+?);"),
        lx=g(r"const int lx = (.+?), mh"), mh=g(r", mh = (.+?);"),
        ab=g(r"const uint32_t ab = (.+?);"), b0=g(r"const uint32_t b0 = (W_s .+?);"),
        b23=g(r"hopper::ldsm_x4\(b23\[u\], (.+?)\);"), a=g(r"hopper::ldsm_x4\(a, (ab .+?)\);"),
        put_off=g(r"const int off = hopper::swz2\((.+?)\);"),
        swz2=g(r"int swz2\(int row, int k, int L\) \{.*?return (.+?);", hop),
        nch_m=g(r"int swz2\(int row, int k, int L\) \{.*?const int (.+?);", hop),
        row=g(r"const int row = (tile \* M .+?);", cell),
        unit=g(r"const int unit = (.+?);", cell))
    out = {name: compile(_py(v), name, "eval") for name, v in ex.items()
           if name not in ("put_off", "nch_m")}
    out["put_off"] = [compile(_py(a), "put", "eval") for a in _args(ex["put_off"])[:2]]
    nch, m = ex["nch_m"].split(", m = ")
    out["nch"] = compile(_py(nch.split("= ")[1]), "nch", "eval")
    out["m"] = compile(_py(m), "m", "eval")
    out["mmas"] = [(int(n), regs, int(r0), int(r1)) for n, regs, r0, r1 in re.findall(
        r"mma_bf16\(acc\[u\]\[(\d)\], a, (b\d\d)\[u\]\[(\d)\], b\d\d\[u\]\[(\d)\]\);", k)]
    return out


TC = _tc_exprs()


def _ev(name, **v):
    return eval(TC[name], {"min": min}, v)


def _swz2(row, k, L):
    nch = _ev("nch", L=L)
    return _ev("swz2", row=row, k=k, L=L, m=_ev("m", nch=nch))


def _ldmatrix_x4(mem: np.ndarray, addr: list) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4.b16 from byte memory: lane 8 i + j gives
    the address of row j of matrix i; lane l receives word l % 4 of row l / 4
    of each matrix. [32 lanes, 4 registers, 2 bf16 values] as float64."""
    words = np.array([[mem[addr[8 * i + l // 4] + 4 * (l % 4) + np.arange(4)]
                       for i in range(4)] for l in range(32)], np.uint8)
    bits = words.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _mma_m16n8k16(a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k16 bf16 by its fragment layout (lane l: g = l / 4, t =
    l % 4): a0 / a1 rows g / g + 8 at k 2t, 2t + 1, a2 / a3 the same at k + 8;
    b0 column g at k 2t, 2t + 1, b1 at k + 8; d0, d1 row g, columns 2t, 2t +
    1; d2, d3 row g + 8. Exact float64 sums. Returns d [32 lanes, 4]."""
    A, Bt = np.zeros((16, 16)), np.zeros((8, 16))
    for l in range(32):
        g, t = divmod(l, 4)
        for r, (row, k) in enumerate(((g, 0), (g + 8, 0), (g, 8), (g + 8, 8))):
            A[row, k + 2 * t:k + 2 * t + 2] = a[l, r]
        Bt[g, 2 * t:2 * t + 2], Bt[g, 8 + 2 * t:10 + 2 * t] = b0[l], b1[l]
    D = A @ Bt.T
    return np.array([[D[l // 4 + 8 * (e // 2), 2 * (l % 4) + (e & 1)] for e in range(4)]
                     for l in range(32)])


def _emulate(h: np.ndarray, w16: torch.Tensor, P: int) -> np.ndarray:
    """The tensor-core route's h @ W_hh for one 16-row tile h [16, H]: h's P
    pieces written at put_h's addresses into a group's [P][16][H] tile, W_hh's
    image (tc_image, copied as it is), both read at the kernel's ldmatrix.x4
    addresses, every warp of the group and its unit groups through the
    mma.sync fragments; the gate sums returned [16, 4H] in torch's column
    order."""
    M, H = h.shape
    LH, UGW = 2 * H, _ev("ugw")
    warps = _ev("gw", H=H, UGW=UGW)
    assert warps * UGW * 8 == H
    pieces = [p.view(torch.int16).numpy().view(np.uint16)
              for p in lsk.split_pieces(torch.from_numpy(h), P)]
    a_tile = np.zeros(P * M * H, np.uint16)
    for wg in range(warps):
        ug0 = _ev("ug0", warp=wg, grp=0, gw=warps, UGW=UGW)
        for q in range(P):
            for u in range(UGW):
                for hf in range(2):
                    for lane in range(32):
                        g, tq = divmod(lane, 4)
                        row, k = (eval(e, {}, dict(g=g, hf=hf, ug0=ug0, u=u, tq=tq))
                                  for e in TC["put_off"])
                        off = q * M * H + _swz2(row, k, H)
                        a_tile[off:off + 2] = pieces[q][row, k:k + 2]
    a_mem = a_tile.view(np.uint8)
    w_mem = lsk.tc_image(w16).view(torch.int16).numpy().view(np.uint8).reshape(-1)
    out = np.full((M, 4 * H), np.nan)
    for wg in range(warps):
        ug0 = _ev("ug0", warp=wg, grp=0, gw=warps, UGW=UGW)
        for u in range(UGW):
            acc = np.zeros((4, 32, 4))
            for ks in range(H // 16):
                regs, a_addr = {"b01": [], "b23": []}, {q: [] for q in range(P)}
                for lane in range(32):
                    v = dict(lane=lane, LH=LH, M=M, P=P, W_s=0, Ah_s=0, buf=0, ug0=ug0, u=u,
                             ks=ks)
                    for name in ("a_r", "a_hi", "b_r", "b_hi", "lx", "mh", "ab", "b0"):
                        v[name] = _ev(name, **v)
                    regs["b01"].append(v["b0"])
                    regs["b23"].append(_ev("b23", **v))
                    for q in range(P):
                        a_addr[q].append(_ev("a", **dict(v, q=q)))
                b = {r: _ldmatrix_x4(w_mem, regs[r]) for r in regs}
                for q in range(P):
                    a = _ldmatrix_x4(a_mem, a_addr[q])
                    for n, r, r0, r1 in TC["mmas"]:
                        acc[n] += _mma_m16n8k16(a, b[r][:, r0], b[r][:, r1])
            for lane in range(32):
                g, tq = divmod(lane, 4)
                for e in range(4):
                    hf, j = divmod(e, 2)
                    v = dict(tile=0, M=M, g=g, hf=hf, ug0=ug0, u=u, tq=tq)
                    row, unit = _ev("row", **v), _ev("unit", **v) + j
                    for n in range(4):   # n-tile n holds gate n (i, f, g, o)
                        out[row, n * H + unit] = acc[n, lane, e]
    return out


@pytest.mark.parametrize("pieces", [3, 1], ids=["f32 dots", "bf16 dots"])
@pytest.mark.parametrize("H", [16, 32, 64, 128])
def test_fragments_compute_the_dot(H, pieces):
    assert [n for n, *_ in TC["mmas"]] == [0, 1, 2, 3]
    rng = np.random.default_rng(H + pieces)
    h = np.tanh(2.0 * rng.standard_normal((16, H))).astype(np.float32)
    w16 = torch.from_numpy(rng.uniform(-1, 1, (H, 4 * H)).astype(np.float32)
                           / np.sqrt(H)).to(torch.bfloat16)
    got = _emulate(h, w16, pieces)
    w = w16.double().numpy()
    # exact sums of exact products: the dot of h's pieces, h itself for three
    hp = h.astype(np.float64) if pieces == 3 else (
        torch.from_numpy(h).to(torch.bfloat16).double().numpy())
    np.testing.assert_allclose(got, hp @ w, rtol=0, atol=1e-12)
    # the plain version's float32 dot (its cast points), within f32 rounding
    dot = torch.bfloat16 if pieces == 1 else torch.float32
    _, rnd = lsk._rounder(torch.float32, dot)
    want = (rnd(torch.from_numpy(h)) @ rnd(w16)).double().numpy()
    scale = np.abs(hp) @ np.abs(w)
    assert np.all(np.abs(got - want) <= 4 * H * 2.0 ** -24 * scale + 1e-30)


def test_tc_image_unpacks_to_the_weight():
    w = torch.randn(64, 256).to(torch.bfloat16)
    img = lsk.tc_image(w)
    assert img.shape == (256, 64) and img.is_contiguous()
    # unswizzle (XOR is its own inverse), then gate_image's inverse
    un = lsk.tc_image(w).view(256, 8, 8)
    src = torch.arange(8)[None, :] ^ (torch.arange(256)[:, None] & 7)
    un = un.gather(1, src[:, :, None].expand(256, 8, 8)).reshape(1, 256, 64)
    assert torch.equal(dpk.gate_unimage(un), w)
    for n in (0, 9, 47, 255):      # row n: unit group n / 32, gate n / 8 % 4, unit n % 8
        col = (n // 8 % 4) * 64 + n // 32 * 8 + n % 8
        for k in (0, 13, 63):
            assert img.reshape(-1)[_swz2(n, k, 64)] == w[k, col]


def _row_map(n, H):
    """The element offsets within row n that `swz2` gives for k = 0 .. H - 1."""
    return [_swz2(n, k, H) - n * H for k in range(H)]


@pytest.mark.parametrize("H", list(range(16, 129, 16)))
def test_tc_route_only_where_the_swizzle_keeps_each_row(H):
    """At every multiple of 16 up to 128, the swizzle of the source maps each
    row onto itself exactly where the plan (Python and C) takes the tensor
    cores: H = 16, 32, 64, 128. At H = 48, 80, 96, 112 a chunk would leave
    its row (H = 96: chunk 8 of row 7 at 15 of 12), so those take the CUDA
    cores."""
    keeps = all(sorted(_row_map(n, H)) == list(range(H)) for n in range(16))
    plan = lsk._plan(64, H, True, True, False)
    assert (plan.route == "tc") == keeps == (H in lsk.TC_WIDTHS)
    assert source_plan(64, H, True, True, False)[0] == plan.ints()


@pytest.mark.parametrize("H", [16, 32, 64, 128])
def test_tc_image_round_trip(H):
    """At every width the plan admits, the image read at the source's swz2
    offsets and unpacked by `gate_image`'s inverse is W_hh, bit for bit."""
    w = torch.randn(H, 4 * H, generator=torch.Generator().manual_seed(H)).to(torch.bfloat16)
    img = lsk.tc_image(w)
    assert img.shape == (4 * H, H) and img.is_contiguous()
    idx = torch.tensor([[_swz2(n, k, H) for k in range(H)] for n in range(4 * H)])
    un = img.reshape(-1)[idx].reshape(1, 4 * H, H)
    assert torch.equal(dpk.gate_unimage(un), w)


@pytest.mark.parametrize("H", [48, 96])
def test_tc_image_refuses_widths_the_swizzle_breaks(H):
    with pytest.raises(ValueError, match="swizzle"):
        lsk.tc_image(torch.zeros(H, 4 * H, dtype=torch.bfloat16))


def test_tc_weight_is_cached_until_the_weight_changes():
    lstm = torch.nn.LSTM(8, 16).to(torch.bfloat16)
    w = lstm.weight_hh_l0.T            # a view, as the models pass it
    first = lsk.tc_weight(w)
    assert lsk.tc_weight(lstm.weight_hh_l0.T) is first
    with torch.no_grad():
        lstm.weight_hh_l0.add_(1.0)   # in place: a new version, packed again
    again = lsk.tc_weight(lstm.weight_hh_l0.T)
    assert again is not first and torch.equal(again, lsk.tc_image(lstm.weight_hh_l0.T))

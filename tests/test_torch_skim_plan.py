"""The launch plan of `fused_skim_frames` (`ops/skim_stream_kernel.py`
`_plan`, which `csrc/skim_stream_tc.cuh` `make_plan` computes again at each
launch) and the weight images of its tensor-core route: at every shape the
port launches (`chip_smoke.py`'s phases 2, 2i and 2h, TSE and Gate serving at
256 and 1,024 slots, a ragged 1,001, the small C = H = 16 cases), in float32
and bfloat16, with and without int8_hh / int8_full, the route fits the
232,448 bytes of shared memory an H100 block may use; bf16 at the model
geometry takes the tensor cores, float32 the CUDA cores; a shape nothing
fits raises `SkimPlanError`, a ValueError. The images unpack to the weights
in the order the kernel consumes them, the ranks' gate columns and the
products emulated from the stages at the kernel's ldmatrix addresses
(expressions read from the source) equal the plain dots: the int8 ones bit
for bit (`dot_hh_ref` / `dot_dyn_ref`), the bf16 ones within float64
rounding of the same bf16 operands. Pure Python: no card needed."""
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.ops import skim_stream_kernel as ops
from puresound_tpu_torch.ops.quant import (DYN_DIV, HH_DIV, dot_dyn_ref, dot_hh_ref,
                                           quantize_cols)

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
CSRC = os.path.join(os.path.dirname(os.path.dirname(ops.__file__)), "csrc")
TC_SRC = open(os.path.join(CSRC, "skim_stream_tc.cuh")).read()
FLAT = re.sub(r"\s+", " ", TC_SRC)


def _shapes():
    """(label, B, C, H, Hg, fusion modes) of every fused_skim_frames launch."""
    out = [(f"2 {name}", B, C, H, 1, modes)
           for name, n, C, H, B, F, modes in chip_smoke.SKIM_CASES]
    out += [(f"2i {name}", B, C, H, chip_smoke.GATE_HG, modes)
            for name, n, C, H, B, F, modes in chip_smoke.GATE_CASES]
    n, C, H, B, F = chip_smoke.QSKIM_SHAPE
    out += [(f"2h B={B} film", B, C, H, 1, ("film",) * n),
            (f"2h B={B} gate", B, C, H, chip_smoke.GATE_HG, ("gate",) * n)]
    out += [(f"4/4e/4f TSE {s} slots", s, 128, 256, 1, ("film",) * 4)
            for s in (256, chip_smoke.TSE_Q_SLOTS)]
    out += [(f"4i Gate {s} slots", s, 128, 256, chip_smoke.GATE_HG, ("gate",) * 4)
            for s in chip_smoke.GATE_SLOTS]
    out += [("3 / 3g 4 streams", 4, 128, 256, 1, ("film",) * 4)]
    return out


SHAPES = _shapes()
OPTIONS = [(False, False), (True, False), (False, True)]


@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "int8_hh", "int8_full"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_launch_has_a_route_that_fits(shape, bf16, options):
    _, B, C, H, Hg, modes = shape
    plan = ops._plan(B, C, H, Hg, modes, bf16, *options)
    assert len(plan.ints()) == 6 and plan.ints()[0] == int(plan.route == "mma")
    assert plan.smem <= SMEM_MAX
    geometry = C == 128 and H == 256 and len(modes) >= 2
    assert plan.route == ("mma" if bf16 and geometry else "cuda")
    q_hh, q_full = options[0] or options[1], options[1]
    if plan.route == "mma":
        U = H // plan.K
        assert plan.M in (16, 32) and 2 <= plan.K <= 8 and U in (32, 64, 128)
        assert U < 128 or plan.M == 16   # two passes of the gate products: one m-tile
        assert plan.smem == ops.tc_smem(plan.M, plan.K, C, H, len(modes), q_hh, q_full,
                                        plan.depth)
        # the ring as deep as fits, at most 8
        assert 2 <= plan.depth <= 8
        if plan.depth < 8:
            assert ops.tc_smem(plan.M, plan.K, C, H, len(modes), q_hh, q_full,
                               plan.depth + 1) > SMEM_MAX
        assert plan.stages == ops.body_stages(C, H, Hg, modes, plan.K, q_hh, q_full)
    else:
        assert plan.ints()[1:4] == [0, 0, 0] and plan.smem == ops.cuda_smem(C, H, Hg, len(modes))


@pytest.mark.parametrize("B,K,M", [(256, 8, 32), (1024, 2, 16), (1001, 2, 16)])
@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "int8_hh", "int8_full"])
@pytest.mark.parametrize("modes", [("film",) * 4, ("gate",) * 4, ("",) * 4],
                         ids=["film", "gate", "unconditioned"])
def test_serving_tiles_stream_the_fewest_stages(B, K, M, options, modes):
    """With the H100's clusters in flight (66 of 2, 30 of 4, 15 of 8): 256
    streams in 8 clusters of 8 over 32 streams, 1,024 in 64 clusters of 2
    over 16 (one wave each; clusters of 4 over 32 would take two waves of
    30): of the candidates, the first with the fewest waves x stages a
    frame."""
    Hg = 128 if "gate" in modes else 1
    plan = ops._plan(B, 128, 256, Hg, modes, True, *options)
    assert plan.route == "mma"
    if modes[0]:   # conditioned blocks, as the models serve (unconditioned ones stream fewer)
        assert (plan.K, plan.M) == (K, M)
    q_hh, q_full = options[0] or options[1], options[1]
    cost = lambda k, m: (-(-(-(-B // m)) // ops.H100_CLUSTERS[k])
                         * ops.body_stages(128, 256, Hg, modes, k, q_hh, q_full))
    assert cost(plan.K, plan.M) == min(cost(k, m) for k, m in ((8, 16), (4, 16), (8, 32), (4, 32),
                                                               (2, 16)))
    # f32 dots keep the CUDA cores at every width
    assert ops._plan(B, 128, 256, Hg, modes, False, *options).route == "cuda"


def test_other_clusters_in_flight_take_other_tiles():
    # 33 clusters of 4 and 16 of 8: 1,024 streams in one wave of (4, 32), 256
    # in one of (8, 16), the first of the equals
    card = {2: 0, 4: 33, 8: 16}
    plan = ops._plan(1024, 128, 256, 1, ("film",) * 4, True, clusters=card)
    assert (plan.K, plan.M) == (4, 32)
    plan = ops._plan(256, 128, 256, 1, ("film",) * 4, True, clusters=card)
    assert (plan.K, plan.M) == (8, 16)
    # no cluster of 8 in flight: clusters of 4
    plan = ops._plan(256, 128, 256, 1, ("film",) * 4, True, clusters={2: 0, 4: 33, 8: 0})
    assert (plan.K, plan.M) == (4, 16)


@pytest.mark.parametrize("C,H,Hg,modes", [
    (64, 256, 1, ("film",) * 4), (128, 256, 64, ("gate",) * 4), (128, 256, 1, ("film",)),
    (128, 96, 1, ("film",) * 2)], ids=["C=64", "Hg=64", "one block", "H=96"])
def test_off_geometry_takes_the_cuda_cores(C, H, Hg, modes):
    assert ops._plan(256, C, H, Hg, modes, True).route == "cuda"


@pytest.mark.parametrize("C,H,n", [(512, 1024, 4), (128, 2048, 4)], ids=["C=512 H=1024", "H=2048"])
def test_a_shape_nothing_fits_raises(C, H, n):
    with pytest.raises(ops.SkimPlanError) as e:
        ops._plan(256, C, H, 1, ("film",) * n, False)
    assert isinstance(e.value, ValueError)


# --------------------------------------------------------- the C source
def _c_int(expr: str) -> str:
    """A C integer expression in Python: no casts or long suffixes, / as //."""
    expr = re.sub(r"\((?:long|int|size_t)\)", "", expr)
    expr = re.sub(r"\b(\d+)L\b", r"\1", expr)
    return expr.replace(" / ", " // ")


def _c_function(name: str) -> str:
    return re.search(rf"inline long {name}\((.*?)\) \{{(.*?)\n\}}", TC_SRC, re.S).group(2)


def _run_c_sum(name: str, **v) -> int:
    """Evaluate one of the source's byte-count functions (statements `const
    long x = ...`, `long b = ...`, `b += ...`, `if (cond) b += ...`, `return
    ...`) with the given arguments."""
    body = _c_function(name)
    env = dict(v, STAGE_BYTES=ops.STAGE_BYTES, SCR_LD=ops.SCR_LD)
    ev = lambda e: eval(_c_int(re.sub(r"\((\w+) > (\w+) \? (\w+) : (\w+)\)",
                                      r"(\3 if \1 > \2 else \4)", e)), {}, env)
    for stmt in re.findall(r"[^;{}]+;", body):
        stmt = re.sub(r"\s+", " ", re.sub(r"//[^\n]*", "", stmt)).strip()
        m = re.match(r"const long (.+?);", stmt)
        if m:
            for part in m.group(1).split(","):
                k, e = part.split("=", 1)
                env[k.strip()] = ev(e)
            continue
        m = re.match(r"(?:if \((.+?)\) )?(long )?b (\+?)= (.+?);", stmt)
        if m:
            cond, _, plus, e = m.groups()
            if cond is None or eval(cond.replace("!", "not "), {}, env):
                env["b"] = (env["b"] if plus else 0) + ev(e)
            continue
        m = re.match(r"return (.+?);", stmt)
        if m:
            return ev(m.group(1))
    raise AssertionError(f"{name}: no return")


@pytest.mark.parametrize("M,K", [(16, 8), (32, 4), (32, 8), (16, 4)])
@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "int8_hh", "int8_full"])
def test_shared_bytes_are_the_sources(M, K, options):
    q_hh, q_full = int(options[0] or options[1]), int(options[1])
    for D in (0, 5):
        assert _run_c_sum("tc_smem", M=M, K=K, C=128, H=256, n=4, q_hh=q_hh,
                          q_full=q_full, D=D) == ops.tc_smem(M, K, 128, 256, 4, q_hh,
                                                             q_full, D)


def test_the_plan_constants_and_rules_are_the_sources():
    num = lambda name: int(re.search(rf"\b{name} = (\d+)", TC_SRC).group(1))
    assert num("SMEM_MAX") == ops.SMEM_MAX == SMEM_MAX
    assert (num("STAGE_ROWS"), num("STAGE_BYTES"), num("MAX_DEPTH"), num("SCR_LD"),
            num("TC_C")) == (ops.STAGE_ROWS, ops.STAGE_BYTES, ops.MAX_DEPTH, ops.SCR_LD,
                             ops.TC_C)
    assert num("PLAN_FIELDS") == len(ops._plan(4, 128, 256, 1, ("film",) * 4, True).ints())
    assert "{{H / 32, 16}, {H / 64, 16}, {H / 32, 32}, {H / 64, 32}, {H / 128, 16}}" in FLAT
    assert "dot_bf16 && C == TC_C && (!gate || Hg == 128) && n >= 2" in FLAT
    assert "(U != 32 && U != 64 && (U != 128 || M != 16))" in FLAT
    assert "if (D > MAX_DEPTH) D = MAX_DEPTH;" in FLAT
    assert "return 4 * U > 256 ? 2 : 1;" in FLAT and ops.gate_passes(128) == 2
    assert "if (best < 0 || waves * Sb < best)" in FLAT    # the first of the fewest
    assert "return kin / ((int8 ? 64 : 32) * (STAGE_ROWS / N));" in FLAT
    for C, H, Hg, n in ((128, 256, 128, 4), (16, 16, 1, 3), (16, 16, 128, 3)):
        assert _run_c_sum("cuda_smem", C=C, H=H, Hg=Hg, n=n) == ops.cuda_smem(C, H, Hg, n)


# ----------------------------------------------------------- the images
def _masker(fusion, modes, seed=0, C=128, H=256):
    return SkiM(input_size=C, hidden_size=H, output_size=C, n_blocks=len(modes),
                seg_size=150, causal=True, embed_dim=192, embed_norm=True,
                embed_fusion="Gate" if fusion == "gate" else "FiLM",
                block_with_embed=tuple(int(m != "") for m in modes),
                generator=torch.Generator().manual_seed(seed)).eval()


def _issue_order(count: int, F: int, Sb: int, st_hh: int, st_p: int) -> list:
    """The image stage of each stage a CTA consumes, in order: the kernel's
    `source`, read from the source and run as Python."""
    body = re.sub(r"\s+", " ", re.search(r"auto source = \[&\]\(int j\) \{(.*?)\n  \};",
                                          TC_SRC, re.S).group(1)).strip()
    assert body == ("int q = j % per_tile; if (q >= st_hh0) q += st_p; "
                    "return q < per_tile ? q % p.Sb : st_hh0 + (q - per_tile);"), body
    assert "const int st_hh0 = P * st_hh;" in FLAT
    assert re.search(r"const int per_tile = F \* p\.Sb;", TC_SRC)
    per_tile = F * Sb
    out = []
    for j in range(count):
        q = j % per_tile
        if q >= st_hh:
            q += st_p
        out.append(q % Sb if q < per_tile else st_hh + (q - per_tile))
    return out


def _consumed(modes, F, passes):
    """(block, product, pass) in the order the kernel's steps consume them:
    per step W_hh pass by pass, the previous block's projection (not at the
    first step), the fusion, W_ih pass by pass; the last projection after
    the last step."""
    n = len(modes)
    out = []
    for s in range(F * n):
        i = s % n
        out += [(i, "w_hh", p) for p in range(passes)]
        if s > 0:
            out.append(((i - 1) % n, "proj_w", 0))
        if modes[i] == "film":
            out.append((i, "film", 0))
        elif modes[i] == "gate":
            out += [(i, "g_win", 0), (i, "g_lr", 0), (i, "g_wout", 0)]
        out += [(i, "w_ih", p) for p in range(passes)]
    return out + [(n - 1, "proj_w", 0)]


def _product_shape(name, C, H, Hg, K, q_hh, q_full):
    """(kin, N, int8) of a product as the kernel runs it (a gate product's
    one pass)."""
    N = 4 * (H // K) // ops.gate_passes(H // K)
    return {"w_hh": (H, N, q_hh), "w_ih": (C, N, q_full), "proj_w": (H, C, q_full),
            "film": (C, 2 * C, q_full), "g_win": (C, Hg, False),
            "g_lr": (Hg, 2 * Hg, False), "g_wout": (Hg, C, False)}[name]


@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "int8_hh", "int8_full"])
@pytest.mark.parametrize("fusion,modes", [("film", ("film",) * 4), ("gate", ("gate",) * 4),
                                          ("film", ("film", "", "film")), ("gate", ("gate", ""))],
                         ids=["film", "gate", "film+unconditioned", "gate+unconditioned"])
@pytest.mark.parametrize("B", [256, 1024])
def test_images_unpack_to_the_weights_in_consumption_order(B, fusion, modes, options):
    """Each rank's ring, stage by stage as the kernel's `source` maps a tile's
    sequence (3 frames), unpacks product by product (in the steps'
    order) to the weights: W_hh / W_ih on the rank's gate columns, the rest
    whole, the same at every frame, int8 where the option quantizes."""
    int8_hh, int8_full = options
    q_hh, q_full = int8_hh or int8_full, int8_full
    C, H, F = 128, 256, 3
    Hg = 128 if fusion == "gate" else 1
    ws = _masker(fusion, modes)._fused_weights(int8_hh, int8_full)
    plan = ops._plan(B, C, H, Hg, modes, True, int8_hh, int8_full)
    img = ops.tc_image(ws, modes, H, plan.K, int8_hh, int8_full)
    assert img.shape == (plan.K, plan.stages, ops.STAGE_BYTES) and img.dtype == torch.uint8
    blocks = ops._unpack(ws, modes, int8_hh, int8_full)
    per_tile = F * plan.stages
    P = ops.gate_passes(H // plan.K)
    st_hh = P * ops.stages_of(H, 4 * (H // plan.K) // P, q_hh)
    st_p = ops.stages_of(H, C, q_full)
    # two tiles: the second consumes what the first did
    seq = _issue_order(2 * per_tile, F, plan.stages, st_hh, st_p)
    assert seq[per_tile:] == seq[:per_tile]
    # every stage of the image once a frame, frame 0's projection slot at the end
    assert sorted(seq[:per_tile]) == sorted(list(range(plan.stages)) * F)
    for rank in range(plan.K):
        pos = 0
        for i, name, gate_pass in _consumed(modes, F, P):
            kin, N, i8 = _product_shape(name, C, H, Hg, plan.K, q_hh, q_full)
            nst = ops.stages_of(kin, N, i8)
            got = ops.unstage_image(img[rank, seq[pos:pos + nst]], kin, N, i8)
            pos += nst
            want = ops.product_weight(blocks[i], name, H, plan.K, rank, int8_hh, int8_full,
                                      gate_pass)
            assert got.dtype == (torch.int8 if i8 else torch.bfloat16)
            assert torch.equal(got, want), (rank, i, name)
        assert pos == per_tile


@pytest.mark.parametrize("H,K", [(256, 4), (256, 8), (256, 2), (128, 2), (128, 4)])
def test_ranks_gate_columns_cover_every_gate_once(H, K):
    """Every gate column is some rank's, once, and element (n-tile j, e) of
    thread tq in warp w holds, in every pass, the column the image puts
    there (the kernel's `gate_col`, read from the source)."""
    U = H // K
    P = ops.gate_passes(U)
    blk = {"w_hh": torch.arange(4 * H)[None, :].repeat(2, 1)}
    cols = [ops.product_weight(blk, "w_hh", H, K, r, True, False, p)[0]
            for r in range(K) for p in range(P)]
    assert torch.equal(torch.cat(cols).sort().values, torch.arange(4 * H))
    src = re.search(r"auto gate_col = \[&\]\(int j, int e, int pass\) \{ return (.+?); \};",
                    FLAT).group(1)
    expr = re.sub(r"\bpass\b", "pass_", _c_int(src))   # `pass` is a Python keyword
    gate_col = lambda **v: eval(expr, {}, dict(v, U=U, H=H, UP=U // P))
    for rank in range(K):
        for p in range(P):
            img_cols = cols[rank * P + p]
            for w in range(8):
                for j in range(U // P // 16):
                    for tq in range(4):
                        for e in range(2):
                            n = w * (U // P // 2) + 8 * j + 2 * tq + e
                            assert img_cols[n] == gate_col(j=j, e=e, pass_=p, rank=rank,
                                                           warp=w, tq=tq)


def test_images_are_cached_until_a_weight_changes():
    modes = ("film",) * 4
    m = _masker("film", modes)
    ws = m._fused_weights()
    first = ops._image(ws, modes, 256, 4, "cpu", False, False)
    assert ops._image(ws, modes, 256, 4, "cpu", False, False) is first
    assert m._fused_weights() is ws
    with torch.no_grad():
        m.seg_lstm[0].lstm.weight_hh_l0.add_(1.0)
    ws2 = m._fused_weights()
    assert ws2 is not ws
    again = ops._image(ws2, modes, 256, 4, "cpu", False, False)
    assert again is not first and not torch.equal(again, first)


def test_launches_are_counted_by_route():
    saved = (ops.LAUNCHES, dict(ops.LAUNCHES_BY_OPTION), dict(ops.LAUNCHES_BY_ROUTE))
    ops.LAUNCHES = 0
    ops.LAUNCHES_BY_OPTION.clear()
    ops.LAUNCHES_BY_ROUTE.clear()
    try:
        ops.count_launch(ops._plan(1024, 128, 256, 1, ("film",) * 4, True))
        ops.count_launch(ops._plan(1024, 128, 256, 1, ("film",) * 4, True, True), True)
        ops.count_launch(ops._plan(1024, 128, 256, 1, ("film",) * 4, False), False, True)
        assert ops.LAUNCHES == 3
        assert ops.LAUNCHES_BY_ROUTE == {"mma": 2, "cuda": 1}
        assert ops.LAUNCHES_BY_OPTION == {"": 1, "int8_hh": 1, "int8_full": 1}
    finally:
        ops.LAUNCHES = saved[0]
        ops.LAUNCHES_BY_OPTION.clear()
        ops.LAUNCHES_BY_OPTION.update(saved[1])
        ops.LAUNCHES_BY_ROUTE.clear()
        ops.LAUNCHES_BY_ROUTE.update(saved[2])


# ------------------------------------------- the products, fragment by fragment
def _expr(pattern: str) -> str:
    return _c_int(re.search(pattern, FLAT).group(1))


SRC = {name: compile(e, name, "eval") for name, e in dict(
    a_r=_expr(r"const int a_r = (.+?), a_hi"), a_hi=_expr(r", a_hi = (.+?);"),
    b_r=_expr(r"const int b_r = (.+?), b_hi"), b_hi=_expr(r", b_hi = (.+?);"),
    kc=_expr(r"const int kc = (.+?);"),
    a_addr=_expr(r"ldsm_x4\(a\[mt\], (a_s .+?)\);"),
    b_row=_expr(r"const int row = (sl \* N .+?);"),
    b_addr=_expr(r"ldsm_x4\(b, (b_s .+?)\);"),
    col0=_expr(r"const int sps = STAGE_ROWS / N, col0 = (.+?), pairs"),
    gather=_expr(r"off\[u\] = (m \* LB .+?);"),
    a8=_expr(r"reinterpret_cast<unsigned\*>\(a8 \+ (.+?)\) = w;"),
    a16=_expr(r"reinterpret_cast<unsigned char\*>\(a16\) \+ (.+?)\) = make_uint2"),
    scr_row=_expr(r"const int row = (mt \* 16 \+ g .+?), col = col0"),
    scr_col=_expr(r"const int row = mt \* 16 \+ g \+ 8 \* h2, col = (.+?);"),
).items()}


def _ev(name, **v):
    return eval(SRC[name], {}, v)


def test_the_products_take_the_fragments_the_emulation_takes():
    """Each m16n8 product takes the A fragment of its m-tile and the B
    registers 0, 1 (n-tile 2 pp) or 2, 3 (n-tile 2 pp + 1) of its
    ldmatrix.x4, in both the bf16 and the int8 instruction."""
    for op in ("mma_s8", "mma_bf16"):
        got = re.findall(rf"{op}\(acc\[mt\]\[(2 \* pp(?: \+ 1)?)\], a\[mt\], "
                         r"b\[(\d)\], b\[(\d)\]\);", FLAT)
        assert got == [("2 * pp", "0", "1"), ("2 * pp + 1", "2", "3")], (op, got)


def _ldmatrix_x4(mem: np.ndarray, addr) -> np.ndarray:
    """ldmatrix.x4: lane 8 i + j gives the address of row j of matrix i; lane
    l receives bytes 4 (l % 4) .. of row l / 4 of each matrix. [32, 4, 4]."""
    addr = np.asarray(addr)
    idx = addr[8 * np.arange(4)[None, :] + (np.arange(32) // 4)[:, None]]
    idx = idx + (4 * (np.arange(32) % 4))[:, None]
    return mem[idx[..., None] + np.arange(4)]


def _bf16(b: np.ndarray) -> np.ndarray:
    """Little-endian bf16 byte pairs [..., 2k] -> float64 [..., k]."""
    u = b.astype(np.uint32).reshape(*b.shape[:-1], -1, 2)
    return ((u[..., 0] | (u[..., 1] << 8)) << 16).astype(np.uint32).view(np.float32) \
        .astype(np.float64)


def _mma(a, b0, b1, int8):
    """mma.sync m16n8k16 (bf16) / m16n8k32 (int8) by its fragment layout: a
    [32, 4 regs, 4 bytes], b0 / b1 [32, 4 bytes]; returns d [32, 4]."""
    kk = 32 if int8 else 16
    val = (lambda x: x.astype(np.int8).astype(np.int64)) if int8 else _bf16
    per = 4 if int8 else 2              # values a register
    A, Bt = np.zeros((16, kk)), np.zeros((8, kk))
    for l in range(32):
        g, t = divmod(l, 4)
        for r, (row, k) in enumerate(((g, 0), (g + 8, 0), (g, kk // 2), (g + 8, kk // 2))):
            A[row, k + per * t:k + per * t + per] = val(a[l, r])
        Bt[g, per * t:per * t + per] = val(b0[l])
        Bt[g, kk // 2 + per * t:kk // 2 + per * t + per] = val(b1[l])
    D = A @ Bt.T
    return np.array([[D[l // 4 + 8 * (e // 2), 2 * (l % 4) + (e & 1)] for e in range(4)]
                     for l in range(32)])


def _product(a_mem, LA, stages, N, M, int8):
    """The kernel's `product` over `stages` [nst, 16384] bytes into D [M, N]
    (each warp's accumulators written at the scratch's (row, col))."""
    MT, sps, pairs = M // 16, ops.STAGE_ROWS // N, N // 128
    D = np.zeros((M, N))
    for warp in range(8):
        col0 = _ev("col0", warp=warp, N=N)
        acc = np.zeros((MT, 4, 32, 4))
        for st in range(len(stages)):
            b_mem = stages[st].numpy()
            for sl in range(sps):
                kc = _ev("kc", st=st, gi=0, sps=sps, sl=sl)
                for ks in range(2):
                    lanes = [dict(lane=lane, a_r=_ev("a_r", lane=lane), a_hi=_ev("a_hi", lane=lane),
                                  b_r=_ev("b_r", lane=lane), b_hi=_ev("b_hi", lane=lane))
                             for lane in range(32)]
                    for mt in range(MT):
                        a = _ldmatrix_x4(a_mem, [_ev("a_addr", a_s=0, mt=mt, LA=LA, kc=kc, ks=ks,
                                                     **v) for v in lanes])
                        for pp in range(pairs):
                            rows = [_ev("b_row", sl=sl, N=N, col0=col0, pp=pp, **v)
                                    for v in lanes]
                            b = _ldmatrix_x4(b_mem, [_ev("b_addr", b_s=0, row=r, ks=ks, **v)
                                                     for r, v in zip(rows, lanes)])
                            acc[mt, 2 * pp] += _mma(a, b[:, 0], b[:, 1], int8)
                            acc[mt, 2 * pp + 1] += _mma(a, b[:, 2], b[:, 3], int8)
        for mt in range(MT):
            for j in range(N // 64):
                for lane in range(32):
                    g, tq = divmod(lane, 4)
                    for e in range(4):
                        row = _ev("scr_row", mt=mt, g=g, h2=e // 2)
                        col = _ev("scr_col", col0=col0, j=j, tq=tq)
                        D[row, col + (e & 1)] = acc[mt, j, lane, e]
    return D


def _h_tile(slices, M, H, K, int8):
    """The h tile the kernel gathers from the ranks' slices [K][M][U]
    (16-byte chunks at the source's gather offsets)."""
    U, eb = H // K, 1 if int8 else 2
    cpr, LB = U * eb // 16, H * eb
    raw = [np.ascontiguousarray(s).view(np.uint8).reshape(M, U * eb) for s in slices]
    mem = np.zeros(M * LB, np.uint8)
    for q in range(K):
        for m in range(M):
            for cc in range(cpr):
                off = _ev("gather", m=m, LB=LB, q=q, cpr=cpr, cc=cc)
                mem[off:off + 16] = raw[q][m, 16 * cc:16 * cc + 16]
    return mem


def _row_tile(vals, rows, int8):
    """A [rows][128] A tile as the row passes write it (put_a8 / put_a16):
    lane l's four values of row r at the source's address."""
    mem = np.zeros(rows * 128 * (1 if int8 else 2), np.uint8)
    for r in range(rows):
        for lane in range(32):
            off = _ev("a8" if int8 else "a16", r=r, lane=lane)
            v = vals[r, 4 * lane:4 * lane + 4]
            mem[off:off + (4 if int8 else 8)] = np.ascontiguousarray(v).view(np.uint8)
    return mem


@pytest.mark.parametrize("H,K,M", [(256, 4, 32), (256, 8, 16), (128, 4, 16),
                                   (256, 2, 16), (256, 8, 32)])
def test_int8_fragment_sums_equal_dot_hh(H, K, M):
    """int8_hh's h @ W_hh: every rank's slices gathered into the h tile, its
    W_hh stages, pass by pass as `tc_image` lays them, read at the kernel's
    ldmatrix.x4 addresses into m16n8k32 fragments, summed in integers and
    scaled once per gate column, equal `dot_hh_ref` bit for bit on the
    rank's columns. (256, 2, 16) and (256, 8, 32) are the served tiles at
    1,024 streams (two gate passes) and at 256."""
    rng = np.random.default_rng(H + K + M)
    h = np.tanh(2.0 * rng.standard_normal((M, H))).astype(np.float32)
    h[0, :4] = [1.0, -1.0, 0.5 / 127, -1.5 / 127]   # the clip and round-half-even
    wq, col_max = quantize_cols(torch.from_numpy(rng.standard_normal((H, 4 * H))
                                                 .astype(np.float32)))
    s = (col_max / HH_DIV).numpy()
    want = dot_hh_ref(torch.from_numpy(h), wq, torch.from_numpy(s)).numpy()
    hq = torch.round(torch.from_numpy(h) * 127.0).clamp(-127, 127).to(torch.int8).numpy()
    U = H // K
    tile = _h_tile([hq[:, q * U:(q + 1) * U] for q in range(K)], M, H, K, True)
    P = ops.gate_passes(U)
    for rank in range(K):
        for gate_pass in range(P):
            cols = ops.gate_columns(H, K * P, rank * P + gate_pass)
            stages = ops.stage_image(ops.product_weight({"w_hh": wq}, "w_hh", H, K, rank,
                                                        int8_hh=True, gate_pass=gate_pass))
            isum = _product(tile, H, stages, 4 * U // P, M, True)
            got = isum.astype(np.float32) * s[cols.numpy()]
            np.testing.assert_array_equal(got, want[:, cols.numpy()])


@pytest.mark.parametrize("name,N", [("w_ih", 256), ("film", 256), ("proj_w", 128)])
def test_int8_full_fragment_sums_equal_dot_dyn_and_dot_hh(name, N):
    """int8_full's products: the dynamic activation rows (put_a8: amax and
    v / amax * 127) times W_ih's rank columns or [Wsx | Wbx], and the fixed h
    rows times proj_w, equal `dot_dyn_ref` / `dot_hh_ref` bit for bit."""
    rng = np.random.default_rng(N)
    M, H, K = 32, 256, 4
    kin = H if name == "proj_w" else 128
    w = rng.standard_normal((kin, N if name != "w_ih" else 4 * H)).astype(np.float32)
    wq, col_max = quantize_cols(torch.from_numpy(w))
    if name == "proj_w":
        h = np.tanh(rng.standard_normal((M, H))).astype(np.float32)
        s = (col_max / HH_DIV).numpy()
        want = dot_hh_ref(torch.from_numpy(h), wq, torch.from_numpy(s)).numpy()
        hq = torch.round(torch.from_numpy(h) * 127.0).clamp(-127, 127).to(torch.int8).numpy()
        tile = _h_tile([hq[:, q * 64:(q + 1) * 64] for q in range(K)], M, H, K, True)
        got = _product(tile, H, ops.stage_image(wq), N, M, True).astype(np.float32) * s
        np.testing.assert_array_equal(got, want)
        return
    a = (3.0 * rng.standard_normal((M, kin))).astype(np.float32)
    a[1] = 0.0                                      # amax clipped at 1e-8
    s = (col_max / DYN_DIV).numpy()
    want = dot_dyn_ref(torch.from_numpy(a), wq, torch.from_numpy(s)).numpy()
    amax = np.maximum(np.abs(a).max(1), np.float32(1e-8)).astype(np.float32)
    aq = np.clip(np.rint(a / amax[:, None] * np.float32(127.0)), -127, 127).astype(np.int8)
    tile = _row_tile(aq, M, True)
    if name == "w_ih":
        for rank in range(K):
            cols = ops.gate_columns(H, K, rank)
            isum = _product(tile, 128, ops.stage_image(wq[:, cols]), N, M, True)
            got = (isum.astype(np.float32) * (amax[:, None] / np.float32(127.0))
                   * s[cols.numpy()])
            np.testing.assert_array_equal(got, want[:, cols.numpy()])
    else:
        isum = _product(tile, 128, ops.stage_image(wq), N, M, True)
        got = isum.astype(np.float32) * (amax[:, None] / np.float32(127.0)) * s
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("what", ["w_hh", "w_ih", "lr", "proj_w"])
def test_bf16_fragment_sums_equal_the_rounded_dots(what):
    """The bf16 products: A rows from the gathered h slices or the row
    passes' tile, the stages at the ldmatrix.x4 addresses into m16n8k16
    fragments, equal the dot of the same bf16 operands (float64 sums) on each
    rank's gate columns, or whole."""
    rng = np.random.default_rng(len(what))
    M, H, K = 32, 256, 4
    rnd = lambda t: torch.from_numpy(t).to(torch.bfloat16)
    if what in ("w_hh", "proj_w"):
        a = rnd(np.tanh(rng.standard_normal((M, H))).astype(np.float32))
        U = H // K
        tile = _h_tile([a[:, q * U:(q + 1) * U].view(torch.int16).numpy() for q in range(K)],
                       M, H, K, False)
        LA = 2 * H
    else:
        kin = 128
        a = rnd(rng.standard_normal((M, kin)).astype(np.float32))
        tile = _row_tile(a.view(torch.int16).numpy(), M, False)
        LA = 256
    kin = a.shape[1]
    N_full = {"w_hh": 4 * H, "w_ih": 4 * H, "lr": 256, "proj_w": 128}[what]
    w = rnd(rng.standard_normal((kin, N_full)).astype(np.float32))
    want = a.double() @ w.double()
    if what in ("w_hh", "w_ih"):
        for rank in range(K):
            cols = ops.gate_columns(H, K, rank)
            got = _product(tile, LA, ops.stage_image(w[:, cols]), 4 * (H // K), M, False)
            np.testing.assert_allclose(got, want[:, cols].numpy(), rtol=1e-12, atol=1e-12)
    else:
        got = _product(tile, LA, ops.stage_image(w), N_full, M, False)
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-12, atol=1e-12)

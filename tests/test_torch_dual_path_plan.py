"""The launch plan of the dual-path passes (`ops/dual_path_kernel.py` `_plan`,
which `csrc/dual_path_tc.cuh` `make_plan` computes again at each launch) and
the weight images of their tensor-core route: at every shape the port
launches (`chip_smoke.py`'s phases 2e, 2g and 2h, NS serving at 256 / 2,048
DPCRN and 256 / 1,024 DPARN slots, a ragged batch, the small Unet of the CPU
center tests), in float32 and bfloat16, with and without int8_hh and
xscr_half, every pass fits the 232,448 bytes of shared memory an H100 block
may use; bf16 at the models' width (CH = H = 128) takes the tensor cores,
float32 the CUDA cores; a shape nothing fits raises `DualPathPlanError`, a
ValueError. The images unpack to the weights, and a plain emulation of the
int8 mma fragments' sums equals `dot_hh_ref`. Pure Python: no card needed."""
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.ops import dual_path_kernel as dpk
from puresound_tpu_torch.ops.quant import HH_DIV, dot_hh_ref, quantize_cols

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
H100_SMS = 132
CSRC = os.path.join(os.path.dirname(os.path.dirname(dpk.__file__)), "csrc")
# tests/test_torch_masker_kernel.py's small Unet
SMALL_UNET = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
                  channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, transpose_delay=False,
                  kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
                  kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
                  delay=(0,) * 5, rnn_hidden=16, nhead=4)


def _small_unet():
    """(F, CH, H) of the small Unet's bottleneck."""
    m = DPARN(generator=torch.Generator().manual_seed(0), **SMALL_UNET)
    st = m.init_stream_state(2, mk_kernel=True)
    return st["dc"][0].shape[0], st["u0h"].shape[-1], st["h1"].shape[-1]


def _shapes():
    """(label, F, K, B, CH, H) of every dual-path launch."""
    out = [(f"2e {n}", F, K, B, CH, H) for n, B, F, K, CH, H, _ in chip_smoke.DP_CASES]
    out += [(f"2g {n} B={B}", 64, 2, B, 128, 128) for n, _, B, _ in chip_smoke.CENTER_CASES]
    B, F, K, CH, H = chip_smoke.QDP_SHAPE
    out += [(f"2h B={B}", F, K, B, CH, H)]
    out += [(f"4b/4d DPCRN {n} slots", 64, 2, n, 128, 128) for n in chip_smoke.NS_SLOTS]
    out += [(f"4c/4h DPARN {n} slots", 64, 2, n, 128, 128) for n in chip_smoke.DPARN_SLOTS]
    out += [("ragged B=1001", 64, 2, 1001, 128, 128)]
    F, CH, H = _small_unet()
    out += [(f"CPU center tests B={B}", F, 2, B, CH, H) for B in (3, 1)]
    return out


SHAPES = _shapes()
OPTIONS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("options", OPTIONS, ids=["plain", "int8_hh", "xscr_half", "both"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_pass_has_a_route_that_fits(shape, bf16, options):
    _, F, K, B, CH, H = shape
    int8_hh, xscr_half = options
    plan = dpk._plan(F, K, B, CH, H, bf16, bf16, int8_hh)
    assert len(plan.ints()) == 9 and plan.ints()[0] == int(plan.route == "mma")
    assert max(plan.a_smem, plan.b_smem, plan.c_smem) <= SMEM_MAX
    # xscr_half changes the scratch's dtype, not the layout
    assert plan == dpk._plan(F, K, B, CH, H, bf16, bf16, int8_hh)
    if CH == H == 128:
        assert plan.route == ("mma" if bf16 else "cuda")
    if plan.route == "mma":
        assert plan.passes == {"A": "mma", "B": "wgmma", "C": "mma"}
        R, NI = K * B, F * B
        # pass A: clusters of 2 CTAs a (row tile, direction), one wave where it fits
        assert plan.a_rows in (16, 32, 64, 128) and plan.a_xbuf in (1, 2)
        assert 4 * -(-R // plan.a_rows) <= H100_SMS or plan.a_rows == 128
        if plan.a_rows > 16:
            assert 4 * -(-R // (plan.a_rows // 2)) > H100_SMS
        assert plan.c_rows in (32, 64) and plan.b_rows == 128
        assert plan.a_smem == dpk.chain_smem(CH, H, plan.a_rows, plan.a_xbuf, int8_hh, False)
        assert plan.c_smem == dpk.chain_smem(CH, H, plan.c_rows, plan.c_xbuf, int8_hh, True)
        assert plan.b_smem == dpk.proj_smem(CH, H)
        if plan.a_xbuf == 1:   # a second x buffer would not fit
            assert dpk.chain_smem(CH, H, plan.a_rows, 2, int8_hh, False) > SMEM_MAX
    else:
        assert plan.passes == {"A": "cuda", "B": "cuda", "C": "cuda"}
        assert plan.a_xbuf == plan.c_xbuf == 0
        assert all(1 <= g <= 64 for g in (plan.a_rows, plan.b_rows, plan.c_rows))


@pytest.mark.parametrize("B", [256, 1024, 2048, 1001, 3])
@pytest.mark.parametrize("int8_hh", [False, True], ids=["bf16", "int8_hh"])
def test_model_geometry_takes_the_tensor_cores(B, int8_hh):
    plan = dpk._plan(64, 2, B, 128, 128, True, True, int8_hh)
    assert plan.route == "mma"
    # bf16 weights with float32 dots, and float32, keep the CUDA cores
    assert dpk._plan(64, 2, B, 128, 128, True, False, int8_hh).route == "cuda"
    assert dpk._plan(64, 2, B, 128, 128, False, False, int8_hh).route == "cuda"


def test_tile_sizes_at_the_serving_points():
    # 2,048 DPCRN streams: 4,096 rows a direction in 32 tiles of 128, one x
    # buffer; 256 streams: tiles of 16 rows
    assert dpk._plan(64, 2, 2048, 128, 128, True, True).ints()[:4] == [1, 128, 1, 230400]
    assert dpk._plan(64, 2, 256, 128, 128, True, True).ints()[:3] == [1, 16, 2]
    assert dpk._plan(64, 2, 1024, 128, 128, True, True).c_rows == 64


@pytest.mark.parametrize("CH,H,bf16", [(1024, 512, False), (512, 1024, True),
                                       (256, 1024, False)],
                         ids=["CH=1024 f32", "H=1024 bf16", "H=1024 f32"])
def test_a_shape_nothing_fits_raises(CH, H, bf16):
    with pytest.raises(dpk.DualPathPlanError) as e:
        dpk._plan(64, 2, 256, CH, H, bf16, bf16)
    assert isinstance(e.value, ValueError)


@pytest.mark.parametrize("H", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_gate_image_unpacks_to_the_weight(H, dtype):
    gen = torch.Generator().manual_seed(H)
    K = 96
    w = torch.randn(K, 4 * H, generator=gen)
    w = quantize_cols(w)[0] if dtype == torch.int8 else w.to(dtype)
    img = dpk.gate_image(w)
    U = H // 2
    assert img.shape == (2, 4 * U, K) and img.dtype == dtype and img.is_contiguous()
    assert torch.equal(dpk.gate_unimage(img), w)
    # row ug * 32 + q * 8 + u of rank r is gate q of unit r * U + ug * 8 + u
    for r, ug, q, u in ((0, 0, 0, 0), (1, U // 8 - 1, 3, 7), (1, 0, 2, 5), (0, U // 8 - 1, 1, 3)):
        assert torch.equal(img[r, ug * 32 + q * 8 + u], w[:, q * H + r * U + ug * 8 + u])


def test_proj_image_is_the_stacked_transpose():
    gen = torch.Generator().manual_seed(1)
    pf, pb = torch.randn(128, 64, generator=gen), torch.randn(128, 64, generator=gen)
    img = dpk.proj_image(pf, pb)
    assert img.shape == (64, 256) and img.is_contiguous()
    assert torch.equal(img[:, :128], pf.t()) and torch.equal(img[:, 128:], pb.t())
    assert torch.equal(dpk.proj_image(pf), pf.t())


TC_SRC = open(os.path.join(CSRC, "dual_path_tc.cuh")).read()


def _src(pattern: str, text: str = TC_SRC) -> str:
    """One C expression of csrc/dual_path_tc.cuh (integer arithmetic, whose
    operators and precedence Python shares)."""
    return re.search(pattern, text).group(1)


def _q8_product() -> dict:
    """The chain kernel's int8 recurrent product as the source writes it, each
    expression compiled: the ldmatrix.x4 lane addressing, the swizzle, the
    fragments each m16n8k32 takes, the scale each sum gets and the gate
    column of an image row."""
    body = TC_SRC[TC_SRC.index("// h @ W_hh: bf16, or int8"):]
    body = body[:body.index("} else {")]
    flat = TC_SRC.replace("\n", " ")
    exprs = dict(
        a_r=_src(r"const int a_r = (.+?), a_hi"), a_hi=_src(r", a_hi = (.+?);"),
        b_r=_src(r"const int b_r = (.+?), b_hi"), b_hi=_src(r", b_hi = (.+?);"),
        lx=_src(r"const int lx = (.+?);"), mh=_src(r", mh = (.+?);"),
        swz1=_src(r"int swz1\(int row, int k, int L\) \{.*?return (.+?);", flat),
        a0=_src(r"const uint32_t a0 = (ahc .+?);", body), a=_src(r"ldsm_x4\(a, (.+?)\);", body),
        b0=_src(r"const uint32_t b0 = (Wh_s .+?);", body),
        b01=_src(r"ldsm_x4\(b01, (.+?)\);", body), b23=_src(r"ldsm_x4\(b23, (.+?)\);", body),
        scale=_src(r"isum\[q\]\[e\] \* scale_s\[(.+?)\];", body),
        unit=_src(r"const int unit = (rank \* U .+?), q = "),
        gate=_src(r"const int unit = rank \* U .+?, q = (.+?);"))
    out = {k: compile(v, k, "eval") for k, v in exprs.items()}
    out["mmas"] = [(int(q), regs, int(r0), int(r1)) for q, regs, r0, r1 in re.findall(
        r"mma_s8\(isum\[(\d)\], a, (b\d\d)\[(\d)\], b\d\d\[(\d)\]\);", body)]
    return out


def _ldmatrix_x4(mem: np.ndarray, addr: list) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4.b16: lane 8 i + j gives the address of
    row j of matrix i; lane l receives word l % 4 of row l / 4 of each matrix.
    [32 lanes, 4 registers, 4 bytes]."""
    rows = np.array([[mem[addr[8 * i + l // 4] + 4 * (l % 4) + np.arange(4)] for i in range(4)]
                     for l in range(32)])
    return rows.astype(np.int64)


def _mma_m16n8k32(a: np.ndarray, b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k32 s8.s8.s32 by its fragment layout (lane l: group g = l
    / 4, t = l % 4): a0 / a1 rows g / g + 8 at k 4t .. 4t + 3, a2 / a3 the
    same at k + 16; b0 column g at k 4t .., b1 at k + 16; d0, d1 row g,
    columns 2t, 2t + 1; d2, d3 row g + 8. Returns d [32 lanes, 4]."""
    A, Bt = np.zeros((16, 32), np.int64), np.zeros((8, 32), np.int64)
    for l in range(32):
        g, t = divmod(l, 4)
        for r, (row, k) in enumerate(((g, 0), (g + 8, 0), (g, 16), (g + 8, 16))):
            A[row, k + 4 * t:k + 4 * t + 4] = a[l, r]
        Bt[g, 4 * t:4 * t + 4], Bt[g, 16 + 4 * t:20 + 4 * t] = b0[l], b1[l]
    D = A @ Bt.T
    return np.array([[D[l // 4 + 8 * (e // 2), 2 * (l % 4) + (e & 1)] for e in range(4)]
                     for l in range(32)])


@pytest.mark.parametrize("M", [16, 48])
@pytest.mark.parametrize("H", [32, 64, 128])
def test_int8_fragment_sums_equal_dot_hh(H, M):
    """The int8_hh recurrent product of the tensor-core chains: h quantized
    into its swizzled tile and W_hh's image into each rank's, read at the
    kernel's ldmatrix.x4 addresses into m16n8k32 fragments, summed in
    integers and scaled once per column, equals `dot_hh_ref` bit for bit (as
    the CUDA-core route's __dp4a sums do) over every m-tile and unit group."""
    src = _q8_product()
    assert [q for q, *_ in src["mmas"]] == [0, 1, 2, 3]
    ev = lambda name, **v: eval(src[name], {"min": min}, v)
    rng = np.random.default_rng(H + M)
    h = np.tanh(2.0 * rng.standard_normal((M, H))).astype(np.float32)
    h[0, :4] = [1.0, -1.0, 0.5 / 127, -1.5 / 127]   # the clip and round-half-even
    wq, col_max = quantize_cols(torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32)))
    s = (col_max / HH_DIV).numpy()
    want = dot_hh_ref(torch.from_numpy(h), wq, torch.from_numpy(s)).numpy()

    U, LH = H // 2, H
    swz1 = lambda row, k: ev("swz1", row=row, k=k, L=H, m=min(H >> 4, 8) - 1)
    hq = torch.round(torch.from_numpy(h) * 127.0).clamp(-127, 127).to(torch.int8).numpy()
    h_tile = np.zeros(M * H, np.int8)
    for m in range(M):
        for k in range(H):
            h_tile[swz1(m, k)] = hq[m, k]
    img = dpk.gate_image(wq).numpy()
    got = np.full((M, 4 * H), np.nan, np.float32)
    for rank in range(2):
        w_tile = np.zeros(2 * H * H, np.int8)
        for n in range(2 * H):
            for k in range(H):
                w_tile[swz1(n, k)] = img[rank, n, k]
        # image row n -> its gate column (scale_s and the cell update)
        cols = [ev("unit", rank=rank, U=U, n=n) + H * ev("gate", n=n) for n in range(2 * H)]
        for m0 in range(0, M, 16):
            for ug in range(U // 8):
                n0 = [ug * 32]
                addr = {"a": [], "b01": [], "b23": []}
                for ks in range(H // 32):
                    for lane in range(32):
                        v = dict(lane=lane, LH=LH, ahc=0, Wh_s=0, m0=m0, n0=n0, u=0, ks=ks)
                        for name in ("a_r", "a_hi", "b_r", "b_hi", "lx", "mh", "a0", "b0"):
                            v[name] = ev(name, **v)
                        for name in addr:
                            addr[name].append(ev(name, **v))
                isum = np.zeros((4, 32, 4), np.int64)
                for ks in range(H // 32):
                    lanes = slice(32 * ks, 32 * ks + 32)
                    a = _ldmatrix_x4(h_tile, addr["a"][lanes])
                    b = {r: _ldmatrix_x4(w_tile, addr[r][lanes]) for r in ("b01", "b23")}
                    for q, regs, r0, r1 in src["mmas"]:
                        isum[q] += _mma_m16n8k32(a, b[regs][:, r0], b[regs][:, r1])
                for q in range(4):
                    for lane in range(32):
                        g, tq = divmod(lane, 4)
                        for e in range(4):
                            n = ev("scale", n0=n0, u=0, q=q, tq=tq, e=e)
                            got[m0 + g + 8 * (e // 2), cols[n]] = (
                                np.float32(isum[q, lane, e]) * s[cols[n]])
    np.testing.assert_array_equal(got, want)


def test_images_are_cached_until_a_weight_changes():
    ws = [w.to(torch.bfloat16) for w in chip_smoke.dp_weights(
        64, 32, torch.Generator().manual_seed(3), n_blocks=1)]
    first = dpk.tc_images(ws, False, 1)
    assert len(first) == 8
    assert all(a is b for a, b in zip(dpk.tc_images(ws, False, 1), first))
    assert torch.equal(dpk.gate_unimage(first[0]), ws[0])
    with torch.no_grad():
        ws[1].add_(1.0)       # in place: a new version, packed again
    again = dpk.tc_images(ws, False, 1)
    assert again[1] is not first[1] and torch.equal(dpk.gate_unimage(again[1]), ws[1])


def test_pass_launches_are_counted_by_route():
    dpk.LAUNCHES_BY_PASS.clear()
    dpk.count_passes(dpk._plan(64, 2, 2048, 128, 128, True, True), 2)
    dpk.count_passes(dpk._plan(64, 2, 1024, 128, 128, False, False), 2, "C")
    assert dpk.LAUNCHES_BY_PASS == {"A:mma": 2, "B:wgmma": 2, "C:mma": 2, "C:cuda": 2}
    dpk.LAUNCHES_BY_PASS.clear()


def test_the_plan_constants_are_the_sources():
    src = open(os.path.join(CSRC, "dual_path_tc.cuh")).read()
    num = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert num("SMEM_MAX") == dpk.SMEM_MAX == SMEM_MAX
    assert (num("B_ROWS"), num("RED_BYTES")) == (dpk.B_ROWS, dpk.RED_BYTES)
    assert num("PLAN_FIELDS") == len(dpk._plan(64, 2, 4, 128, 128, True, True).ints())
    assert re.search(r"return \(CH == 64 \|\| CH == 128\) && \(H == 32 \|\| H == 64 \|\| "
                     r"H == 128\);", src) and dpk.TC_CH == (64, 128) and dpk.TC_H == (32, 64, 128)
    gates = open(os.path.join(CSRC, "lstm_gates.cuh")).read()
    assert int(re.search(r"constexpr int RB = (\d+);", gates).group(1)) == dpk.RB

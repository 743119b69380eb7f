"""The launch plan of the training TCN block (`ops/tcn_train_kernel.py`
`_plan`, which `csrc/tcn_train.cu` computes again and checks at each
launch): at every shape the port launches, the route per dtype (bf16 at
the model's widths on wgmma, everything else on CUDA cores), shared memory
within the 232,448 bytes an H100 block may use, weight-gradient column
ranges that cover the B*T columns exactly once in a fixed order, and the
scratch size; a shape no route takes raises `TcnPlanError`, a ValueError.
The shapes are `chip_smoke.py`'s phase 2c cases, the speaker net's training
shapes at every dilation of its blocks, the serving attach, and those the
flagship launches in a small CPU forward, collected by wrapping
`tcn_block_train` where `nnet/conv_tasnet.py` calls it. Pure Python: no
card needed."""
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet import conv_tasnet
from puresound_tpu_torch.ops import tcn_train_kernel as tk

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
DILATIONS = (1, 2, 4, 8, 16)   # the speaker net's five blocks (zoo/tse.py)
SOURCE = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc", "tcn_train.cu")


def _shapes():
    """(name, B, C, Ch, T, k, dilation) the port launches the block at."""
    out = [(f"2c {n}", B, C, Ch, T, 3, d) for n, B, C, Ch, T, d, _ in chip_smoke.TCN_CASES]
    out += [(f"speaker B=64 T=1999 d={d}", 64, 128, 256, 1999, 3, d) for d in DILATIONS]
    out += [(f"recipe B=12 T=4999 d={d}", 12, 128, 256, 4999, 3, d) for d in DILATIONS]
    out += [("serving attach B=1 T=999", 1, 128, 256, 999, 3, 1)]
    out += [(f"2l {n}", B, C, Ch, T, 3, d) for n, B, C, Ch, T, d, _ in chip_smoke.ZOO_TCN_CASES]
    # tse_skim_v2_causal's speaker net (FbankEnc: 80 banks, 512-sample frames
    # at hop 128) at a 1 s serving attach and the recipe's 5 s enrollments
    out += [(f"v2 speaker B={B} T={T} d={d}", B, 80, 256, T, 3, d)
            for B, T in ((1, 122), (12, 622)) for d in DILATIONS]
    return out


def _scratch(B, C, Ch, T, k, pl, backward):
    """The float32 scratch of one call, region by region as `carve` in
    csrc/tcn_train.cu lays it out (each region rounded up to 64 floats)."""
    al = lambda n: -(-n // 64) * 64
    wg = pl.route == "wgmma"
    Tp = -(-T // 8) * 8
    regions = [B * Ch * Tp] * (5 if backward else 3)
    tiles = lambda g: -(-T // g.ncol)
    pst = (max(Ch, tiles(pl.gemms[0]), tiles(pl.gemms[1])) if wg
           else max(Ch, -(-T // 64) * -(-Ch // 64)))
    regions += [B * pst * 2, 6 * B]
    regions += [Ch * C, Ch, Ch, 1, Ch * k, Ch, Ch, Ch, 1, Ch * Ch, Ch, Ch, Ch, 1, C * Ch, C]
    if backward:
        regions += [6 * B, B * Ch * 3]
        if wg:
            regions.append(B * max(tiles(pl.gemms[3]), tiles(pl.gemms[4])) * Ch * 3)
        regions.append(B * Ch * (1 + k))
        regions.append(max(w.n_split * w.O * w.K for w in pl.wgrads))
        regions.append(max(w.n_split * w.O for w in pl.wgrads))
        if not wg:
            regions += [C * Ch, Ch * Ch, Ch * C]
    if wg:
        regions += [g.O * g.K // 2 for g in pl.gemms[:6 if backward else 3]]
    return sum(al(n) for n in regions)


def _check(B, C, Ch, T, k, d, dtype):
    """The plan of one shape, held to the constraints of the CUDA source."""
    pl = tk._plan(B, C, Ch, T, k, dtype, d)
    want = ("wgmma" if dtype == torch.bfloat16 and C in (64, 128, 256)
            and Ch in (64, 128, 256) else "cuda_cores")
    assert pl.route == want
    assert pl.pitch % 8 == 0 and T <= pl.pitch < T + 8
    smem = [g.smem for g in pl.gemms] + [w.smem for w in pl.wgrads] + list(pl.dw_smem)
    assert 0 <= max(smem) <= SMEM_MAX
    assert len(pl.ints()) == 2 + 2 * 6 + 4 * 3 + 2
    dims = [(Ch, C), (Ch, Ch), (C, Ch), (Ch, C), (Ch, Ch), (C, Ch)]
    for g, (O, K) in zip(pl.gemms, dims):
        assert (g.O, g.K) == (O, K)
        if want == "wgmma":   # the weight resident, two column tiles, 1 KB of alignment
            fixed = 1024 + 2 * O * K + tk.STAGE_BYTES   # alignment, W, epilogue staging
            assert g.ncol in (64, 128) and g.smem == fixed + 4 * g.ncol * K
            assert (g.ncol == 128) == (O <= 128 and fixed + 4 * 128 * K <= SMEM_MAX)
        else:
            assert (g.ncol, g.smem) == (64, 0)
    for w, (O, K) in zip(pl.wgrads, [(C, Ch), (Ch, Ch), (Ch, C)]):
        assert (w.O, w.K) == (O, K) and w.n_split >= 1
        if want == "wgmma":
            ob = 128 if K == 256 else 256
            assert w.n_ob == -(-O // ob) and w.n_split * w.n_ob <= tk.H100_SMS
            assert w.smem == 1024 + 2 * (ob + K) * 128
        else:
            assert w.n_split <= tk.MAX_SPLIT and w.per_split % 32 == 0 and w.n_ob == 1
        _covers(_ranges(w, want == "wgmma", B, T), B, T)
    assert pl.fwd_scratch == _scratch(B, C, Ch, T, k, pl, False)
    assert pl.bwd_scratch == _scratch(B, C, Ch, T, k, pl, True)
    return pl


def _ranges(w, chunked, B, T):
    """Each split's columns as (sample, first, end) runs, in order, as the
    weight-gradient kernels walk them: on wgmma split z takes the chunks
    [z * per_split, (z + 1) * per_split) of the B * ceil(T / WG_COLS)
    chunks of WG_COLS columns within a sample (`tcn_wg_wgrad`); on CUDA
    cores the flat columns [z * per_split, (z + 1) * per_split) of B * T
    (`tcn_wgrad_kernel`)."""
    out = []
    for z in range(w.n_split):
        runs = []
        if chunked:
            tc = -(-T // tk.WG_COLS)
            for c in range(z * w.per_split, min(B * tc, (z + 1) * w.per_split)):
                b, t0 = divmod(c, tc)
                runs.append((b, t0 * tk.WG_COLS, min(T, (t0 + 1) * tk.WG_COLS)))
        else:
            r0, r1 = z * w.per_split, min(B * T, (z + 1) * w.per_split)
            while r0 < r1:
                b, t = divmod(r0, T)
                n = min(T - t, r1 - r0)
                runs.append((b, t, t + n))
                r0 += n
        out.append(runs)
    return out


def _covers(splits, B, T):
    """Every (sample, column) in exactly one split, the splits in column
    order, none empty."""
    seen = np.zeros((B, T), np.int32)
    last = (-1, -1)
    for runs in splits:
        assert runs, "an empty split"
        for b, t0, t1 in runs:
            assert (b, t0) > last and 0 <= t0 < t1 <= T
            last = (b, t0)
            seen[b, t0:t1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _shapes(), ids=lambda s: s[0])
def test_plan_holds_at_the_launched_shapes(shape, dtype):
    _check(*shape[1:], dtype)


def test_speaker_net_bf16_takes_wgmma_with_its_tiles():
    """At the speaker shape the products with 256 output rows walk 64-column
    tiles, the two with 128 (W_out, W_in^T) 128-column tiles, and dW_pw has
    two O-blocks."""
    pl = _check(64, 128, 256, 1999, 3, 1, torch.bfloat16)
    assert [g.ncol for g in pl.gemms] == [64, 64, 128, 64, 64, 128]
    assert [w.n_ob for w in pl.wgrads] == [1, 2, 1]
    assert _check(64, 128, 256, 1999, 3, 1, torch.float32).route == "cuda_cores"


def test_constants_match_the_source():
    """The plan's constants are the CUDA source's."""
    src = open(SOURCE).read()
    for name in ("H100_SMS", "SMEM_MAX", "WG_COLS", "DW_SEG", "ALIGN_F", "SPLIT_COLS",
                 "MAX_SPLIT"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        assert int(m.group(1)) == getattr(tk, name), name
    assert tk.SMEM_MAX == SMEM_MAX


def _flagship_launches():
    """{(B, C, Ch, T, k, dilation)} the flagship's speaker net launches in
    one small CPU forward."""
    from puresound_tpu_torch.zoo.tse import init_model

    seen = set()
    orig = conv_tasnet.tcn_block_train

    def entry(x, *params, dilation=1):
        seen.add((x.shape[0], x.shape[1], params[0].shape[0], x.shape[2],
                  params[4].shape[1], dilation))
        return orig(x, *params, dilation=dilation)

    model = init_model("tse_skim_v0_causal", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    audio = lambda n: torch.from_numpy((0.1 * rng.standard_normal((2, n))).astype(np.float32))
    conv_tasnet.tcn_block_train = entry
    try:
        with torch.no_grad():
            model.inference(audio(4000), audio(8000))
    finally:
        conv_tasnet.tcn_block_train = orig
    return seen


_FLAGSHIP = []


def _flagship():
    if not _FLAGSHIP:
        _FLAGSHIP.extend(sorted(_flagship_launches()))
    return _FLAGSHIP


@pytest.mark.parametrize("batch", [1, 12, 64])
def test_plan_covers_the_flagship_launches(batch):
    """The speaker net's blocks as the flagship launches them (the widths and
    dilations of a CPU forward), at serving and training batch sizes, both
    dtypes; bf16 on wgmma."""
    seen = _flagship()
    assert len(seen) == len(DILATIONS) and {s[5] for s in seen} == set(DILATIONS)
    for B, C, Ch, T, k, d in seen:
        for dtype in (torch.float32, torch.bfloat16):
            pl = _check(batch, C, Ch, T, k, d, dtype)
            assert pl.route == ("wgmma" if dtype == torch.bfloat16 else "cuda_cores")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_v2_speaker_net_takes_the_cuda_cores(dtype):
    """C = 80 is no wgmma width (64, 128, 256): both dtypes take the CUDA
    cores, whose 64-wide tiles cover K = 80 in two."""
    for d in DILATIONS:
        assert _check(12, 80, 256, 622, 3, d, dtype).route == "cuda_cores"


@pytest.mark.parametrize("shape", [(64, 128, 256, 1999, 4, 1), (64, 128, 256, 1999, 9, 1),
                                   (0, 128, 256, 1999, 3, 1), (64, 128, 256, 0, 3, 1),
                                   (2 ** 16, 128, 256, 2 ** 15, 3, 1),
                                   (1, 128, 256, 100, 7, 20000)],
                         ids=["even taps", "9 taps", "B=0", "T=0", "B*T=2^31",
                              "halo too wide"])
def test_plan_refuses_what_no_route_takes(shape):
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(tk.TcnPlanError):
            tk._plan(*shape[:5], dtype, shape[5])
    with pytest.raises(tk.TcnPlanError):
        tk._plan(64, 128, 256, 1999, 3, torch.float16, 1)
    assert issubclass(tk.TcnPlanError, ValueError)


def test_bf16_off_geometry_takes_cuda_cores():
    """A bf16 shape off the model's widths runs the CUDA-core kernel because
    the plan says so (phase 2c's ragged case, and widths not in {64, 128, 256})."""
    for C, Ch in ((20, 36), (128, 192), (96, 256), (128, 512)):
        assert _check(4, C, Ch, 77, 3, 2, torch.bfloat16).route == "cuda_cores"

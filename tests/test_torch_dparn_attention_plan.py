"""The launch plan of `dparn_intra_pass` (`ops/dparn_attention_kernel.py`
`plan`, which `csrc/dparn_attention.cuh` `make_plan` computes again at each
launch): every shape the port launches gets a route under the 232,448 bytes
of shared memory an H100 block may use, in float32 and bfloat16; the model's
geometry under bf16 weights and dots takes the wgmma route; a shape nothing
fits raises `AttnPlanError`, a ValueError. The shapes are `chip_smoke.py`'s
phase 2f cases, the DPARN wide center's two attention passes at phase 2g's
1,024 streams, DPARN serving at 256 / 1,024 slots (phase 4c: two frames a
tick, so R = 2 x slots), and the small DPARN of the CPU slice tests. Pure
Python: no card needed."""
import os
import re

import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.ops import dparn_attention_kernel as dak

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
H100_SMS = 132
CSRC = os.path.join(os.path.dirname(os.path.dirname(dak.__file__)), "csrc")
# tests/test_torch_dparn_slice.py's small DPARN
SMALL_UNET = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
                  channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2,
                  kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
                  kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
                  delay=(0,) * 5, rnn_hidden=16, nhead=4)


def _small_geometry():
    """(F, C, FFD, heads) of the small DPARN's intra attention."""
    m = DPARN(transpose_delay=False, generator=torch.Generator().manual_seed(0),
              **SMALL_UNET)
    st = m.init_stream_state(2, mk_kernel=True)
    ff1 = m.dprnn_block1.intra_atten1.feedforward[0]
    FFD, C = ff1.weight.shape
    return st["dc"][0].shape[0], C, FFD, m.nhead


def _shapes():
    """(label, R, F, C, FFD, heads) of every launch the port makes."""
    out = [(f"2f {n}", R, F, C, FFD, h) for n, R, F, C, h, FFD, _ in chip_smoke.ATTN_CASES]
    out += [(f"2g dparn_center_chunk B={B}", 2 * B, 64, 128, 128, 8)
            for n, _, B, _ in chip_smoke.CENTER_CASES if n == "dparn_center_chunk"]
    out += [(f"4c serving {n} slots", 2 * n, 64, 128, 128, 8) for n in chip_smoke.DPARN_SLOTS]
    F, C, FFD, heads = _small_geometry()
    out += [(f"slice tests B={B}", 2 * B, F, C, FFD, heads) for B in (2, 3)]
    return out


SHAPES = _shapes()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_launch_has_a_route_that_fits(shape, bf16):
    _, R, F, C, FFD, heads = shape
    pl = dak.plan(R, F, C, FFD, heads, bf16, bf16)
    assert pl.path in dak.PATHS and 0 < pl.smem <= SMEM_MAX
    wgmma = bf16 and (F, C, FFD, heads) == (64, 128, 128, 8)
    assert (pl.path == "wgmma") == wgmma
    if wgmma:
        # two rows a CTA, one per consumer warpgroup; persistent CTAs
        assert (pl.rows_per_cta, pl.warpgroups, pl.stages, pl.kt) == (2, 2, 3, 0)
        assert pl.ctas == min((R + 1) // 2, H100_SMS) and pl.ctas * 2 >= min(R, 2 * H100_SMS)
    else:
        # one row a CTA; the weights in two tiles of kt rows
        assert (pl.rows_per_cta, pl.warpgroups, pl.stages, pl.ctas) == (1, 0, 2, R)
        assert pl.kt in (1, 2, 4, 8, 16, 32, 64)
        act = 4 * (4 * C + max(C, FFD) + F) * (F + 4)
        assert pl.smem == act + (2 if bf16 else 4) * 2 * pl.kt * max(C, FFD)
        # the largest kt that fits: twice it would not
        assert pl.kt == 64 or act + (2 if bf16 else 4) * 4 * pl.kt * max(C, FFD) > SMEM_MAX
    assert len(pl.ints()) == 7 and pl.ints()[0] == dak.PATHS.index(pl.path)


@pytest.mark.parametrize("R", [1, 2, 3, 264, 265, 512, 2048, 4096, 100_000])
def test_model_geometry_under_bf16_takes_wgmma(R):
    pl = dak.plan(R, 64, 128, 128, 8, True, True)
    assert pl.path == "wgmma" and pl.smem == dak.WG_SMEM <= SMEM_MAX
    assert pl.ctas == min((R + 1) // 2, H100_SMS)
    assert dak.plan(R, 64, 128, 128, 8, True, True, sms=114).ctas == min((R + 1) // 2, 114)


@pytest.mark.parametrize("w_bf16,dot_bf16", [(False, False), (False, True), (True, False)])
def test_other_dtypes_keep_the_one_row_kernel(w_bf16, dot_bf16):
    # float32 dots stay on CUDA cores (TF32 would change the numerics); bf16
    # dots with float32 weights run the CUDA-core products too
    pl = dak.plan(4096, 64, 128, 128, 8, w_bf16, dot_bf16)
    assert pl.path == "cuda_cores" and pl.ctas == 4096


@pytest.mark.parametrize("geometry", [(32, 64, 64, 4), (64, 128, 128, 4), (8, 16, 16, 4)],
                         ids=["F=32 C=64", "Dh=32", "F=8"])
def test_bf16_other_geometry_takes_the_cuda_core_kernel(geometry):
    # wgmma or CUDA cores: no third route under bf16
    pl = dak.plan(100, *geometry, True, True)
    assert pl.path == "cuda_cores" and pl.ctas == 100


@pytest.mark.parametrize("args", [(4, 128, 128, 128, 8), (4, 96, 128, 256, 8),
                                  (0, 64, 128, 128, 8), (4, 64, 128, 128, 0)],
                         ids=["F=128", "F=96 FFD=256", "R=0", "heads=0"])
def test_a_shape_nothing_fits_raises(args):
    with pytest.raises(dak.AttnPlanError) as e:
        dak.plan(*args, False, False)
    assert isinstance(e.value, ValueError)


def test_the_plan_constants_are_the_sources():
    src = open(os.path.join(CSRC, "dparn_wgmma.cuh")).read()
    num = lambda name: int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))
    assert (num("NWG"), num("STAGES"), num("NPROD")) == (dak.WG_WARPGROUPS, dak.WG_STAGES,
                                                          dak.WG_PRODUCTS)
    assert re.search(r"F = 64, C = 128, DH = 16", src)
    hdr = open(os.path.join(CSRC, "dparn_attention.cuh")).read()
    assert re.search(r"PLAN_FIELDS = 7", hdr)
    paths = re.search(r"enum Path \{([^}]*)\}", hdr).group(1)
    names = re.findall(r"PATH_(\w+) = (\d)", paths)
    assert [(n.lower(), int(v)) for n, v in names] == [(p, i) for i, p in enumerate(dak.PATHS)]


def test_launches_by_path_is_a_count_by_route():
    assert isinstance(dak.LAUNCHES_BY_PATH, dict)
    assert dak.packed_scratch(dak.plan(8, 8, 16, 16, 4, True, True), "cpu") is None
    packed = dak.packed_scratch(dak.plan(8, 64, 128, 128, 8, True, True), "cpu", 2)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 2 * 13 * 128 * 128

"""The launch plans of the wide center's six convs (`ops/masker_kernel.py`
`conv_plan`, which `csrc/masker.cu` `conv_plan` computes again at each
launch): at every center shape the port launches, in float32 and bfloat16,
each conv gets a route under the 232,448 bytes of shared memory an H100
block may use; under bf16 weights and dots the models' convs keep their
weights resident on wgmma (u0, with 12 taps of 128 x 64, in 64-row tiles);
float32 keeps the CUDA-core loop; a conv nothing fits raises
`MaskerPlanError`, a ValueError. The shapes are `chip_smoke.py`'s phase 2g
and 2h centers (DPCRN at 2,048 streams, DPARN at 1,024), NS serving at 256 /
2,048 (DPCRN) and 256 / 1,024 (DPARN) slots, a ragged batch, and the small
Unet of the CPU center tests. Pure Python: no card needed."""
import os
import re

import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.ops import dparn_attention_kernel as dak
from puresound_tpu_torch.ops import masker_kernel as mk

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
SMEM_PER_SM = 233472
H100_SMS = 132
CSRC = os.path.join(os.path.dirname(os.path.dirname(mk.__file__)), "csrc")
FULL = (32, 32, 64, 64, 128, 32, 32)    # (C0, C2, C3, C4, CH, Cu2, yC) of both zoo models
# tests/test_torch_masker_kernel.py's small Unet (with DPARN's 4 heads)
SMALL_UNET = dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
                  channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, transpose_delay=False,
                  kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
                  kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
                  delay=(0,) * 5, rnn_hidden=16, nhead=4)


def _chans(m, B=2):
    """(F, channel counts) of a masker's wide center, as chip_smoke reads them."""
    st = m.init_stream_state(B, mk_kernel=True)
    return st["dc"][0].shape[0], (st["dc"][0].shape[-1], st["dc"][1].shape[-1],
                                  st["dc"][2].shape[-1], st["u1h"].shape[-1],
                                  st["u0h"].shape[-1], st["u2h"].shape[-1], None)


def _shapes():
    """(label, F, B, chans) of every wide-center launch."""
    out = [(f"2g {n} B={B}", 64, B, FULL) for n, _, B, _ in chip_smoke.CENTER_CASES]
    out += [(f"4b/4d DPCRN {n} slots", 64, n, FULL) for n in chip_smoke.NS_SLOTS]
    out += [(f"4c/4h DPARN {n} slots", 64, n, FULL) for n in chip_smoke.DPARN_SLOTS]
    out += [("ragged B=1001", 64, 1001, FULL)]
    F, ch = _chans(DPARN(generator=torch.Generator().manual_seed(0), **SMALL_UNET))
    # y, the u2 output, has the d1 output's width
    out += [(f"CPU center tests B={B}", F, B, ch[:6] + (ch[0],)) for B in (3, 1)]
    return out


SHAPES = _shapes()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_every_conv_has_a_route_that_fits(shape, bf16):
    _, F, B, chans = shape
    rows = F * 2 * B
    plans = mk.conv_plans(F, 2, B, chans, bf16)
    assert len(plans) == 6
    for (Ch, Cs, Co), pl in zip(mk.conv_layers(chans), plans):
        assert 0 < pl.smem <= SMEM_MAX and len(pl.ints()) == 6
        width = lambda c: c in (32, 64, 128, 256)   # swizzled tile widths
        tc = bf16 and width(Ch) and (Cs == 0 or width(Cs))
        assert (pl.weights == "resident") == (tc and Co // pl.co_split in (32, 64, 128))
        if pl.weights == "resident":
            # persistent CTAs, a multiple of the C_out split, at most 2 an SM
            assert pl.tm in (mk.TC_TM, mk.TC_TM // 2) and pl.stages in (2, 3)
            assert Co % pl.co_split == 0 and (pl.tm == mk.TC_TM or Co // pl.co_split >= 64)
            assert pl.smem == (1024 + 2 * 6 * (Co // pl.co_split) * (Ch + Cs)
                               + 2 * pl.stages * pl.tm * max(Ch, Cs))
            per_sm = min(2, SMEM_PER_SM // (pl.smem + 1024))
            tiles = -(-rows // pl.tm) * pl.co_split
            assert pl.ctas % pl.co_split == 0 and pl.ctas <= min(tiles, H100_SMS * per_sm)
            assert pl.ctas >= min(tiles, H100_SMS * per_sm) - pl.co_split + 1
        else:
            # the CUDA-core loop: one tile of tm rows a CTA, each tap's weights staged
            assert pl.co_split == 1 and pl.stages == 1 and pl.tm % 4 == 0
            assert pl.tm * Co <= 8192 and pl.ctas * pl.tm >= rows


@pytest.mark.parametrize("B", [256, 1024, 2048, 1001, 3])
def test_model_convs_are_resident_under_bf16(B):
    plans = dict(zip(("d2", "d3", "d4", "u0", "u1", "u2"), mk.conv_plans(64, 2, B, FULL, True)))
    assert all(p.weights == "resident" and p.co_split == 1 for p in plans.values())
    assert all(plans[n].stages == 3 and plans[n].tm == 128
               for n in ("d2", "d3", "d4", "u1", "u2"))
    # u0's 2 x 6 x 128 x 64 bf16 weights (192 KB) leave room for two 64-row
    # buffers only
    assert (plans["u0"].tm, plans["u0"].stages) == (64, 2) and plans["u0"].smem <= SMEM_MAX
    assert mk.path_key(None, plans.values()) == "conv=resident"
    attn = dak.plan(2 * B, 64, 128, 128, 8, True, True)
    assert mk.path_key(attn, plans.values()) == "attn=wgmma,conv=resident"


def test_float32_keeps_the_cuda_core_loop():
    plans = mk.conv_plans(64, 2, 1024, FULL, False)
    assert {p.weights for p in plans} == {"streamed"}
    assert mk.path_key(dak.plan(2048, 64, 128, 128, 8, False, False),
                       plans) == "attn=cuda_cores,conv=streamed"


@pytest.mark.parametrize("Ch,Cs,Co,bf16", [(256, 256, 256, False), (256, 256, 256, True),
                                           (8, 0, 0, True), (8, 0, 8, False)],
                         ids=["256ch f32", "256ch bf16", "Co=0", "rows=0"])
def test_a_conv_nothing_fits_raises(Ch, Cs, Co, bf16):
    rows = 0 if Co == 8 else 1000
    with pytest.raises(mk.MaskerPlanError) as e:
        mk.conv_plan(Ch, Cs, Co, rows, bf16)
    assert isinstance(e.value, ValueError)


def test_pack_elems_cover_the_resident_images():
    # each part's [C_out][6 taps][C] in blocks of N rows; u0 of the zoo models
    assert mk.pack_elems(128, 128, 64) == 6 * 64 * 256
    assert mk.pack_elems(32, 0, 32) == 6 * 32 * 32


def test_the_plan_constants_are_the_sources():
    src = open(os.path.join(CSRC, "masker.cu")).read()
    num = lambda name: int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert num("TC_TM") == mk.TC_TM
    assert (num("SMEM_PER_SM"), num("BLOCK_RESERVE")) == (mk.SMEM_PER_SM, mk.BLOCK_RESERVE)
    assert re.search(r"CONV_PLAN_FIELDS = 6", src)
    assert re.search(r"return \(long\)NCONV \* Co \* \(Ch \+ Cs\);", src)
    assert re.search(r"return c >= 32 && c <= 256 && !\(c & \(c - 1\)\);", src)

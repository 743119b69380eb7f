"""The layout plan of the training LSTM kernels (`ops/lstm_train_kernel.py`
`_plan`, which `csrc/lstm_train.cu` checks again at each launch): every
shape the port launches gets a layout under the 227 KB of shared memory an
H100 block may use, in float32 and bfloat16, and a shape none fits raises
`LstmPlanError`, a ValueError. The shapes are `chip_smoke.py`'s phase 2b / 2j
cases and those the port's models launch in a small-batch CPU forward,
collected by wrapping the four entries where `nnet/lobe/rnn.py` calls them.
Pure Python: no card needed."""
import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu_torch.nnet import skim
from puresound_tpu_torch.nnet.lobe import rnn
from puresound_tpu_torch.ops import lstm_train_kernel as lk

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

SMEM_MAX = 232448   # bytes of shared memory a block may use on the H100
H100_CLUSTERS = 15  # clusters of 8 CTAs an H100 SXM holds at once (the card's report)


def _check(B, C, H, bf16, clusters=None):
    """The plan of one shape, held to the constraints of the CUDA source."""
    pl = lk._plan(B, C, H, bf16, clusters)
    Hp = pl.CL * pl.U
    assert pl.CL in (1, 2, 4, 8) and pl.U % 8 == 0 and Hp % 16 == 0 and Hp >= H
    assert pl.Cp >= C and (pl.Cp % 16 == 0 if bf16 else pl.Cp == C)
    for chain, xp in ((pl.fwd, pl.fwd.xproj), (pl.bwd, 0)):
        assert 0 < chain.smem <= SMEM_MAX and chain.nbuf in (1, 2)
        assert chain.M % (16 if bf16 else 4) == 0 and chain.n_tiles * chain.M >= B
        # the threads' tiles: bf16 two (16-row, 8-unit) pairs a warp of 8,
        # float32 one 4-row x 2-unit tile a thread of 256
        tiles = ((chain.M // 16) * (pl.U // 8) if bf16
                 else (chain.M // 4) * (pl.U // 2))
        assert tiles <= (16 if bf16 else 256)
    assert not (bf16 and pl.fwd.xproj) and not (C == 0 and pl.fwd.xproj)
    cp = 0 if pl.fwd.xproj else pl.Cp
    assert pl.fwd.smem == lk._fwd_smem(bf16, pl.CL, pl.U, pl.fwd.M, cp, pl.fwd.nbuf)
    assert pl.bwd.smem == lk._bwd_smem(bf16, pl.CL, pl.U, pl.bwd.M, pl.bwd.nbuf)
    if not pl.fwd.xproj:   # x staged in 8 chunks of 16 bytes a thread
        assert pl.fwd.M * -(-C // (8 if bf16 else 4)) <= 8 * 256
    return pl


def _cases():
    """(name, rows, C, H) of phases 2b and 2j: the fused scans, and the
    hoisted ones (C = 0) of 2j."""
    out = [(f"2b {n}", B, C, H) for n, B, T, C, H, rev, reps in chip_smoke.LSTM_CASES]
    for n, B, T, C, H, rev, reps in chip_smoke.UNFUSED_CASES:
        out += [(f"2j {n} fp_tm", B, C, H), (f"2j {n} hoisted", B, 0, H)]
    out += [(f"2l {n}", B, C, H) for n, B, T, C, H, rev, reps in chip_smoke.ZOO_LSTM_CASES]
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_plan_fits_the_chip_cases(case, bf16):
    _, B, C, H = case
    _check(B, C, H, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_seglstm_rows_run_in_one_wave(bf16):
    """At the flagship's training shape (896 rows, C=128, H=256) every row
    tile of both chains is in flight at once on an H100 (15 clusters of 8),
    and the layouts are the ones the source's note describes."""
    pl = _check(896, 128, 256, bf16, clusters=lambda CL: H100_CLUSTERS)
    assert (pl.CL, pl.U) == (8, 32)
    assert pl.fwd.n_tiles <= H100_CLUSTERS and pl.bwd.n_tiles <= H100_CLUSTERS
    if bf16:   # W_ih and W_hh slices resident: 96 KB + padding, double buffers
        assert (pl.fwd.M, pl.fwd.nbuf, pl.fwd.xproj) == (64, 2, 0)
        assert pl.fwd.smem == 128 * 392 * 2 + 2 * 64 * 392 * 2 + 128 * 4
    else:      # the f32 slices do not fit beside the tile: x projected first
        assert (pl.fwd.M, pl.fwd.nbuf, pl.fwd.xproj) == (60, 1, 1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_zoo_layouts_the_issue_shapes_take(bf16):
    """The new zoo's layouts: v1's speaker BiLSTM at H = 192 takes 24 units a
    CTA (three 8-unit groups beside each 16-row tile under bf16); v0's
    MemLSTM at C = 2H = 512 projects x first under float32 and holds one
    224,000-byte buffer under bf16, within the 232,448 a block may use."""
    spk = _check(12, 128, 192, bf16)
    assert (spk.CL, spk.U) == (8, 24)
    mem = _check(12, 512, 256, bf16)
    if bf16:
        assert (mem.fwd.M, mem.fwd.nbuf, mem.fwd.xproj, mem.fwd.smem) == (16, 1, 0, 224000)
    else:
        assert (mem.fwd.M, mem.fwd.xproj) == (4, 1)


def _launches(model_fn, run, switches=()):
    """{(entry, B, T, C, H)} the model launches in one CPU forward, with the
    module attributes `switches` ((module, name, value)) set meanwhile."""
    seen = set()
    saved = [(rnn, n, getattr(rnn, n)) for n in ("lstm_scan_train_fp", "lstm_scan_train_fp_tm",
                                                 "lstm_scan_train", "lstm_scan_train_tm")]
    saved += [(m, n, getattr(m, n)) for m, n, _ in switches]

    def wrap(name, fn):
        def entry(x, h0, c0, *rest, **kw):
            tm = name.endswith("_tm")
            T, B = (x.shape[0], x.shape[1]) if tm else (x.shape[1], x.shape[0])
            C = 0 if name.startswith("lstm_scan_train_tm") or name == "lstm_scan_train" \
                else x.shape[-1]
            seen.add((name, B, T, C, h0.shape[-1]))
            return fn(x, h0, c0, *rest, **kw)
        return entry

    try:
        for _, n, fn in saved[:4]:
            setattr(rnn, n, wrap(n, fn))
        for m, n, v in switches:
            setattr(m, n, v)
        with torch.no_grad():
            run(model_fn())
    finally:
        for m, n, v in saved:
            setattr(m, n, v)
    return seen


def _audio(n, length, seed):
    return torch.from_numpy(
        (0.1 * np.random.default_rng(seed).standard_normal((n, length))).astype(np.float32))


def _tse(name):
    from puresound_tpu_torch.zoo.tse import init_model
    return init_model(name, device="cpu", generator=torch.Generator().manual_seed(0))


def _ns(name):
    from puresound_tpu_torch.zoo.ns import init_model
    return init_model(name, device="cpu", generator=torch.Generator().manual_seed(0))


def _gate():
    return chip_smoke.gate_model(torch.device("cpu"), torch.Generator().manual_seed(0))


_tse_run = lambda m: m.inference(_audio(2, 4000, 1), _audio(2, 4000, 2))
_ns_run = lambda m: m.inference(_audio(2, 4000, 3))
MODELS = [
    ("tse_skim_v0_causal", lambda: _tse("tse_skim_v0_causal"), _tse_run, ()),
    ("tse_skim_v0_causal FUSED_PROJ_SCAN=False TM_BLOCKS=True",
     lambda: _tse("tse_skim_v0_causal"), _tse_run,
     ((rnn, "FUSED_PROJ_SCAN", False), (skim, "TM_BLOCKS", True))),
    ("tse_skim_v0_causal TM_BLOCKS=True", lambda: _tse("tse_skim_v0_causal"), _tse_run,
     ((skim, "TM_BLOCKS", True),)),
    ("gate skim", _gate, _tse_run, ()),
    ("tse_skim_v0", lambda: _tse("tse_skim_v0"), _tse_run, ()),
    ("tse_skim_v1_causal", lambda: _tse("tse_skim_v1_causal"), _tse_run, ()),
    ("tse_skim_v2_causal", lambda: _tse("tse_skim_v2_causal"), _tse_run, ()),
    ("veve_dprnn_v0_causal", lambda: _tse("veve_dprnn_v0_causal"), _tse_run, ()),
    ("ns_dpcrn_v0_causal", lambda: _ns("ns_dpcrn_v0_causal"), _ns_run, ()),
    ("ns_dparn_v0_causal", lambda: _ns("ns_dparn_v0_causal"), _ns_run, ()),
]


@pytest.mark.parametrize("model", MODELS, ids=lambda m: m[0])
def test_plan_covers_the_models_launches(model):
    _, build, run, switches = model
    seen = _launches(build, run, switches)
    assert seen, "the forward launched no training LSTM scan"
    for entry, B, T, C, H in sorted(seen):
        for bf16 in (False, True):
            _check(B, C, H, bf16)
            # the same widths at training batch sizes
            _check(B * 32, C, H, bf16)


@pytest.mark.parametrize("shape", [(896, 128, 4096), (896, 4096, 256), (0, 128, 256),
                                   (64, -1, 256), (64, 128, 0)],
                         ids=["H=4096", "C=4096", "B=0", "C<0", "H=0"])
def test_plan_refuses_what_does_not_fit(shape):
    B, C, H = shape
    for bf16 in (False, True):
        with pytest.raises(lk.LstmPlanError):
            lk._plan(B, C, H, bf16)
    assert issubclass(lk.LstmPlanError, ValueError)

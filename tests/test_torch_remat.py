"""`TRAIN.remat` in the port (`parallel.remat`, `make_train_step(remat=)`)
on the CPU, in float64.

- a small causal Conv-TasNet TSE wrapper (BatchNorm in the masker, dropout
  0.1 in every TCN block, the AAM-softmax speaker loss) and a small DPCRN
  (BatchNorm2d, dropout 0.1): two Adam steps under remat True and "dots"
  give the gradients, the new BatchNorm statistics, the losses and the
  parameters of remat False bit for bit;
- the test catches both traps: with the dropout seeds not replayed, or
  with BatchNorm updating its statistics again in the recomputation, the
  comparison fails;
- remat True and "dots" run the TCN kernel's forward (its plain version
  here) twice a step, remat False once.
"""
import numpy as np
import pytest
import torch

from puresound_tpu_torch.nnet import conv_tasnet
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, ConvTasNet
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.dropout import Dropout
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.parallel import TrainState, make_train_step, remat

torch.set_num_threads(1)

C, CH, E, N_CLASS = 16, 24, 8, 5
F64 = dict(dtype=torch.float64)


def causal_tasnet(seed=0, dropout=0.1):
    g = torch.Generator().manual_seed(seed)
    spk = [TCN(C, CH, 3, 1, dropout=dropout, generator=g, **F64),
           AttentiveStatisticsPooling(C, 8, **F64),
           Conv1d(2 * C, E, 1, bias=False, generator=g, **F64)]
    masker = ConvTasNet(input_dim=C, embed_dim=E, embed_norm=True, tcn_kernel=3, tcn_dim=CH,
                        repeat_tcn=2, tcn_dilated_basic=2, per_tcn_stack=3,
                        tcn_with_embed=(1, 0, 0), tcn_norm="bN1d", dconv_norm="bN1d",
                        causal=True, generator=g, **F64)
    for block in masker.modules():
        if isinstance(block, TCN):
            block.drop.p = dropout
    return SoTaskWrapModule(FreeEncDec(win_length=32, hop_length=16, laten_length=C, **F64),
                            masker, spk, mask_constraint="ReLU",
                            loss_func_wav=SDRLoss.init_mode("sisnr"),
                            loss_func_spk=AAMsoftmax(E, N_CLASS, generator=g, **F64))


def small_dpcrn(seed=0):
    g = torch.Generator().manual_seed(seed)
    return SoTaskWrapModule(
        ConvEncDec(fft_length=64, win_length=64, hop_length=16, trainable=True,
                   output_format="Complex", **F64),
        DPCRN(input_type="RI", input_dim=64, norm_type="bN2d", dropout=0.1,
              channels=(1, 4, 4, 8, 8, 8), transpose_t_size=2, kernel_t=(2, 2, 2, 2, 2),
              stride_t=(1, 1, 1, 1, 1), dilation_t=(1, 1, 1, 1, 1),
              kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1),
              dilation_f=(1, 1, 1, 1, 1), delay=(0, 0, 0, 0, 0), rnn_hidden=8,
              generator=g, **F64),
        loss_func_wav=SDRLoss.init_mode("sisnr"), drop_first_bin=True,
        mask_constraint="linear", f_type="Complex", mask_type="Complex")


def _batches(kind, seed=3, n=3, L=640):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(0.3 * rng.standard_normal(s))
    out = []
    for _ in range(2):
        b = {"noisy": t(n, L), "ref_clean": t(n, L)}
        if kind == "tasnet":
            b.update(enroll=t(n, 480),
                     spk_class=torch.from_numpy(rng.integers(0, N_CLASS, n)))
        else:
            b["enroll"] = None
        out.append(b)
    return out


KINDS = {"tasnet": (causal_tasnet, dict(alpha=10.0, return_loss_detail=True)),
         "dpcrn": (small_dpcrn, None)}


def run(kind, mode):
    """(per step: loss, gradients, buffers; the final parameters) of two
    Adam steps under `mode`."""
    build, loss_kwargs = KINDS[kind]
    model = build()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = make_train_step(model, loss_kwargs=loss_kwargs, grad_clip=5.0, remat=mode)
    steps = []
    for batch in _batches(kind):
        state, m = step(state, batch)
        steps.append((m["loss"].clone(), [p.grad.clone() for p in model.parameters()],
                      [b.clone() for b in model.buffers()]))
    return steps, [p.detach().clone() for p in model.parameters()]


def _equal(a, b) -> bool:
    (sa, pa), (sb, pb) = a, b
    for (la, ga, ba), (lb, gb, bb) in zip(sa, sb):
        if not (torch.equal(la, lb) and all(map(torch.equal, ga, gb))
                and all(map(torch.equal, ba, bb))):
            return False
    return all(map(torch.equal, pa, pb))


@pytest.mark.parametrize("mode", [True, "dots"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_remat_is_bit_equal_to_plain(kind, mode):
    plain = run(kind, False)
    assert any(len(b) for _, _, b in plain[0])      # BatchNorm statistics move
    assert _equal(run(kind, mode), plain)


def _unreplayed_seed(generator):
    return int(torch.randint(2 ** 62, (), generator=generator))


@pytest.mark.parametrize("trap", ["dropout_seed", "batchnorm_update"])
def test_the_comparison_catches_each_trap(monkeypatch, trap):
    """With either repair taken out, remat True no longer equals plain: the
    comparison above is what keeps both in."""
    plain = run("tasnet", False)
    if trap == "dropout_seed":
        monkeypatch.setattr(remat, "dropout_seed", _unreplayed_seed)
    else:
        monkeypatch.setattr(remat, "recomputing", lambda: False)
    assert not _equal(run("tasnet", True), plain)


@pytest.mark.parametrize("mode,want", [(False, 1), (True, 2), ("dots", 2)])
def test_kernel_forwards_a_step(monkeypatch, mode, want):
    """The speaker net's gLN block runs through tcn_block_train; the
    recomputation launches it again (a dispatcher policy cannot keep a
    kernel's outputs)."""
    calls = []
    real = conv_tasnet.tcn_block_train
    monkeypatch.setattr(conv_tasnet, "tcn_block_train",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = causal_tasnet(dropout=0.0)
    step = make_train_step(model, loss_kwargs=KINDS["tasnet"][1], remat=mode)
    step(TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0)), _batches("tasnet")[0])
    assert len(calls) == want


def test_dropout_replay_and_bad_modes():
    g = torch.Generator().manual_seed(1)
    d = Dropout(0.5, generator=g).train()
    x = torch.ones(4, 8, dtype=torch.float64, requires_grad=True)
    y = remat.checkpointed(lambda t: d(t) * t, True)(x)
    y.sum().backward()
    keep = y.detach() != 0
    # d/dx (mask * x / (1 - p) * x) = 2 x mask / (1 - p): the mask replayed
    assert torch.equal(x.grad, torch.where(keep, torch.full_like(x, 4.0), torch.zeros_like(x)))
    with pytest.raises(ValueError, match="remat"):
        remat.checkpointed(lambda t: t, "all")
    assert remat.checkpointed(len, False) is len

"""Port parity, the two switches of the training LSTM path:

- `nnet/lobe/rnn.FUSED_PROJ_SCAN` (JAX's `PURESOUND_FUSED_PROJ`): off, every
  `LSTM.scan` hoists the input projection and runs `lstm_scan_train`;
- `nnet/skim.TM_BLOCKS` (JAX's `PURESOUND_TM_BLOCKS`): on, SkiM's offline
  block stack runs time-major through `SegLSTM.call_tm` / `LSTM.call_tm`,
  whose scans take `lstm_scan_train_fp_tm` or `lstm_scan_train_tm`.

Each route is the same function: `LSTM.scan` / `call_tm`, `SegLSTM.call_tm`
and the time-major SkiM against JAX in float64 (atol 1e-8 / rtol 1e-6), the
time-major stack against the batch-major one, and one `make_train_step`
step of a small TSE model under each of the three settings against JAX's
step in float64. JAX's f64 step runs `lax.scan` (its kernels route above
256 rows; they are held at kernel level in
tests/test_torch_lstm_unfused_kernel.py). The tests set the module
attributes, the port's and JAX's `skim.TM_BLOCKS` alike, and restore them."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import puresound_tpu.nnet.skim as j_skim
import puresound_tpu_torch.nnet.lobe.rnn as t_rnn
import puresound_tpu_torch.nnet.skim as t_skim
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.lobe.rnn import LSTM as JLSTM
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDRLoss
from puresound_tpu.parallel.mesh import TrainState as JTrainState
from puresound_tpu.parallel.mesh import make_train_step as j_make_train_step
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.ops import lstm_train_kernel as lk
from puresound_tpu_torch.parallel import TrainState, adam, make_train_step
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
SETTINGS = {"unfused_proj": dict(fused_proj=False, tm=False),
            "tm_blocks": dict(fused_proj=True, tm=True),
            "both": dict(fused_proj=False, tm=True)}


@contextlib.contextmanager
def switches(fused_proj=True, tm=False):
    """The port's two switches and JAX's TM_BLOCKS, restored afterwards."""
    prev = t_rnn.FUSED_PROJ_SCAN, t_skim.TM_BLOCKS, j_skim.TM_BLOCKS
    try:
        t_rnn.FUSED_PROJ_SCAN = fused_proj
        t_skim.TM_BLOCKS = j_skim.TM_BLOCKS = tm
        yield
    finally:
        t_rnn.FUSED_PROJ_SCAN, t_skim.TM_BLOCKS, j_skim.TM_BLOCKS = prev


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


def _perturbed_f64(tree, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a)),
        jax.device_get(tree))


def test_switch_defaults_follow_jax():
    """Read at import by JAX's names and defaults: projection fused, stack
    batch-major."""
    assert t_rnn.FUSED_PROJ_SCAN is True and t_skim.TM_BLOCKS is False


# ---------------------------------------------------------------- the layers
@pytest.mark.parametrize("bidirectional", [False, True])
def test_lstm_scans_match_jax_on_every_route(rng, bidirectional):
    """LSTM forward and call_tm, with the projection fused and hoisted,
    against JAX's __call__ / call_tm in float64, values and gradients of the
    port's routes equal to each other."""
    N, T, Cin, Hd = 5, 9, 6, 7
    jm = JLSTM(Cin, Hd, bidirectional=bidirectional)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((N, T, Cin))), rng)
    x = rng.standard_normal((N, T, Cin))
    D = 2 if bidirectional else 1
    h0, c0 = rng.standard_normal((D, N, Hd)), rng.standard_normal((D, N, Hd))
    with jax.enable_x64(True):
        want_y, (want_h, want_c) = jm.apply(v, jnp.asarray(x), (h0, c0))
        want_t, _ = jm.apply(v, jnp.swapaxes(jnp.asarray(x), 0, 1), (h0, c0),
                             method=JLSTM.call_tm)
    tm = t_rnn.LSTM(Cin, Hd, bidirectional, dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.lstm(v["params"])), strict=True)
    runs = []
    for fused_proj in (True, False):
        for time_major in (False, True):
            with switches(fused_proj=fused_proj):
                xt = torch.tensor(x, requires_grad=True)
                init = (torch.from_numpy(h0), torch.from_numpy(c0))
                if time_major:
                    y, (h, c) = tm.call_tm(xt.transpose(0, 1), init)
                    _close(y.detach().numpy(), want_t)
                    y = y.transpose(0, 1)
                else:
                    y, (h, c) = tm(xt, init)
                    _close(y.detach().numpy(), want_y)
                _close(h.detach().numpy(), want_h)
                _close(c.detach().numpy(), want_c)
                loss = (y * torch.cos(torch.arange(y.numel()).reshape(y.shape))).sum()
                grads = torch.autograd.grad(loss + (h ** 2).sum(),
                                            [xt, *tm.parameters()])
                runs.append(grads)
    for other in runs[1:]:
        for a, b in zip(other, runs[0]):
            _close(a.numpy(), b.numpy(), atol=1e-12, rtol=1e-10)


def test_seg_lstm_call_tm_matches_jax(rng):
    jm = j_skim.SegLSTM(6, 5, causal=True)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((4, 7, 6))), rng)
    x = rng.standard_normal((4, 7, 6))
    h0, c0 = rng.standard_normal((1, 4, 5)), rng.standard_normal((1, 4, 5))
    with jax.enable_x64(True):
        want = jm.apply(v, jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(h0),
                        jnp.asarray(c0), method=j_skim.SegLSTM.call_tm)
    tm = t_skim.SegLSTM(6, 5, dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.seg_lstm(v["params"])), strict=True)
    for fused_proj in (True, False):
        with switches(fused_proj=fused_proj), torch.no_grad():
            got = tm.call_tm(torch.from_numpy(x).transpose(0, 1),
                             torch.from_numpy(h0), torch.from_numpy(c0))
        for g, w in zip(got, want):
            _close(g.numpy(), w)


# ---------------------------------------------------------------- the stack
SKIM_KW = dict(input_size=16, hidden_size=24, output_size=16, n_blocks=3,
               seg_size=8, seg_overlap=False, causal=True, embed_dim=8,
               embed_norm=True, block_with_embed=(1, 0, 1))


@pytest.fixture(params=["FiLM", "Gate"])
def skims(request, rng):
    jm = j_skim.SkiM(**SKIM_KW, embed_fusion=request.param)
    v = _perturbed_f64(jm.init(KEY, jnp.zeros((2, 16, 8)), jnp.ones((2, 8))), rng)
    tm = t_skim.SkiM(**SKIM_KW, embed_fusion=request.param, dtype=torch.float64)
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_skim_time_major_stack_matches_jax(skims, rng, setting):
    """The port's SkiM under each setting against JAX's with its TM_BLOCKS
    set the same way, and against the port's default batch-major stack;
    the gradient of the input too."""
    jm, v, tm = skims
    x, e = rng.standard_normal((2, 16, 27)), rng.standard_normal((2, 8))
    outs = []
    for kw in (SETTINGS[setting], {}):
        with switches(**kw):
            with jax.enable_x64(True):
                want = jm.apply(v, jnp.asarray(x), jnp.asarray(e))
            xt = torch.tensor(x, requires_grad=True)
            got = tm(xt, torch.from_numpy(e))
            _close(got.detach().numpy(), want)
            outs.append((got.detach(), torch.autograd.grad(got.square().sum(), xt)[0]))
    for a, b in zip(*outs):
        _close(a.numpy(), b.numpy(), atol=1e-12, rtol=1e-10)


def test_skim_time_major_routes_launch_the_tm_entries(skims, rng, monkeypatch):
    """Which entry each setting runs: recorded by wrapping the four entries
    the LSTM imports (one SegLSTM scan a block, two MemLSTM scans a memory)."""
    _, _, tm = skims
    calls = []
    for name in ("lstm_scan_train", "lstm_scan_train_tm", "lstm_scan_train_fp",
                 "lstm_scan_train_fp_tm"):
        fn = getattr(t_rnn, name)
        monkeypatch.setattr(t_rnn, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    x, e = torch.from_numpy(rng.standard_normal((2, 16, 20))), torch.from_numpy(
        rng.standard_normal((2, 8)))
    want = {"unfused_proj": {"lstm_scan_train": 3 + 4},
            "tm_blocks": {"lstm_scan_train_fp_tm": 3, "lstm_scan_train_fp": 4},
            "both": {"lstm_scan_train_tm": 3, "lstm_scan_train": 4}}
    for setting, counts in want.items():
        calls.clear()
        with switches(**SETTINGS[setting]), torch.no_grad():
            tm(x, e)
        assert {n: calls.count(n) for n in set(calls)} == counts, setting


# ------------------------------------------------------------ the train step
WIN, HOP, C, E = 32, 16, 24, 8
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
MODEL_SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2,
                  seg_size=10, seg_overlap=False, causal=True, embed_dim=E,
                  embed_norm=True, embed_fusion="FiLM", block_with_embed=(1, 1))
N, L, L_ENROLL = 2, HOP * 25, 800


def _batch(rng):
    return {"noisy": rng.standard_normal((N, L)) * 0.3,
            "enroll": rng.standard_normal((N, L_ENROLL)) * 0.3,
            "ref_clean": rng.standard_normal((N, L)) * 0.3}


@pytest.fixture
def train_pair(rng):
    spk = tuple([JTCN(C, 16, 3, dilation=d, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN") for d in (1, 2)]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    jwrap = JWrap(encoder=JEnc(**ENC), masker=j_skim.SkiM(**MODEL_SKIM), speaker_net=spk,
                  loss_func_wav=JSDRLoss.init_mode("sisnr"), mask_constraint="ReLU")
    v = jwrap.init(KEY, **{k: jnp.asarray(a, jnp.float32) for k, a in _batch(rng).items()},
                   train=False)
    v = _perturbed_f64(v, rng, 0.05)
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    fk = dict(dtype=torch.float64)
    model = SoTaskWrapModule(
        FreeEncDec(**ENC, **fk), t_skim.SkiM(**MODEL_SKIM, **fk),
        [TCN(C, 16, 3, dilation=d, tcn_norm="gLN", dconv_norm="gGN", **fk)
         for d in (1, 2)] + [AttentiveStatisticsPooling(C, 16, **fk),
                             Conv1d(2 * C, E, 1, bias=False, **fk)],
        loss_func_wav=SDRLoss.init_mode("sisnr"), mask_constraint="ReLU")
    model.load_state_dict(fj.from_jax(v), strict=True)
    return jwrap, v, model


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_train_step_matches_jax_under_each_setting(train_pair, rng, setting):
    """One Adam step (grad clip 10): the metrics and every parameter and
    BatchNorm statistic after it, against JAX's step with the same
    TM_BLOCKS. CPU tensors launch no kernel."""
    jwrap, v, model = train_pair
    batch = _batch(rng)
    lk.FWD_BY_ENTRY.clear()
    lk.BWD_BY_ENTRY.clear()
    with switches(**SETTINGS[setting]), jax.enable_x64(True):
        jstate = JTrainState.create(v["params"], v["batch_stats"], optax.adam(1e-3))
        jstate, jm = j_make_train_step(jwrap, grad_clip=10.0, donate=False)(
            jstate, {k: jnp.asarray(a) for k, a in batch.items()}, jax.random.PRNGKey(0))
        state = TrainState.create(model, adam(1e-3))
        state, m = make_train_step(model, grad_clip=10.0)(
            state, {k: torch.from_numpy(a) for k, a in batch.items()})
    assert set(m) == set(jm)
    for k in jm:
        _close(float(m[k]), float(jm[k]), msg=k)
    want = fj.so_wrapper_tse_skim({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        _close(t.numpy(), want[name], msg=name)
    assert lk.FWD_BY_ENTRY == lk.BWD_BY_ENTRY == {}    # CPU: the plain versions only

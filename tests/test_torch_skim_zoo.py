"""The time-domain SkiM models of the TSE zoo in the port: `tse_skim_v0`
(non-causal SkiM), `tse_skim_v1_causal` (a BiLSTM speaker net) and
`tse_skim_v2_causal` (FbankEnc + SpecAugment + TCN speaker net), and the
modules they need, against the JAX package in float64 (atol 1e-8, rtol
1e-6) on inputs from numpy seeds:

- `mel_filterbank`, the MagPhase ConvSTFT and FbankEnc (both formats,
  trainable or not, the inverse);
- `SplitMerge` (the split equal to JAX's, merge(split(x)) == x);
- `SpecAugment.apply` against JAX's `_mask_axis` and its module on the
  uniforms JAX draws from a known key;
- non-causal and overlapped SkiM, values and gradients, with `TM_BLOCKS`
  on and off, and dropout in eval;
- small models of each zoo layout through the wrapper: inference, the SI-SNR
  + AAM-softmax training loss and every gradient (SpecAugment active, its
  draws fixed on both sides), streaming against JAX's engine and offline;
- the full-width zoo models: parameter counts equal to JAX's
  (`jax.eval_shape`), `from_jax` a bijection, a JAX checkpoint read by
  `for_model`;
- the CLI's train / dev on a tiny set with small models patched in;
- remat bit-equal to plain with SpecAugment and dropout active, and the
  ValueErrors of this slice.
"""
import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu.dsp.stft import mel_filterbank as jmel
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import ConvSTFT as JSTFT
from puresound_tpu.nnet.encoder import FbankEnc as JFbank
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe import trivial as jtrivial
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.lobe.rnn import SingleRNN as JSingleRNN
from puresound_tpu.nnet.loss.aamsoftmax import AAMsoftmax as JAAM
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDR
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.dsp.stft import mel_filterbank
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet import skim
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import ConvSTFT, FbankEnc, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.lobe.rnn import SingleRNN
from puresound_tpu_torch.nnet.lobe.trivial import SpecAugment, SplitMerge
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.parallel import TrainState, make_train_step
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.engine import StreamingTSE, offline_equivalent_input
from puresound_tpu_torch.tasks import base
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo import tse as zoo

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
F64 = dict(dtype=torch.float64)
C, H, E, N_CLASS, BANKS = 16, 12, 8, 5, 8
WIN, HOP = 32, 16
CONF = "egs/tse/conf/libri2mix_max_2spk_clean_16k_1a.yaml"


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _random_variables(module, seed, *args, **kw):
    """JAX's variable tree of `module` (shapes from `jax.eval_shape`) with
    float64 leaves from a numpy seed; BatchNorm running variances positive."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(KEY, *args, **kw))

    def leaf(path, s):
        v = 0.3 * rng.standard_normal(s.shape)
        return np.abs(v) + 0.5 if getattr(path[-1], "key", None) == "var" else v
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax64(fn, *args):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(np.asarray, fn(*map(jnp.asarray, args)))


# ------------------------------------------------- mel, MagPhase, FbankEnc
@pytest.mark.parametrize("sr,n_fft,banks", [(16000, 512, 80), (16000, 64, 8), (8000, 256, 40)])
def test_mel_filterbank_equals_jax(sr, n_fft, banks):
    np.testing.assert_array_equal(mel_filterbank(sr, n_fft, banks), jmel(sr, n_fft, banks))
    with pytest.raises(ValueError, match="Empty mel"):
        mel_filterbank(8000, 32, 64)


@pytest.mark.parametrize("trainable", [False, True], ids=["fixed", "trainable"])
def test_conv_stft_magphase_matches_jax(trainable):
    """(magnitude, phase) with JAX's sqrt(p + 1e-8) when trainable and
    arctan2(-imag, real), and the inverse re-polarising them."""
    kw = dict(n_fft=64, hop_length=16, iSTFT=True, trainable=trainable,
              output_format="MagPhase", sr=16000)
    x = 0.3 * np.random.default_rng(1).standard_normal((2, 400))
    jm = JSTFT(**kw)
    v = jm.init(KEY, jnp.zeros((1, 400)))
    want = _jax64(lambda a: jm.apply(v, a), x)
    back = _jax64(lambda a: jm.apply(v, a, method=JSTFT.inverse), want)
    tm = ConvSTFT(**kw, **F64)
    got = tm(_t(x))
    _close(got, want)
    _close(tm.inverse(_t(want)), back)
    assert len(tm.state_dict()) == (2 if trainable else 0)


@pytest.mark.parametrize("fmt", ["Magnitude", "MagPhase"])
@pytest.mark.parametrize("trainable", [False, True], ids=["fixed", "trainable"])
def test_fbank_enc_matches_jax(fmt, trainable):
    """Both formats, the trainable parameters loaded through `from_jax`, and
    the MagPhase inverse; the input's gradient of the trainable mel."""
    kw = dict(fft_length=64, win_length=64, hop_length=16, n_banks=BANKS,
              trainable=trainable, output_format=fmt, iSTFT=True)
    x = 0.3 * np.random.default_rng(2).standard_normal((2, 480))
    jm = JFbank(**kw)
    v = _random_variables(jm, 3, jnp.zeros((1, 480))) if trainable else {}
    want = _jax64(lambda a: jm.apply(v, a), x)
    tm = FbankEnc(**kw, **F64)
    if trainable:
        tm.load_state_dict(fj.to_torch(fj.fbank_enc(v["params"])), strict=True)
    else:
        assert len(tm.state_dict()) == 0
    xt = _t(x).requires_grad_()
    got = tm(xt)
    if fmt == "MagPhase":
        _close(got[0], want[0])
        _close(got[1], want[1])
        back = _jax64(lambda m, p: jm.apply(v, m, p, method=JFbank.inverse), *want)
        _close(tm.inverse(_t(want[0]), _t(want[1])), back)
        return
    _close(got, want)
    with pytest.raises(NotImplementedError, match="MagPhase"):
        tm.inverse(got, got)
    ct = np.random.default_rng(4).standard_normal(want.shape)
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda a: jm.apply(v, a), jnp.asarray(x))
        gx = np.asarray(vjp(jnp.asarray(ct))[0])
    got.backward(_t(ct))
    _close(xt.grad, gx)


# ------------------------------------------------------- SplitMerge
@pytest.mark.parametrize("T,seg", [(37, 10), (40, 10), (23, 6), (5, 20)])
def test_split_merge_round_trips(T, seg):
    x = np.random.default_rng(T).standard_normal((2, 3, T))
    want, rest = _jax64(lambda a: jtrivial.SplitMerge.split(a, seg), x)
    got, got_rest = SplitMerge.split(_t(x), seg)
    assert got_rest == int(rest)
    _close(got, want)
    np.testing.assert_array_equal(SplitMerge.merge(got, got_rest).numpy(), x)
    _close(SplitMerge.merge(got * 2.0, got_rest),
           _jax64(lambda a: jtrivial.SplitMerge.merge(a, int(rest)), np.asarray(want) * 2.0))


# ------------------------------------------------------- SpecAugment
def _jax_draws(key):
    """The uniforms JAX's SpecAugment draws from `key` ([2, 2]: frequency,
    time), as its `__call__` and `_mask_axis` split it."""
    out = []
    for k in jax.random.split(key):
        k1, k2 = jax.random.split(k)
        out.append([float(jax.random.uniform(k1)), float(jax.random.uniform(k2))])
    return np.asarray(out)


@pytest.mark.parametrize("lengths", [(10, 0), (5, 7), (0, 30)])
def test_spec_augment_apply_matches_jax(lengths):
    """`apply` on JAX's uniforms equals `_mask_axis` on the key they came
    from, axis by axis, and the whole JAX module in training (its key read
    with `make_rng`); the identity in eval; the forward's own draws mask at
    most mask_length - 1 rows of an axis."""
    f, t = lengths
    x = np.random.default_rng(5).standard_normal((3, 16, 40)) + 3.0
    jm = jtrivial.SpecAugment(freq_mask_length=f, time_mask_length=t, fill_value=-1.5)
    tm = SpecAugment(f, t, fill_value=-1.5, generator=torch.Generator().manual_seed(0))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        kf, kt = jax.random.split(key)
        want = jnp.asarray(x)
        if f:
            want = jm._mask_axis(kf, want, f, 1)
        if t:
            want = jm._mask_axis(kt, want, t, 2)
        draws = torch.from_numpy(_jax_draws(key)).float()
        np.testing.assert_array_equal(tm.apply(torch.from_numpy(x).float(), draws).numpy(),
                                      np.asarray(want, np.float32))
        rngs = {"dropout": key}
        used = jm.apply({}, rngs=rngs, method=lambda m: m.make_rng("dropout"))
        whole = jm.apply({}, jnp.asarray(x), train=True, rngs=rngs)
        np.testing.assert_array_equal(tm.apply(torch.from_numpy(x).float(),
                                               torch.from_numpy(_jax_draws(used)).float()),
                                      np.asarray(whole, np.float32))
    xt = torch.from_numpy(x)
    assert torch.equal(tm.eval()(xt), xt)
    tm.train()
    for _ in range(5):
        y = tm(xt)
        masked = (y == -1.5)
        if f:
            assert masked.all(2).all(0).sum() <= f
        assert torch.equal(y[~masked], xt[~masked])


# --------------------------------------------------------- the SkiM masker
SKIM = dict(input_size=C, hidden_size=H, output_size=C, n_blocks=2, seg_size=6,
            embed_dim=E, embed_norm=True, embed_fusion="FiLM", block_with_embed=(0, 1))
SKIM_CASES = {"non-causal": (False, False, False), "non-causal TM_BLOCKS": (False, False, True),
              "overlap": (True, True, False), "non-causal overlap": (False, True, False),
              "overlap TM_BLOCKS": (True, True, True)}


@pytest.mark.parametrize("case", list(SKIM_CASES))
def test_skim_matches_jax_values_and_gradients(case, monkeypatch):
    """The bidirectional SegLSTM / MemLSTM (no shift) and the overlapped
    segments, forward and the VJP for the input, the d-vector and every
    parameter; TM_BLOCKS runs non-overlapped stacks time-major and leaves an
    overlapped one batch-major, as JAX's."""
    causal, overlap, tm_blocks = SKIM_CASES[case]
    monkeypatch.setattr(skim, "TM_BLOCKS", tm_blocks)
    cfg = dict(SKIM, causal=causal, seg_overlap=overlap)
    rng = np.random.default_rng(6)
    x, d = rng.standard_normal((2, C, 29)), rng.standard_normal((2, E))
    jm = JSkiM(**cfg)
    v = _random_variables(jm, 7, jnp.zeros((2, C, 29)), jnp.zeros((2, E)))
    ct = rng.standard_normal((2, C, 29))
    with jax.enable_x64(True):
        @jax.jit
        def fwd_vjp(p, a, b, t):
            y, vjp = jax.vjp(lambda p, a, b: jm.apply({"params": p}, a, b), p, a, b)
            return y, vjp(t)
        want, (gp, gx, gd) = fwd_vjp(v["params"], jnp.asarray(x), jnp.asarray(d),
                                     jnp.asarray(ct))
    tm = SkiM(**cfg, **F64)
    tm.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
    xt, dt = _t(x).requires_grad_(), _t(d).requires_grad_()
    got = tm(xt, dt)
    _close(got, want)
    got.backward(_t(ct))
    _close(xt.grad, gx)
    _close(dt.grad, gd)
    want_g = fj.skim(jax.device_get(gp))
    for n, p in tm.named_parameters():
        _close(p.grad, want_g[n], n)
    if not causal:
        assert tm.mem_lstm[0].h_net.weight_ih_l0.shape == (4 * H, 2 * H)
        with pytest.raises(ValueError, match="causal"):
            tm.init_state(2)


def test_skim_dropout_acts_in_training_only():
    """SegLSTM / MemLSTM dropout: in eval the model equals JAX's with
    train=False; in training the masks change the output, drawn on the
    model's generator (two models from one seed agree)."""
    cfg = dict(SKIM, causal=False, dropout=0.3)
    rng = np.random.default_rng(8)
    x, d = rng.standard_normal((2, C, 20)), rng.standard_normal((2, E))
    jm = JSkiM(**cfg)
    v = _random_variables(jm, 9, jnp.zeros((2, C, 20)), jnp.zeros((2, E)))
    want = _jax64(jax.jit(lambda a, b: jm.apply(v, a, b)), x, d)
    models = [SkiM(**cfg, generator=torch.Generator().manual_seed(1), **F64) for _ in range(2)]
    for m in models:
        m.load_state_dict(fj.to_torch(fj.skim(v["params"])), strict=True)
        _close(m.eval()(_t(x), _t(d)), want)
    a, b = (m.train()(_t(x), _t(d)) for m in models)
    assert torch.equal(a, b) and (a - _t(want)).abs().max() > 1e-3
    assert models[0].seg_lstm[0].drop.p == models[0].mem_lstm[0].c_drop.p == 0.3


# ------------------------------------------------ the zoo's layouts, small
def _jax_model(kind, losses=True):
    masker = JSkiM(**SKIM, causal=kind != "v0")
    kw = {}
    if kind == "v1":
        spk = (JSingleRNN(rnn_type="LSTM", input_size=C, hidden_size=H, bidirectional=True),
               JASP(C, 8), JConv(2 * C, E, 1, use_bias=False))
    elif kind == "v2":
        kw["encoder_spk"] = JFbank(fft_length=64, win_length=64, hop_length=16,
                                   n_banks=BANKS, trainable=False, output_format="Magnitude")
        spk = (jtrivial.SpecAugment(freq_mask_length=3, time_mask_length=0),
               JTCN(BANKS, 16, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
               JASP(BANKS, 8), JConv(2 * BANKS, E, 1, use_bias=False))
    else:
        spk = (JTCN(C, 16, 3, dilation=2, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
               JASP(C, 8), JConv(2 * C, E, 1, use_bias=False))
    if losses:
        kw.update(loss_func_wav=JSDR.init_mode("sisnr"), loss_func_spk=JAAM(E, N_CLASS))
    return JWrap(encoder=JEnc(win_length=WIN, hop_length=HOP, laten_length=C,
                              output_active=True),
                 masker=masker, speaker_net=spk, mask_constraint="ReLU", **kw)


def _port_model(kind, losses=True, dtype=torch.float64, device=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    fk = dict(dtype=dtype, device=device, generator=g)
    enc_spk = None
    if kind == "v1":
        spk = [SingleRNN("LSTM", C, H, bidirectional=True, **fk),
               AttentiveStatisticsPooling(C, 8, **fk), Conv1d(2 * C, E, 1, bias=False, **fk)]
    elif kind == "v2":
        enc_spk = FbankEnc(fft_length=64, win_length=64, hop_length=16, n_banks=BANKS,
                           dtype=dtype, device=device)
        spk = [SpecAugment(3, 0, generator=g), TCN(BANKS, 16, 3, 1, **fk),
               AttentiveStatisticsPooling(BANKS, 8, **fk),
               Conv1d(2 * BANKS, E, 1, bias=False, **fk)]
    else:
        spk = [TCN(C, 16, 3, 2, **fk), AttentiveStatisticsPooling(C, 8, **fk),
               Conv1d(2 * C, E, 1, bias=False, **fk)]
    kw = dict(loss_func_wav=SDRLoss.init_mode("sisnr"),
              loss_func_spk=AAMsoftmax(E, N_CLASS, **fk)) if losses else {}
    return SoTaskWrapModule(FreeEncDec(win_length=WIN, hop_length=HOP, laten_length=C,
                                       output_active=True, **fk),
                            SkiM(**SKIM, causal=kind != "v0", **fk), spk,
                            encoder_spk=enc_spk, mask_constraint="ReLU", **kw)


def _batch(seed, n=2, L=640, L_enroll=800):
    rng = np.random.default_rng(seed)
    return {"noisy": 0.3 * rng.standard_normal((n, L)),
            "enroll": 0.3 * rng.standard_normal((n, L_enroll)),
            "ref_clean": 0.3 * rng.standard_normal((n, L)),
            "spk_class": rng.integers(0, N_CLASS, n)}


@functools.lru_cache(maxsize=None)
def _variables(kind):
    b = _batch(0)
    return _random_variables(_jax_model(kind), 20 + len(kind) + ord(kind[-1]),
                             **{k: jnp.asarray(a) for k, a in b.items()}, train=False)


def _inference_vars(v):
    return {"params": {k: a for k, a in v["params"].items() if k != "loss_func_spk"},
            "batch_stats": v.get("batch_stats", {})}


#: SpecAugment's uniforms on both sides of the training comparison
DRAWS = np.array([[0.83, 0.41], [0.0, 0.0]])


def _fixed_mask_axis(self, key, x, mask_len, axis):
    """JAX's `_mask_axis` (puresound_tpu/nnet/lobe/trivial.py:210-220) on
    DRAWS in place of the key's uniforms."""
    u1, u2 = DRAWS[axis - 1]
    size = x.shape[axis]
    value = u1 * mask_len
    start = u2 * (size - value)
    idx = jnp.arange(size, dtype=jnp.float32)
    mask = (idx >= start) & (idx < start + value)
    shape = [1] * x.ndim
    shape[axis] = size
    return jnp.where(mask.reshape(shape), self.fill_value, x)


@pytest.mark.parametrize("kind", ["v0", "v1", "v2"])
def test_zoo_layouts_match_jax_inference_and_gradients(kind, monkeypatch):
    """Small models of each zoo layout: inference, and in training the
    SI-SNR + alpha AAM-softmax loss with every gradient (v2: the mel
    features through SpecAugment, its draws fixed on both sides)."""
    monkeypatch.setattr(jtrivial.SpecAugment, "_mask_axis", _fixed_mask_axis)
    monkeypatch.setattr(SpecAugment, "draw", staticmethod(
        lambda g: torch.from_numpy(DRAWS).to(g.device)))
    jwrap, v = _jax_model(kind), _variables(kind)
    b = _batch(1)
    with jax.enable_x64(True):
        def loss_fn(params):
            return jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                               **{k: jnp.asarray(a) for k, a in b.items()}, train=True,
                               rngs={"dropout": KEY}, mutable=["batch_stats"])[0]
        want, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        inf = _inference_vars(v)
        want_inf = jax.jit(functools.partial(_jax_model(kind, False).apply,
                                             method=JWrap.inference))(
            inf, jnp.asarray(b["noisy"]), jnp.asarray(b["enroll"]))
    model = _port_model(kind)
    model.load_state_dict(fj.from_jax(v), strict=True)
    model.eval()
    with torch.no_grad():
        _close(model.inference(_t(b["noisy"]), _t(b["enroll"])), np.asarray(want_inf))
    model.train()
    loss = model(**{k: torch.from_numpy(np.asarray(a)) if k == "spk_class" else _t(a)
                    for k, a in b.items()})
    loss.backward()
    _close(loss, want)
    want_g = fj.params_by_name(jax.device_get(grads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        _close(g, want_g[name], name)


@pytest.mark.parametrize("kind", ["v1", "v2"])
def test_streaming_with_encoder_spk_matches_jax_and_offline(kind):
    """StreamingTSE embeds through `encoder_spk` (v2) and steps chunk by
    chunk equal to JAX's engine, and the stream equals the offline
    inference of the zero-primed input; the fused step's plain version
    too."""
    inf = _inference_vars(_variables(kind))
    j = _jax_model(kind, losses=False)
    jeng = JEngine(encoder=j.encoder, masker=j.masker, speaker_net=j.speaker_net,
                   encoder_spk=j.encoder_spk, mask_constraint="ReLU")
    model = _port_model(kind, losses=False)
    model.load_state_dict(fj.from_jax(inf), strict=True)
    model.eval()
    engine = StreamingTSE.from_offline(model)
    assert engine.encoder_spk is model.encoder_spk
    rng = np.random.default_rng(30)
    B, S = 2, 3 * HOP
    x, enroll = 0.3 * rng.standard_normal((B, 6 * S)), 0.3 * rng.standard_normal((B, 800))
    with torch.no_grad():
        dvec = engine.embed(_t(enroll))
    with jax.enable_x64(True):
        jdvec = jax.jit(functools.partial(jeng.apply, method=JEngine.embed))(
            inf, jnp.asarray(enroll))
        jstate = jeng.apply(inf, B, jnp.float64, method=JEngine.init_state)
        jstep = jax.jit(functools.partial(jeng.apply, method=JEngine.step))
    _close(dvec, jdvec)
    for fused in (False, True):
        state, outs = engine.init_state(B, torch.float64), []
        for k in range(6):
            chunk = x[:, k * S:(k + 1) * S]
            with torch.no_grad():
                y, state = engine.step(_t(chunk), dvec, state, fused=fused)
            if not fused:
                with jax.enable_x64(True):
                    jy, jstate = jstep(inf, jnp.asarray(chunk), jdvec, jstate)
                _close(y, jy)
            outs.append(y)
        with torch.no_grad():
            offline = model.inference(offline_equivalent_input(_t(x), WIN, HOP), _t(enroll))
        _close(torch.cat(outs, -1), offline[:, :6 * S])


# ------------------------------------------------------- the zoo, full width
ZOO = ("tse_skim_v0", "tse_skim_v1_causal", "tse_skim_v2_causal")


@functools.lru_cache(maxsize=None)
def _zoo_shapes(name):
    """JAX's full-width variable shapes with the 251-class AAM-softmax."""
    m = jzoo.init_model(name, sig_loss=JSDR.init_mode("sisnr"), cls_loss=JAAM(192, 251))
    args = dict(noisy=jnp.zeros((1, 800)), enroll=jnp.zeros((1, 800)),
                ref_clean=jnp.zeros((1, 800)), spk_class=jnp.zeros((1,), jnp.int32))
    return jax.eval_shape(lambda: m.init(KEY, **args, train=False))


def _hp_losses():
    return zoo.init_loss({"LOSS": {"sig_loss": "sisnr", "cls_loss": "aamsoftmax",
                                   "embed_dim": 192, "n_class": 251, "margin": 0.2,
                                   "scale": 30}, "TRAIN": {}}, device="cpu")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_models_match_jax_count_and_load_its_variables(name):
    """Built on the CPU in eval mode: the parameter count equal to JAX's,
    with and without the AAM-softmax weight, and a random JAX tree loads
    strictly; `from_jax` maps every leaf once."""
    shapes = _zoo_shapes(name)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = zoo.init_model(name, *_hp_losses(), device="cpu")
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert n_jax - 251 * 192 == {"tse_skim_v0": 15_575_568, "tse_skim_v1_causal": 6_249_217,
                                 "tse_skim_v2_causal": 6_221_552}[name]
    rng = np.random.default_rng(40)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    sd = fj.from_jax(v)
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(jax.tree_util.tree_leaves(v))
    flat = lambda t: np.sort(np.concatenate([np.ravel(a) for a in t]))
    np.testing.assert_array_equal(flat(sd.values()), flat(jax.tree_util.tree_leaves(v)))


@pytest.mark.parametrize("name", ZOO)
def test_jax_checkpoint_reads_into_the_eval_model(name, tmp_path):
    """A JAX checkpoint of a training state (the AAM-softmax weight in it)
    read by `checkpoint_state` and `for_model` into the zoo model built
    without losses, bit for bit."""
    shapes = _zoo_shapes(name)
    rng = np.random.default_rng(41)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    path = tmp_path / "epoch_0.ckpt"
    path.write_bytes(fser.to_bytes({"params": v["params"],
                                    "batch_stats": v.get("batch_stats", {}), "epoch": 0}))
    model = zoo.init_model(name, device="cpu")
    model.load_state_dict(fj.for_model(base.checkpoint_state(str(path)), model), strict=True)
    want = fj.flat_from_jax(v)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_zoo_names_and_the_mixture_encoder_rule(monkeypatch):
    """JAX_ONLY is empty now that the three UnetTcn names are ported
    (tests/test_torch_unet_tcn.py); each new name builds on the card by
    default (raising without one); FbankEnc refuses to be the mixture
    encoder."""
    assert zoo.JAX_ONLY == ()
    assert set(zoo.UNET_TCN) == {"tse_unet_tcn_v0", "tse_unet_tcn_v0_causal",
                                 "tse_unet_tcn_v1"} and set(zoo.UNET_TCN) <= set(zoo.PORTED)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ZOO + ("veve_dprnn_v0_causal",):
        assert name in zoo.PORTED
        with pytest.raises(RuntimeError, match="device='cpu'"):
            zoo.init_model(name)
    with pytest.raises(ValueError, match="encoder_spk"):
        SoTaskWrapModule(FbankEnc(), SkiM(**SKIM))
    v2 = zoo.init_model("tse_skim_v2_causal", device="cpu")
    assert isinstance(v2.encoder_spk, FbankEnc) and isinstance(v2.speaker_net[0], SpecAugment)


def test_non_causal_skim_refuses_to_stream():
    model = _port_model("v0", losses=False)
    engine = StreamingTSE.from_offline(model)
    with pytest.raises(ValueError, match="causal SkiM"):
        engine.init_state(1, torch.float64)
    state = _port_model("v1", losses=False).masker.init_state(1, torch.float64)
    with pytest.raises(ValueError, match="causal SkiM"):
        model.masker.step_frames_fused(torch.zeros(1, 3, C, dtype=torch.float64), None, state)


# ------------------------------------------------------------- remat
def _remat_run(mode):
    model = _port_model("v2", dtype=torch.float64, seed=3)
    model.masker.seg_lstm[0].drop.p = 0.2
    model.speaker_net[0].freq_mask_length = BANKS
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = make_train_step(model, loss_kwargs=dict(alpha=10.0, return_loss_detail=True),
                           grad_clip=5.0, remat=mode)
    out = []
    for seed in (4, 5):
        b = _batch(seed)
        batch = {k: torch.from_numpy(np.asarray(a)) if k == "spk_class" else _t(a)
                 for k, a in b.items()}
        state, m = step(state, batch)
        out.append((m["loss"].clone(), [p.grad.clone() for p in model.parameters()]))
    return out, [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("mode", [True, "dots"])
def test_remat_with_spec_augment_is_bit_equal_to_plain(mode, monkeypatch):
    """Remat recomputes `encoder_spk` and the speaker net's layers (SpecAugment
    replaying its recorded draw) and the masker's blocks (dropout 0.2 in a
    SegLSTM): two Adam steps equal plain bit for bit; SpecAugment masked
    rows in both."""
    from puresound_tpu_torch.parallel import remat

    names = [type(m).__name__ for m in remat.blocks(_port_model("v2"))]
    assert names[:3] == ["FreeEncDec", "FbankEnc", "SpecAugment"]
    seen = []
    real = SpecAugment.apply
    monkeypatch.setattr(SpecAugment, "apply",
                        lambda self, x, d: seen.append(d.clone()) or real(self, x, d))
    plain = _remat_run(False)
    assert seen and any(d[0, 0] * BANKS >= 1 for d in seen)
    (sa, pa), (sb, pb) = _remat_run(mode), plain
    for (la, ga), (lb, gb) in zip(sa, sb):
        assert torch.equal(la, lb) and all(map(torch.equal, ga, gb))
    assert all(map(torch.equal, pa, pb))


# ------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def tse_set(tmp_path_factory):
    return chip_smoke.write_tse_manifest(str(tmp_path_factory.mktemp("tse_set")), 3, 5)


@pytest.mark.parametrize("kind", ["v0", "v2"])
def test_cli_trains_and_scores_dev(kind, tmp_path, tse_set, monkeypatch, capsys):
    """The shipped 1a config (MODEL.type swapped) through `--action train`
    and `--action dev` with a small model of the layout patched in: finite
    losses, epoch_0.ckpt reloads equal, dev prints a finite row a mixture."""
    name = {"v0": "tse_skim_v0", "v2": "tse_skim_v2_causal"}[kind]
    monkeypatch.setattr(cli, "init_model", lambda n, *losses, **kw: _port_model(
        kind, losses=bool(losses), dtype=torch.float32))
    hp = load_hparam(CONF)
    hp["MODEL"]["type"] = name
    hp["LOSS"].update(embed_dim=E, n_class=N_CLASS)
    hp["DATASET"].update(train=tse_set, dev=tse_set, eval=tse_set, max_length=0.25)
    hp["TRAIN"].update(model_save_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                       num_epochs=1, num_workers=0, batch_size=3, seed=1,
                       use_tensorboard=False)
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    task = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert type(task.model.loss_func_spk).__name__ == "AAMsoftmax"
    tree = torch.load(tmp_path / "m" / "epoch_0.ckpt", weights_only=True)
    for n, t in task.model.state_dict().items():
        assert torch.isfinite(t).all() and torch.equal(t, {**tree["params"],
                                                           **tree["batch_stats"]}[n]), n
    capsys.readouterr()
    means = cli.main(cli.parse_args([str(cfg), "--action", "dev", "--ckpt", "epoch_0.ckpt",
                                     "--backend", "cpu"]))
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("mix_")]
    assert len(rows) == 3 and np.isfinite(list(means.values())).all()

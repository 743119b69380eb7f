"""Port parity, lobe level: each puresound_tpu_torch primitive against its
JAX counterpart on the same float64 inputs and weights (numpy from a seed,
weights carried over by utils.from_jax). Bar: atol 1e-8, rtol 1e-6."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.dsp.stft import overlap_add as j_overlap_add
from puresound_tpu.nnet import conv_tasnet as j_tasnet
from puresound_tpu.nnet import encoder as j_enc
from puresound_tpu.nnet.lobe import activation as j_act
from puresound_tpu.nnet.lobe import cnn as j_cnn
from puresound_tpu.nnet.lobe import norm as j_norm
from puresound_tpu.nnet.lobe import pooling as j_pool
from puresound_tpu.nnet.lobe import rnn as j_rnn
from puresound_tpu.nnet.lobe import trivial as j_triv
from puresound_tpu_torch.dsp.stft import overlap_add
from puresound_tpu_torch.nnet import conv_tasnet as t_tasnet
from puresound_tpu_torch.nnet import encoder as t_enc
from puresound_tpu_torch.nnet.lobe import activation as t_act
from puresound_tpu_torch.nnet.lobe import cnn as t_cnn
from puresound_tpu_torch.nnet.lobe import norm as t_norm
from puresound_tpu_torch.nnet.lobe import pooling as t_pool
from puresound_tpu_torch.nnet.lobe import rnn as t_rnn
from puresound_tpu_torch.nnet.lobe import trivial as t_triv
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
F64 = dict(dtype=torch.float64)
ATOL, RTOL = 1e-8, 1e-6


def _randomize(tree, rng):
    """Random float64 leaves (positive for BatchNorm running variances)."""
    def leaf(path, a):
        v = rng.standard_normal(a.shape) * 0.5
        if getattr(path[-1], "key", None) == "var":
            v = np.abs(v) + 0.5
        return v
    return jax.tree_util.tree_map_with_path(leaf, jax.tree_util.tree_map(
        np.asarray, jax.device_get(tree)))


def _jax_run(module, args, rng, method=None, **kw):
    """init -> random f64 variables -> apply, all under x64."""
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        # PReLU's `init` field shadows Module.init
        v = _randomize(fnn.Module.init(module, KEY, *jargs, method=method,
                                       **kw), rng)
        out = module.apply(v, *jargs, method=method, **kw)
    return v, jax.tree_util.tree_map(np.asarray, out)


def _load(module, flat):
    module.load_state_dict(fj.to_torch(flat), strict=True)
    return module.eval()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def case_glob_ln(rng):
    x = rng.standard_normal((2, 6, 9))
    v, want = _jax_run(j_norm.GlobLN(6), [x], rng)
    got = _load(t_norm.GlobLN(6, **F64), fj.norm(v["params"], kind="gLN"))(_t(x))
    return got, want


def case_group_norm1(rng):
    x = rng.standard_normal((2, 6, 9))
    v, want = _jax_run(j_norm.GroupNorm1(6), [x], rng)
    got = _load(t_norm.GroupNorm1(6, **F64), fj.norm(v["params"], kind="gGN"))(_t(x))
    return got, want


def case_batch_norm_eval(rng):
    x = rng.standard_normal((2, 6, 9))
    v, want = _jax_run(j_norm.BatchNorm(6), [x], rng)
    got = _load(t_norm.BatchNorm(6, **F64),
                fj.norm(v["params"], v["batch_stats"]))(_t(x))
    return got, want


def case_layer_norm_last(rng):
    x = rng.standard_normal((2, 9, 6)) * 3 + 1
    v, want = _jax_run(j_norm.LayerNormLast(6), [x], rng)
    got = _load(t_norm.LayerNormLast(6, **F64), fj.layer_norm_last(v["params"]))(_t(x))
    return got, want


def case_prelu(rng):
    x = rng.standard_normal((2, 5, 7))
    v, want = _jax_run(j_act.PReLU(), [x], rng)
    got = _load(t_act.PReLU(**F64), fj.prelu(v["params"]))(_t(x))
    return got, want


def case_conv1d(rng):
    x = rng.standard_normal((2, 6, 20))
    kw = dict(kernel=3, stride=2, dilation=2, padding=2, groups=2)
    v, want = _jax_run(j_cnn.Conv1d(6, 4, **kw), [x], rng)
    got = _load(t_cnn.Conv1d(6, 4, **kw, **F64), fj.conv1d(v["params"]))(_t(x))
    return got, want


def case_conv1d_dense_last(rng):
    x = rng.standard_normal((2, 7, 6))
    v, want = _jax_run(j_cnn.Conv1d(6, 4), [x], rng,
                       method=j_cnn.Conv1d.dense_last)
    got = _load(t_cnn.Conv1d(6, 4, **F64), fj.conv1d(v["params"])).dense_last(_t(x))
    return got, want


def _dsconv_case(dilation):
    def case(rng):
        x = rng.standard_normal((2, 6, 25))
        kw = dict(kernel=3, dilation=dilation, norm_cls="gGN")
        v, want = _jax_run(j_cnn.DepthwiseSeparableConv1d(6, 5, **kw), [x], rng)
        got = _load(t_cnn.DepthwiseSeparableConv1d(6, 5, **kw, **F64),
                    fj.dsconv(v["params"], None, "gGN"))(_t(x))
        return got, want
    return case


def case_overlap_add(rng):
    frames = rng.standard_normal((2, 7, 32))
    with jax.enable_x64(True):
        want = np.asarray(j_overlap_add(jnp.asarray(frames), 16))
    return overlap_add(_t(frames), 16), want


def case_overlap_add_ragged_hop(rng):
    frames = rng.standard_normal((2, 7, 30))
    with jax.enable_x64(True):
        want = np.asarray(j_overlap_add(jnp.asarray(frames), 7))
    return overlap_add(_t(frames), 7), want


def _free_encdec(rng, inverse):
    x = rng.standard_normal((2, 160))
    jm = j_enc.FreeEncDec(win_length=32, hop_length=16, laten_length=12,
                          output_active=True)
    v, feats = _jax_run(jm, [x], rng)
    tm = _load(t_enc.FreeEncDec(win_length=32, hop_length=16, laten_length=12,
                                output_active=True, **F64),
               fj.free_encdec(v["params"]))
    if not inverse:
        return tm(_t(x)), feats
    with jax.enable_x64(True):
        want = np.asarray(jm.apply(v, jnp.asarray(feats),
                                   method=j_enc.FreeEncDec.inverse))
    return tm.inverse(_t(feats)), want


def case_free_encdec_forward(rng):
    return _free_encdec(rng, inverse=False)


def case_free_encdec_inverse(rng):
    return _free_encdec(rng, inverse=True)


def _lstm(rng):
    B, T, C, H = 3, 11, 5, 7
    x = rng.standard_normal((B, T, C))
    init = (rng.standard_normal((1, B, H)), rng.standard_normal((1, B, H)))
    with jax.enable_x64(True):
        jm = j_rnn.LSTM(C, H)
        v = _randomize(jm.init(KEY, jnp.asarray(x)), rng)
    tm = _load(t_rnn.LSTM(C, H, **F64), fj.lstm(v["params"]))
    return x, init, jm, v, tm


def case_lstm_scan(rng):
    x, init, jm, v, tm = _lstm(rng)
    with jax.enable_x64(True):
        y, (h, c) = jm.apply(v, jnp.asarray(x), tuple(map(jnp.asarray, init)))
    ty, (th, tc) = tm(_t(x), tuple(map(_t, init)))
    return torch.cat([ty.flatten(), th.flatten(), tc.flatten()]), \
        np.concatenate([np.ravel(y), np.ravel(h), np.ravel(c)])


def case_lstm_step(rng):
    x, init, jm, v, tm = _lstm(rng)
    with jax.enable_x64(True):
        y, (h, c) = jm.apply(v, jnp.asarray(x[:, 0]),
                             *map(jnp.asarray, init), method=j_rnn.LSTM.step)
    ty, (th, tc) = tm.step(_t(x[:, 0]), *map(_t, init))
    return torch.cat([ty.flatten(), tc.flatten()]), \
        np.concatenate([np.ravel(y), np.ravel(c)])


def _film_case(feature_last):
    def case(rng):
        x = (rng.standard_normal((2, 9, 6)) if feature_last
             else rng.standard_normal((2, 6, 9)))
        e = rng.standard_normal((2, 4))
        v, want = _jax_run(j_triv.FiLM(6, 4), [x, e], rng,
                           feature_last=feature_last)
        tm = _load(t_triv.FiLM(6, 4, **F64), fj.film(v["params"]))
        return tm(_t(x), _t(e), feature_last=feature_last), want
    return case


def _tcn_case(norms):
    def case(rng):
        x = rng.standard_normal((2, 6, 21))
        kw = dict(kernel=3, dilation=2, tcn_norm=norms[0], dconv_norm=norms[1])
        v, want = _jax_run(j_tasnet.TCN(6, 5, **kw), [x], rng)
        tm = _load(t_tasnet.TCN(6, 5, **kw, **F64),
                   fj.tcn(v["params"], v.get("batch_stats"), *norms))
        return tm(_t(x)), want
    return case


def case_attentive_statistics_pooling(rng):
    x = rng.standard_normal((2, 6, 13))
    v, want = _jax_run(j_pool.AttentiveStatisticsPooling(6, 5), [x], rng)
    tm = _load(t_pool.AttentiveStatisticsPooling(6, 5, **F64),
               fj.asp(v["params"], v["batch_stats"]))
    return tm(_t(x)), want


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
CASES.update({f"dsconv_dilation{d}": _dsconv_case(d) for d in (1, 2, 4)})
CASES.update({"tcn_gln_ggn": _tcn_case(("gLN", "gGN")),
              "tcn_batchnorm": _tcn_case(("bN1d", "bN1d"))})
CASES.update({"film_feature_last": _film_case(True),
              "film_channel_first": _film_case(False)})


@pytest.mark.parametrize("name", sorted(CASES))
def test_lobe_matches_jax_f64(name, rng):
    got, want = CASES[name](rng)
    got = got.detach().numpy()
    assert got.shape == np.shape(want)
    _close(got, want)


def _train_apply(module, v, x, **kw):
    """JAX training apply: (output, updated batch_stats)."""
    out, upd = module.apply(v, x, train=True, mutable=["batch_stats"], **kw)
    return out, upd["batch_stats"]


@pytest.mark.parametrize("shape", [(3, 6, 9), (2, 6, 4, 5)])
def test_batch_norm_training_matches_jax(rng, shape):
    """Batch statistics (single-pass variance) normalise; the running stats
    move by momentum 0.1 toward the mean and the unbiased variance."""
    x = rng.standard_normal(shape) * 2 + 0.5
    jm = j_norm.BatchNorm(6)
    with jax.enable_x64(True):
        v = _randomize(jm.init(KEY, jnp.asarray(x)), rng)
        want, stats = _train_apply(jm, v, jnp.asarray(x))
    tm = _load(t_norm.BatchNorm(6, **F64),
               fj.norm(v["params"], v["batch_stats"])).train()
    _close(tm(_t(x)).detach().numpy(), want)
    _close(tm.running_mean.numpy(), stats["mean"])
    _close(tm.running_var.numpy(), stats["var"])


def test_batch_norm_training_bf16_cast_stats(rng):
    """Under mixed precision the step hands BatchNorm bfloat16 casts of its
    parameters and running stats: the statistics are taken in float32, the
    old stats are scaled in bfloat16, and the new stats come out float32
    (JAX's weak-typed momentum arithmetic). The stats agree to float32
    rounding, the bf16 output to one bf16 ulp at |y| < 2 (measured: equal)."""
    x = (rng.standard_normal((4, 6, 11)) * 2 + 0.5).astype(np.float32)
    jm = j_norm.BatchNorm(6)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               _randomize(jm.init(KEY, jnp.asarray(x)), rng))
    bf = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    want, stats = _train_apply(jm, bf(v), jnp.asarray(x, jnp.bfloat16))
    tm = _load(t_norm.BatchNorm(6), fj.norm(v["params"], v["batch_stats"])).train()
    tensors = {n: t.to(torch.bfloat16) for n, t in tm.state_dict().items()}
    got = torch.func.functional_call(tm, tensors, (_t(x).to(torch.bfloat16),))
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert tensors[name].dtype == torch.float32
        assert stats[key].dtype == jnp.float32
        np.testing.assert_allclose(tensors[name].numpy(), stats[key],
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=7.8125e-3)


def test_attentive_statistics_pooling_training_matches_jax(rng):
    x = rng.standard_normal((3, 6, 13))
    jm = j_pool.AttentiveStatisticsPooling(6, 5)
    with jax.enable_x64(True):
        v = _randomize(jm.init(KEY, jnp.asarray(x)), rng)
        want, stats = _train_apply(jm, v, jnp.asarray(x))
    tm = _load(t_pool.AttentiveStatisticsPooling(6, 5, **F64),
               fj.asp(v["params"], v["batch_stats"])).train()
    _close(tm(_t(x)).detach().numpy(), want)
    _close(tm.tdnn[2].running_mean.numpy(), stats["tdnn_bn"]["mean"])
    _close(tm.tdnn[2].running_var.numpy(), stats["tdnn_bn"]["var"])


def test_factories_take_device_dtype_generator():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = t_cnn.Conv1d(4, 3, 3, dtype=torch.float64, generator=g1)
    b = t_cnn.Conv1d(4, 3, 3, dtype=torch.float64, generator=g2)
    assert a.weight.dtype == torch.float64 and a.weight.device.type == "cpu"
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)

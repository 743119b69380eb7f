"""Port parity, the last lobe layers: `InstantLN` (iLN), `Magnitude`,
`MovingAverage1D`, the GRU / Elman `SingleRNN`, `FSMN` / `ConditionFSMN`
offline (with the memory handed in, BatchNorm in training) and streamed by
`step_chunk`, and the DSConv's 1x1-in and skip, against the JAX package in
float64 (atol 1e-8, rtol 1e-6) on inputs from numpy seeds, at small widths.
JAX's variables come from `jax.eval_shape` with leaves drawn by numpy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.lobe import cnn as jcnn
from puresound_tpu.nnet.lobe import norm as jnorm
from puresound_tpu.nnet.lobe import rnn as jrnn
from puresound_tpu.nnet.lobe import trivial as jtriv
from puresound_tpu_torch.nnet.lobe import cnn, norm, rnn, trivial
from puresound_tpu_torch.utils import from_jax as fj

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
F64 = dict(dtype=torch.float64)


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
    """`fn` jitted (eager JAX dispatches, and compiles, every op on its own)
    on float64 arrays."""
    with jax.enable_x64(True):
        args = jax.tree_util.tree_map(jnp.asarray, args)
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


# --------------------------------------------------------- iLN, Magnitude
def test_instant_ln_matches_jax_and_is_registered():
    rng = np.random.default_rng(1)
    x = 2.0 * rng.standard_normal((2, 3, 5, 7)) + 0.5
    jm = jnorm.InstantLN(15)
    v = _random_variables(jm, 1, jnp.zeros((1, 3, 5, 2)))
    want = _jax64(lambda a: jm.apply(v, a), x)
    tm = norm.get_norm("iLN")(15, **F64)
    assert isinstance(tm, norm.InstantLN)
    tm.load_state_dict(fj.to_torch(fj.norm(v["params"])), strict=True)
    _close(tm(_t(x)), want)


@pytest.mark.parametrize("shape,drop_first,log1p", [
    ((2, 10, 6), True, False), ((2, 10, 6), False, False),
    ((2, 5, 6, 2), True, True), ((2, 5, 6, 2), False, True)],
    ids=["RI drop", "RI keep", "complex drop log1p", "complex keep log1p"])
def test_magnitude_matches_jax(shape, drop_first, log1p):
    x = np.random.default_rng(len(shape) + drop_first).standard_normal(shape)
    jm = jtriv.Magnitude(drop_first=drop_first, log1p=log1p)
    want = _jax64(lambda a: jm.apply({}, a), x)
    _close(trivial.Magnitude(drop_first, log1p)(_t(x)), want)


def test_magnitude_refuses_other_ranks():
    with pytest.raises(TypeError, match="3-D or 4-D"):
        trivial.Magnitude()(torch.zeros(2, 3))


@pytest.mark.parametrize("kernel,stride,pad,causal", [
    (5, 1, True, True), (5, 2, True, False), (4, 3, False, True)],
    ids=["causal pad", "centred stride 2", "no pad stride 3"])
def test_moving_average_matches_jax(kernel, stride, pad, causal):
    x = np.random.default_rng(kernel + stride).standard_normal((3, 41))
    jm = jtriv.MovingAverage1D(kernel, stride, add_padding=pad, causal=causal)
    want = _jax64(lambda a: jm.apply({}, a), x)
    got = trivial.MovingAverage1D(kernel, stride, add_padding=pad, causal=causal)(_t(x))
    assert got.shape == want.shape
    _close(got, want)


# --------------------------------------------------------- GRU / RNN
@pytest.mark.parametrize("rnn_type,bidirectional", [
    ("GRU", False), ("GRU", True), ("RNN", False), ("RNN", True)],
    ids=["GRU", "BiGRU", "RNN", "BiRNN"])
def test_single_rnn_gru_and_rnn_match_jax(rnn_type, bidirectional):
    """SingleRNN(rnn_type) outputs and every gradient (torch's gate order,
    the n gate's r * (W_hn h + b_hn))."""
    rng = np.random.default_rng(7 + bidirectional)
    x = rng.standard_normal((2, 6, 9))
    jm = jrnn.SingleRNN(rnn_type, 6, 5, bidirectional=bidirectional)
    v = _random_variables(jm, 3, jnp.zeros((1, 6, 4)))

    def value_grad_out(p, a):
        want, grads = jax.value_and_grad(
            lambda q: jnp.sum(jnp.sin(jm.apply({"params": q}, a))))(p)
        return want, grads, jm.apply({"params": p}, a)
    want, grads, out = _jax64(value_grad_out, v["params"], x)
    tm = rnn.SingleRNN(rnn_type, 6, 5, bidirectional=bidirectional, **F64)
    sd = fj.to_torch(fj.single_rnn(v["params"]))
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd, strict=True)
    y = tm(_t(x))
    _close(y, out)
    loss = torch.sin(y).sum()
    loss.backward()
    _close(loss, want)
    want_g = fj.single_rnn(jax.device_get(grads))
    for name, p in tm.named_parameters():
        _close(p.grad, want_g[name], name)


def test_single_rnn_step_is_lstm_only():
    with pytest.raises(ValueError, match="LSTM"):
        rnn.SingleRNN("GRU", 4, 3).step(torch.zeros(1, 4), None, None)
    with pytest.raises(ValueError, match="unsupported"):
        rnn.SingleRNN("SRU", 4, 3)


# --------------------------------------------------------------- FSMN
FSMN_KINDS = {"fsmn": (jrnn.FSMN, rnn.FSMN, {}),
              "concat": (jrnn.ConditionFSMN, rnn.ConditionFSMN, dict(embed_dim=4)),
              "film": (jrnn.ConditionFSMN, rnn.ConditionFSMN,
                       dict(embed_dim=4, use_film=True))}


@functools.lru_cache(maxsize=None)
def _fsmn_pair(kind, r_context, norm_type="bN1d"):
    jcls, tcls, kw = FSMN_KINDS[kind]
    jm = jcls(8, 7, 6, 3, r_context, norm_type=norm_type, **kw)
    args = (jnp.zeros((1, 8, 5)),) + ((jnp.zeros((1, 4)),) if kw else ())
    v = _random_variables(jm, 11 + len(kind) + r_context, *args)
    tm = tcls(8, 7, 6, 3, r_context, norm_type=norm_type, **kw, **F64)
    tm.load_state_dict(fj.to_torch(fj.fsmn(v["params"], v.get("batch_stats"))),
                       strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("kind", list(FSMN_KINDS))
def test_fsmn_offline_matches_jax_in_training(kind):
    """A layer with right context and the memory handed in, BatchNorm in
    training: the output, the memory out and the running statistics."""
    jm, v, tm = _fsmn_pair(kind, 2)
    rng = np.random.default_rng(20 + len(kind))
    x, mem, e = (rng.standard_normal((2, 8, 13)), rng.standard_normal((2, 6, 13)),
                 rng.standard_normal((2, 4)))
    emb = kind != "fsmn"
    jargs = (x,) + ((e,) if emb else ()) + (mem,)
    (want, want_mem), upd = _jax64(
        lambda *a: jm.apply(v, *a, train=True, mutable=["batch_stats"]), *jargs)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train()
    try:
        targs = (_t(x),) + ((_t(e),) if emb else ()) + (_t(mem),)
        out, memory = tm(*targs)
        _close(out, want)
        _close(memory, want_mem)
        stats = fj.fsmn(v["params"], upd["batch_stats"])
        for name in ("out_norm.running_mean", "out_norm.running_var"):
            _close(tm.state_dict()[name], stats[name], name)
    finally:
        tm.load_state_dict(before)
        tm.eval()


@pytest.mark.parametrize("kind", list(FSMN_KINDS))
def test_fsmn_step_chunk_matches_jax_and_offline(kind):
    """A causal layer (r_context 0) streamed in chunks of 1, 4 and 6 frames
    with the ring carried, each chunk against JAX's step_chunk, the whole
    against the offline layer."""
    jm, v, tm = _fsmn_pair(kind, 0)
    rng = np.random.default_rng(30 + len(kind))
    x, mem, e = (rng.standard_normal((2, 8, 11)), rng.standard_normal((2, 6, 11)),
                 rng.standard_normal((2, 4)))
    emb = kind != "fsmn"
    with torch.no_grad():
        off, off_mem = tm(*((_t(x),) + ((_t(e),) if emb else ()) + (_t(mem),)))
        ring = tm.init_ctx(2, torch.float64)
    jring, outs, mems = np.zeros((2, 6, 3)), [], []
    step = type(jm).step_chunk
    for a, b in ((0, 1), (1, 5), (5, 11)):
        with torch.no_grad():
            y, m, ring = tm.step_chunk(_t(x[..., a:b]), _t(mem[..., a:b]), ring,
                                       embed=_t(e) if emb else None)
        jy, jm_, jring = _jax64(lambda c, k, r, d: jm.apply(
            v, c, k, r, embed=d if emb else None, method=step),
            x[..., a:b], mem[..., a:b], jring, e)
        _close(y, jy)
        _close(m, jm_)
        _close(ring, jring)
        outs.append(y)
        mems.append(m)
    _close(torch.cat(outs, -1), off)
    _close(torch.cat(mems, -1), off_mem)


def test_fsmn_streaming_needs_causal_layers():
    with pytest.raises(ValueError, match="r_context 0"):
        rnn.FSMN(8, 8, 6, 3, 1).init_ctx(1)
    with pytest.raises(ValueError, match="dilation 1"):
        rnn.FSMN(8, 8, 6, 3, 0, dilation=2).init_ctx(1)


# ------------------------------------------------- DSConv 1x1-in and skip
@pytest.mark.parametrize("causal", [False, True], ids=["gGN", "causal bN1d"])
def test_dsconv_in_conv_and_skip_match_jax(causal):
    """The DSConv with its 1x1-in (hid_channels) and skip: offline, and the
    causal one streamed by step_chunk against JAX's and offline."""
    rng = np.random.default_rng(40 + causal)
    nrm = "bN1d" if causal else "gGN"
    jm = jcnn.DepthwiseSeparableConv1d(6, 5, hid_channels=7, norm_cls=nrm, kernel=3,
                                       dilation=2, skip=True, causal=causal)
    v = _random_variables(jm, 41 + causal, jnp.zeros((1, 6, 8)))
    x = rng.standard_normal((2, 6, 15))
    want = _jax64(lambda a: jm.apply(v, a), x)
    tm = cnn.DepthwiseSeparableConv1d(6, 5, norm_cls=nrm, kernel=3, dilation=2,
                                      causal=causal, hid_channels=7, skip=True, **F64)
    sd = fj.to_torch(fj.dsconv(v["params"], v.get("batch_stats"), nrm))
    assert {"in_conv.0.weight", "skip_conv.weight"} <= set(sd)
    tm.load_state_dict(sd, strict=True)
    tm.eval()
    _close(tm(_t(x)), want)
    if not causal:
        return
    ctx, jctx, outs = torch.zeros(2, 7, 4, dtype=torch.float64), np.zeros((2, 7, 4)), []
    for a, b in ((0, 2), (2, 15)):
        with torch.no_grad():
            y, ctx = tm.step_chunk(_t(x[..., a:b]), ctx)
        jy, jctx = _jax64(lambda c, k: jm.apply(
            v, c, k, method=jcnn.DepthwiseSeparableConv1d.step_chunk), x[..., a:b], jctx)
        _close(y, jy)
        _close(ctx, jctx)
        outs.append(y)
    _close(torch.cat(outs, -1), want)

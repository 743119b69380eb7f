"""Port parity, the NS serving slice: a small ns_dpcrn-style model (ConvEncDec
n_fft 128 / hop 32 + DPCRN channels (1, 8, 8, 16, 16, 32), hidden 16)
against the JAX package in float64 (atol 1e-8, rtol 1e-6) module by module
and as a whole (offline inference, StreamingNS chunk by chunk, stock and
transpose_delay), the weights crossing over through from_jax (strict);
make_session_server + SessionServer for NS on the CPU (stock, fused,
dp_kernel and mk_kernel); the zoo's device rule and parameter count; the
engine flags' checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.base_nn import apply_tf_masks as j_apply_tf_masks
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.streaming.ns_engine import StreamingNS as JStreamingNS
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule, apply_tf_masks
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.file_eval import (build_engine,
                                                     engine_delay_samples,
                                                     engine_step_options)
from puresound_tpu_torch.streaming.ns_engine import StreamingNS
from puresound_tpu_torch.utils.from_jax import from_jax
from puresound_tpu_torch.zoo.ns import init_model

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
N_FFT, HOP = 128, 32
UNET = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2,
            kernel_t=(2, 2, 2, 2, 2), stride_t=(1, 1, 1, 1, 1),
            dilation_t=(1, 1, 1, 1, 1), kernel_f=(5, 3, 3, 3, 3),
            stride_f=(2, 2, 1, 1, 1), dilation_f=(1, 1, 1, 1, 1),
            delay=(0, 0, 0, 0, 0), rnn_hidden=16)
ENC = dict(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
           output_format="Complex")
WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
            mask_type="Complex")


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_wrap(transpose_delay=False):
    return JWrap(encoder=JEncDec(**ENC),
                 masker=JDPCRN(transpose_delay=transpose_delay, **UNET), **WRAP)


def _port_wrap(dtype=torch.float64, transpose_delay=False):
    return SoTaskWrapModule(ConvEncDec(**ENC, dtype=dtype),
                            DPCRN(transpose_delay=transpose_delay, **UNET, dtype=dtype),
                            **WRAP).eval()


def _pair(rng, transpose_delay=False):
    """(JAX wrapper, f64 variables, port wrapper loaded with them, strict)."""
    jwrap = _jax_wrap(transpose_delay)
    v = jwrap.init(KEY, jnp.zeros((1, 8 * HOP)), method=JWrap.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + 0.05 * rng.standard_normal(np.shape(a)),
        jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = _port_wrap(torch.float64, transpose_delay)
    model.load_state_dict(from_jax(v), strict=True)
    return jwrap, v, model


@pytest.fixture
def pair(rng):
    return _pair(rng)


def _japply(jwrap, v, fn, *args):
    with jax.enable_x64(True):
        return np.asarray(jwrap.apply(v, *[jnp.asarray(a) for a in args], method=fn))


def test_conv_stft_matches_jax(pair, rng):
    """Forward, inverse, streaming analysis and synthesis of ConvSTFT."""
    jwrap, v, model = pair
    stft = model.encoder.encoder
    x = rng.standard_normal((2, HOP * 12)) * 0.3
    X = _japply(jwrap, v, lambda m, a: m.encoder(a), x)
    _close(model.encoder(_t(x)).numpy(), X)
    _close(model.encoder.inverse(_t(X)).numpy(),
           _japply(jwrap, v, lambda m, a: m.encoder.inverse(a), X))
    K = 3
    buf = x[:, :(K - 1) * HOP + N_FFT]
    for drop in (True, False):
        ri = _japply(jwrap, v, lambda m, a: m.encoder.encoder.stream_analysis_ri(
            a, K, drop), buf)
        _close(stft.stream_analysis_ri(_t(buf), K, drop).numpy(), ri)
        _close(stft.stream_synthesis_frames(_t(ri), drop).numpy(),
               _japply(jwrap, v, lambda m, a: m.encoder.encoder.stream_synthesis_frames(
                   a, drop), ri))


def test_conv2d_and_transpose_conv_match_jax(pair, rng):
    """A down layer's Conv2d (asymmetric pad, stride 2) and an up layer's
    ConvTranspose2d (padding / output_padding), offline and stream_apply."""
    jwrap, v, model = pair
    m = model.masker
    x = rng.standard_normal((2, 8, 32, 5))
    carry = rng.standard_normal((2, 8, 32))
    seq = m.cnn_down[1]
    _close(seq[1](seq[0](_t(x))).numpy(),
           _japply(jwrap, v, lambda mm, a: mm.masker.cnn_down[1](a), x))
    _close(seq[1].stream_apply(_t(x), _t(carry), (1, 1)).numpy(),
           _japply(jwrap, v, lambda mm, a, c: mm.masker.cnn_down[1].stream_apply(
               a, c, (1, 1)), x, carry))
    for j, shape in ((0, (2, 64, 16, 5)), (4, (2, 16, 32, 5))):
        h = rng.standard_normal(shape)
        hc = rng.standard_normal(shape[:3])
        up = m.cnn_up[j][0]
        _close(up(_t(h)).numpy(), _japply(jwrap, v, lambda mm, a: mm.masker.cnn_up[j](a), h))
        _close(up.stream_apply(_t(h), _t(hc)).numpy(),
               _japply(jwrap, v, lambda mm, a, c: mm.masker.cnn_up[j].stream_apply(a, c),
                       h, hc))


def test_lstm_single_rnn_and_block_match_jax(pair, rng):
    """The bidirectional LSTM, SingleRNN, DPRNNblock2D forward and its stock
    step_chunk with carried state."""
    jwrap, v, model = pair
    blk = model.masker.dprnn_block1
    x = rng.standard_normal((3, 7, 32))
    y, (h, c) = blk.intra_rnn.rnn(_t(x))
    jy = _japply(jwrap, v, lambda m, a: m.masker.dprnn_block1.intra_rnn.rnn(a)[0], x)
    jh = _japply(jwrap, v, lambda m, a: m.masker.dprnn_block1.intra_rnn.rnn(a)[1][0], x)
    _close(y.numpy(), jy)
    _close(h.numpy(), jh)
    xs = rng.standard_normal((3, 32, 7))
    _close(blk.intra_rnn(_t(xs)).numpy(),
           _japply(jwrap, v, lambda m, a: m.masker.dprnn_block1.intra_rnn(a), xs))
    xb = rng.standard_normal((2, 32, 16, 6))
    _close(blk(_t(xb)).numpy(), _japply(jwrap, v, lambda m, a: m.masker.dprnn_block1(a), xb))
    h0 = rng.standard_normal((1, 2, 16, 16)) * 0.3
    c0 = rng.standard_normal((1, 2, 16, 16)) * 0.3
    got = blk.step_chunk(_t(xb[..., :2]), _t(h0), _t(c0))
    for i in range(3):
        _close(got[i].numpy(), _japply(
            jwrap, v, lambda m, a, hh, cc: m.masker.dprnn_block1.step_chunk(a, hh, cc)[i],
            xb[..., :2], h0, c0))


def test_dpcrn_forward_and_stream_frames_match_jax(pair, rng):
    jwrap, v, model = pair
    m = model.masker
    x = rng.standard_normal((2, 128, 9))
    _close(m(_t(x)).numpy(), _japply(jwrap, v, lambda mm, a: mm.masker(a), x))
    state = m.init_stream_state(2, torch.float64)
    with jax.enable_x64(True):
        jstate = jwrap.apply(v, 2, jnp.float64,
                             method=lambda mm, b, dt: mm.masker.init_stream_state(b, dt))
        step = jax.jit(lambda a, s: jwrap.apply(
            v, a, s, method=lambda mm, a, s: mm.masker.stream_frames(a, s)))
        for k in range(0, 9, 3):
            want, jstate = step(jnp.asarray(x[..., k:k + 3]), jstate)
            got, state = m.stream_frames(_t(x[..., k:k + 3]), state)
            _close(got.numpy(), want)
    for key in ("h1", "c2"):
        _close(state[key].numpy(), jstate[key])


@pytest.mark.parametrize("combo", [("complex", "complex"), ("real", "complex"),
                                   ("real", "real"), ("polar", "polar")])
def test_apply_tf_masks_matches_jax(rng, combo):
    tf = rng.standard_normal((2, 10, 7))
    mk = rng.standard_normal((2, 5 if combo == ("real", "complex") else 10, 7))
    with jax.enable_x64(True):
        want = j_apply_tf_masks(jnp.asarray(tf), jnp.asarray(mk), *combo)
    _close(apply_tf_masks(_t(tf), _t(mk), *combo).numpy(), want)


def test_offline_inference_matches_jax(pair, rng):
    jwrap, v, model = pair
    x = rng.standard_normal((2, HOP * 20 + 5)) * 0.3
    with torch.no_grad():
        got = model.inference(_t(x))
    _close(got.numpy(), _japply(jwrap, v, JWrap.inference, x))


@pytest.mark.parametrize("transpose_delay", [False, True])
def test_streaming_ns_step_matches_jax_chunk_by_chunk(rng, transpose_delay):
    """StreamingNS.step against JAX's, chunk by chunk (4 frames each), and
    the port's stream == offline contract past n_fft samples."""
    jwrap, v, model = _pair(rng, transpose_delay)
    jeng = JStreamingNS(encoder=jwrap.encoder, masker=jwrap.masker,
                        mask_constraint="linear", drop_first_bin=True)
    engine = build_engine(model)
    assert isinstance(engine, StreamingNS)
    S, n = 4 * HOP, 6
    x = rng.standard_normal((2, S * n)) * 0.3
    state = engine.init_state(2, torch.float64)
    assert state["wsum"].dtype == torch.float32
    outs = []
    with jax.enable_x64(True):
        jstate = jeng.apply(v, 2, jnp.float64, method=JStreamingNS.init_state)
        step = jax.jit(lambda a, s: jeng.apply(v, a, s, method=JStreamingNS.step))
        for k in range(n):
            chunk = x[:, k * S:(k + 1) * S]
            want, jstate = step(jnp.asarray(chunk), jstate)
            with torch.no_grad():
                got, state = engine.step(_t(chunk), state)
            _close(got.numpy(), want)
            outs.append(got)
    for key in ("enc_tail", "ola_tail"):
        _close(state[key].numpy(), jstate[key])
    delay = engine_delay_samples(engine)
    assert delay == N_FFT - HOP + (5 * HOP if transpose_delay else 0)
    with torch.no_grad():
        off = model.inference(torch.nn.functional.pad(_t(x), (N_FFT - HOP, 0)))
    streamed = torch.cat(outs, -1)
    lag = delay - (N_FFT - HOP)
    lo = N_FFT + lag
    np.testing.assert_allclose(streamed[:, lo:].numpy(),
                               off[:, lo - lag:streamed.shape[-1] - lag].numpy(),
                               atol=ATOL, rtol=RTOL)


def _small_f32(seed=0):
    model = _port_wrap(torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.fixture
def ring_hub():
    from puresound_tpu_torch.src import native

    return native.load()


@pytest.mark.parametrize("mode", [dict(), dict(fused=True), dict(dp_kernel=True),
                                  dict(mk_kernel=True)])
def test_ns_session_server_matches_bare_engine(rng, ring_hub, mode):
    """3 NS slots attached without enrollment; a session joins one tick
    late and another takes a freed slot: each output equals a fresh bare
    engine fed the same audio (stock, fused and dp_kernel routes)."""
    model = _small_f32()
    bundle = make_session_server(model, None, n_slots=3, chunk_ms=8.0,
                                 lockstep=True, **mode)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    assert chunk == 4 * HOP and bundle.embed_fn is None and bundle.embed_dim is None
    step_kw, init_kw = engine_step_options(engine, **mode)

    def solo(audio):
        with torch.no_grad():
            st = engine.init_state(1, **init_kw)
            outs = []
            for k in range(len(audio) // chunk):
                y, st = engine.step(torch.from_numpy(
                    audio[None, k * chunk:(k + 1) * chunk]), st, **step_kw)
                outs.append(y[0].numpy())
        return np.concatenate(outs)

    mk = lambda n: (rng.standard_normal(n * chunk) * 0.3).astype(np.float32)
    sessions, finished = {}, []

    def join(n):
        sessions[server.attach()] = [mk(n), 0, []]

    def tick():
        for sid, s in sessions.items():
            server.hub.push_input(sid, s[0][s[1] * chunk:(s[1] + 1) * chunk])
            s[1] += 1
        assert server.tick() == len(sessions)
        for sid in list(sessions):
            s = sessions[sid]
            s[2].append(server.hub.pop_output(sid, chunk))
            if s[1] * chunk >= len(s[0]):
                finished.append((s[0], np.concatenate(s[2])))
                del sessions[sid]
                server.detach(sid)

    join(3)
    tick()
    join(4)
    tick()
    join(2)
    while sessions:
        tick()
        if len(finished) == 1 and len(sessions) < 3:
            join(2)
    assert len(finished) == 4
    for audio, got in finished:
        np.testing.assert_allclose(got, solo(audio), atol=1e-5)
    assert server.stats.snapshot()["underrun_slot_ticks"] == 0


def test_engine_step_options_flags():
    engine = StreamingNS.from_offline(_port_wrap(torch.float32))
    assert engine_step_options(engine) == ({}, {})
    assert engine_step_options(engine, fused=True) == ({"fused": True}, {})
    assert engine_step_options(engine, dp_kernel=True) == (
        {"dp_kernel": True}, {"dp_kernel": True})
    with pytest.raises(ValueError, match="mutually exclusive"):
        engine_step_options(engine, fused=True, dp_kernel=True)
    assert engine_step_options(engine, mk_kernel=True) == (
        {"mk_kernel": True}, {"mk_kernel": True})
    with pytest.raises(ValueError, match="DPARN"):
        engine_step_options(engine, attn_kernel=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        make_session_server(_port_wrap(torch.float32), None, 1, fused=True,
                            dp_kernel=True)


def test_ns_zoo_parameter_count_and_device_rule():
    model = init_model("ns_dpcrn_v0_causal", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 1_380_043
    assert not model.masker.transpose_delay
    assert init_model("ns_dpcrn_v0", device="cpu").masker.transpose_delay
    assert sum(p.numel() for p in init_model(
        "ns_dparn_v0_causal", device="cpu").parameters()) == 1_215_179
    if torch.cuda.is_available():
        assert next(init_model("ns_dpcrn_v0_causal").parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_model("ns_dpcrn_v0_causal")

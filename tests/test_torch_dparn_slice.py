"""Port parity, the DPARN NS serving slice: a small ns_dparn-style model
(ConvEncDec n_fft 128 / hop 32 + DPARN channels (1, 8, 8, 16, 16, 32),
hidden 16, 4 heads) against the JAX package in float64 (atol 1e-8, rtol
1e-6) module by module and as a whole: the attention layers, DPARNblock2D,
DPARN, offline inference and StreamingNS.step on every route (stock, fused,
attn_kernel, fused + attn_kernel, mk_kernel; the kernel routes through their
plain versions, held against JAX's stock step), the weights crossing over
through from_jax (strict); NS make_session_server for DPARN; the zoo's
parameter count; bf16 casting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.lobe.attention import attention_mask as j_attention_mask
from puresound_tpu.streaming.ns_engine import StreamingNS as JStreamingNS
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.nnet.lobe.attention import MhaSelfAttenLayer, attention_mask
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.file_eval import build_engine, engine_step_options
from puresound_tpu_torch.streaming.halfprec import to_half
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
            delay=(0, 0, 0, 0, 0), rnn_hidden=16, nhead=4)
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


def _port_wrap(dtype=torch.float64, transpose_delay=False):
    return SoTaskWrapModule(ConvEncDec(**ENC, dtype=dtype),
                            DPARN(transpose_delay=transpose_delay, **UNET, dtype=dtype),
                            **WRAP).eval()


def _pair(rng, transpose_delay=False):
    """(JAX wrapper, f64 variables, port wrapper loaded with them, strict)."""
    jwrap = JWrap(encoder=JEncDec(**ENC),
                  masker=JDPARN(transpose_delay=transpose_delay, **UNET), **WRAP)
    v = jwrap.init(KEY, jnp.zeros((1, 8 * HOP)), method=JWrap.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) + 0.05 * rng.standard_normal(np.shape(a)),
        jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = _port_wrap(torch.float64, transpose_delay)
    model.load_state_dict(from_jax(v), strict=True)
    return jwrap, v, model


@pytest.fixture(scope="module")
def pair():
    return _pair(np.random.default_rng(99))


def _japply(jwrap, v, fn, *args):
    with jax.enable_x64(True):
        return np.asarray(jwrap.apply(v, *[jnp.asarray(a) for a in args], method=fn))


def test_positional_encoding_matches_jax(pair, rng):
    jwrap, v, model = pair
    x = rng.standard_normal((2, 11, 32))
    pos = model.masker.dprnn_block1.intra_atten1.pos
    _close(pos(_t(x)).numpy(), _japply(
        jwrap, v, lambda m, a: m.masker.dprnn_block1.intra_atten1.pos(a), x))
    assert pos.table(5, "cpu").dtype == torch.float32


@pytest.mark.parametrize("causal,context", [(False, None), (True, None), (True, 3),
                                            (False, 4)])
def test_attention_mask_matches_jax(causal, context):
    with jax.enable_x64(True):
        want = j_attention_mask(9, causal, context)
    got = attention_mask(9, causal, context)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal,context", [(False, None), (True, None), (True, 4)])
def test_mha_matches_jax(pair, rng, causal, context):
    """MHA (no biases) and its head-averaged weights, under each mask."""
    jwrap, v, model = pair
    mha = model.masker.dprnn_block2.intra_atten2.self_atten
    q = rng.standard_normal((3, 10, 32))
    for i in range(2):
        _close(mha(_t(q), _t(q), _t(q), causal, context)[i].numpy(), _japply(
            jwrap, v, lambda m, a: m.masker.dprnn_block2.intra_atten2.self_atten(
                a, a, a, causal, context)[i], q))


@pytest.mark.parametrize("layer", ["intra_atten1", "intra_atten2"])
def test_mha_self_atten_layer_matches_jax(pair, rng, layer):
    """The encoder block with and without positions: flax LayerNorm's
    single-pass variance, the ReLU feed-forward."""
    jwrap, v, model = pair
    x = rng.standard_normal((3, 32, 16)) * 2.0
    mod = getattr(model.masker.dprnn_block1, layer)
    _close(mod(_t(x)).numpy(), _japply(
        jwrap, v, lambda m, a: getattr(m.masker.dprnn_block1, layer)(a), x))


def test_improved_attention_layer_raises():
    """improved=True builds now (it raised before it was ported): the LSTM
    feed-forward and no positions, against its plain math with
    torch.nn.LSTM on the same weights; and nothing of it raises."""
    g = torch.Generator().manual_seed(3)
    layer = MhaSelfAttenLayer(16, 12, 4, improved=True, dtype=torch.float64,
                              generator=g).eval()
    assert not hasattr(layer, "pos") and not hasattr(layer, "feedforward")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 16, 7)))
    ref = torch.nn.LSTM(16, 12, batch_first=True, dtype=torch.float64)
    ref.load_state_dict(layer.recurrent.state_dict())
    xt = x.transpose(1, 2)
    a = layer.norm1(xt + layer.self_atten(xt, xt, xt, causal=False)[0])
    want = layer.norm2(a + layer.ff2(torch.relu(ref(a)[0]))).transpose(1, 2)
    with torch.no_grad():
        _close(layer(x).numpy(), want.detach().numpy())


@pytest.mark.parametrize("fused,attn_kernel", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_dparn_block_forward_and_step_chunk_match_jax(pair, rng, fused, attn_kernel):
    """DPARNblock2D's forward, and its step_chunk with carried state on each
    route against JAX's stock step."""
    jwrap, v, model = pair
    blk = model.masker.dprnn_block1
    xb = rng.standard_normal((2, 32, 16, 6))
    _close(blk(_t(xb)).numpy(), _japply(jwrap, v, lambda m, a: m.masker.dprnn_block1(a),
                                        xb))
    h0 = rng.standard_normal((1, 2, 16, 16)) * 0.3
    c0 = rng.standard_normal((1, 2, 16, 16)) * 0.3
    got = blk.step_chunk(_t(xb[..., :2]), _t(h0), _t(c0), fused=fused,
                         attn_kernel=attn_kernel)
    for i in range(3):
        _close(got[i].numpy(), _japply(
            jwrap, v, lambda m, a, hh, cc: m.masker.dprnn_block1.step_chunk(a, hh, cc)[i],
            xb[..., :2], h0, c0))


def test_dparn_forward_and_stream_frames_match_jax(pair, rng):
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


def test_offline_inference_matches_jax(pair, rng):
    jwrap, v, model = pair
    x = rng.standard_normal((2, HOP * 20 + 5)) * 0.3
    _close(model.inference(_t(x)).numpy(), _japply(jwrap, v, JWrap.inference, x))


ROUTES = {"stock": {}, "fused": dict(fused=True), "attn_kernel": dict(attn_kernel=True),
          "fused+attn_kernel": dict(fused=True, attn_kernel=True),
          "mk_kernel": dict(mk_kernel=True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_streaming_ns_step_matches_jax_chunk_by_chunk(pair, rng, route):
    """StreamingNS.step on each route against JAX's stock step, chunk by
    chunk (4 frames each), and stream == offline past n_fft samples."""
    jwrap, v, model = pair
    kw = ROUTES[route]
    jeng = JStreamingNS(encoder=jwrap.encoder, masker=jwrap.masker,
                        mask_constraint="linear", drop_first_bin=True)
    engine = build_engine(model)
    S, n = 4 * HOP, 5
    x = rng.standard_normal((2, S * n)) * 0.3
    state = engine.init_state(2, torch.float64, mk_kernel=route == "mk_kernel")
    outs = []
    with jax.enable_x64(True):
        jstate = jeng.apply(v, 2, jnp.float64, method=JStreamingNS.init_state)
        step = jax.jit(lambda a, s: jeng.apply(v, a, s, method=JStreamingNS.step))
        for k in range(n):
            chunk = x[:, k * S:(k + 1) * S]
            want, jstate = step(jnp.asarray(chunk), jstate)
            got, state = engine.step(_t(chunk), state, **kw)
            _close(got.numpy(), want)
            outs.append(got)
    off = model.inference(torch.nn.functional.pad(_t(x), (N_FFT - HOP, 0)))
    streamed = torch.cat(outs, -1)
    np.testing.assert_allclose(streamed[:, N_FFT:].numpy(),
                               off[:, N_FFT:streamed.shape[-1]].numpy(),
                               atol=ATOL, rtol=RTOL)


def test_transpose_delay_stream_frames_match_jax(rng):
    """The semi-causal ns_dparn_v0 form: stream_frames with its skip FIFOs."""
    jwrap, v, model = _pair(rng, transpose_delay=True)
    m = model.masker
    x = rng.standard_normal((2, 128, 8))
    state = m.init_stream_state(2, torch.float64)
    assert "skipq" in state
    with jax.enable_x64(True):
        jstate = jwrap.apply(v, 2, jnp.float64,
                             method=lambda mm, b, dt: mm.masker.init_stream_state(b, dt))
        for k in range(0, 8, 4):
            want, jstate = jwrap.apply(v, jnp.asarray(x[..., k:k + 4]), jstate,
                                       method=lambda mm, a, s: mm.masker.stream_frames(a, s))
            got, state = m.stream_frames(_t(x[..., k:k + 4]), state)
            _close(got.numpy(), want)


def test_from_jax_dparn_wrapper_is_strict(pair):
    """from_jax tells DPARN from DPCRN by the masker's keys and names every
    parameter and buffer of the port's DPARN wrapper."""
    _, v, model = pair
    sd = from_jax(v)
    assert set(sd) == set(model.state_dict())
    assert "masker.dprnn_block1.intra_atten1.self_atten.atten.in_proj_weight" in sd
    assert "masker.dprnn_block2.intra_atten2.feedforward.3.weight" in sd
    assert not any("pos" in k for k in sd)


def test_dparn_zoo_parameter_count_and_names():
    model = init_model("ns_dparn_v0_causal", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert isinstance(model.masker, DPARN) and model.masker.nhead == 8
    assert sum(p.numel() for p in model.parameters()) == 1_215_179
    assert not model.masker.transpose_delay
    assert init_model("ns_dparn_v0", device="cpu").masker.transpose_delay
    with pytest.raises(NameError):
        init_model("ns_dparn_v1", device="cpu")


def test_to_half_casts_the_attention_parameters(pair):
    """bf16 serving casts every float32 parameter, the MHA projections and
    the flax-style norms included, and leaves the float32 positions."""
    model = to_half(_port_wrap(torch.float32))
    att = model.masker.dprnn_block1.intra_atten1
    for p in (att.self_atten.atten.in_proj_weight, att.self_atten.atten.out_proj.weight,
              att.norm1.weight, att.norm2.bias, att.feedforward[0].weight):
        assert p.dtype == torch.bfloat16
    assert att.pos.table(4, "cpu").dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def _small_f32(seed=0):
    model = _port_wrap(torch.float32)
    g = torch.Generator().manual_seed(seed)
    for p in model.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


@pytest.mark.parametrize("mode", [dict(attn_kernel=True),
                                  dict(fused=True, attn_kernel=True),
                                  dict(mk_kernel=True)])
def test_dparn_session_server_matches_bare_engine(rng, mode):
    """3 DPARN slots: a session joins one tick late and another takes a
    freed slot; each output equals a fresh bare engine fed the same audio."""
    from puresound_tpu_torch.src import native

    native.load()
    model = _small_f32()
    bundle = make_session_server(model, None, n_slots=3, chunk_ms=8.0, lockstep=True,
                                 **mode)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    step_kw, init_kw = engine_step_options(engine, **mode)
    assert step_kw == mode

    def solo(audio):
        st = engine.init_state(1, **init_kw)
        outs = []
        for k in range(len(audio) // chunk):
            y, st = engine.step(torch.from_numpy(audio[None, k * chunk:(k + 1) * chunk]),
                                st, **step_kw)
            outs.append(y[0].numpy())
        return np.concatenate(outs)

    mk = lambda n: (rng.standard_normal(n * chunk) * 0.3).astype(np.float32)
    sessions, finished = {}, []

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

    sessions[server.attach()] = [mk(3), 0, []]
    tick()
    sessions[server.attach()] = [mk(4), 0, []]
    tick()
    sessions[server.attach()] = [mk(2), 0, []]
    while sessions:
        tick()
        if len(finished) == 1 and len(sessions) < 3:
            sessions[server.attach()] = [mk(2), 0, []]
    assert len(finished) == 4
    for audio, got in finished:
        np.testing.assert_allclose(got, solo(audio), atol=1e-5)
    assert server.stats.snapshot()["underrun_slot_ticks"] == 0


def test_engine_step_options_dparn_flags():
    """attn_kernel needs a DPARN masker and combines with fused; mk_kernel
    takes DPARN and DPCRN; dp_kernel stays DPCRN's."""
    engine = build_engine(_port_wrap(torch.float32))
    assert engine_step_options(engine, attn_kernel=True) == ({"attn_kernel": True}, {})
    assert engine_step_options(engine, fused=True, attn_kernel=True) == (
        {"fused": True, "attn_kernel": True}, {})
    assert engine_step_options(engine, mk_kernel=True) == (
        {"mk_kernel": True}, {"mk_kernel": True})
    with pytest.raises(ValueError, match="DPCRN"):
        engine_step_options(engine, dp_kernel=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        engine_step_options(engine, fused=True, mk_kernel=True)
    dpcrn = SoTaskWrapModule(ConvEncDec(**ENC), DPCRN(**{k: v for k, v in UNET.items()
                                                         if k != "nhead"}), **WRAP)
    with pytest.raises(ValueError, match="DPARN"):
        engine_step_options(build_engine(dpcrn), attn_kernel=True)
    with pytest.raises(ValueError, match="causal"):
        _port_wrap(torch.float32, transpose_delay=True).masker.init_stream_state(
            1, mk_kernel=True)

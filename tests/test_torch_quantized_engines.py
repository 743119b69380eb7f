"""The quantized serving routes through the engines' public `step`, against
the JAX engines' `step` (their Pallas kernels in interpret mode), in float32:

- `StreamingTSE.step(fused=True, int8_hh / int8_full)`: a small
  tse_skim-style model over 6 chunks that cross two segment boundaries;
- `StreamingNS.step` for DPCRN on the `dp_kernel` and `mk_kernel` routes with
  `int8_hh` or `xscr_half`, and for DPARN on `mk_kernel` with `xscr_half`.

Bar against JAX: SNR >= 50 dB over the outputs (and the recurrent carries),
well above JAX's own quantization bars (tests/test_pallas_kernels.py: int8_hh
20 dB, int8_full 15, dual-path xscr_half 35, center int8_hh 30), because the
two sides quantize the same values and only an activation at a rounding
boundary can go the other way. Then each option's output is held to the
port's own float route at JAX's bar for it: the int8 output still tracks
the float one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import puresound_tpu.ops.skim_stream_kernel as j_skim_kernel
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.dparn import DPARN as JDPARN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.streaming.ns_engine import StreamingNS as JStreamingNS
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.dparn import DPARN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.ops import skim_stream_kernel as ops
from puresound_tpu_torch.streaming.engine import StreamingTSE
from puresound_tpu_torch.streaming.ns_engine import StreamingNS
from puresound_tpu_torch.utils.from_jax import from_jax

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SNR_BAR = 50.0
#: JAX's accuracy bars for each option against its float route
JAX_BARS = {"int8_hh": 20.0, "int8_full": 15.0, "xscr_half": 35.0, "mk_int8_hh": 30.0}


def _snr_db(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum((got - want) ** 2), 1e-30))


def _flat(arrays):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])


def _perturbed(v, rng, scale):
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64) + scale * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(v))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return v


# ------------------------------------------------------------------- TSE
WIN, HOP, C, E, H = 32, 16, 24, 8, 64
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=H, output_size=C, n_blocks=2, seg_size=10,
            seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
            embed_fusion="FiLM", block_with_embed=(1, 1))


@pytest.fixture
def tse_pair(rng):
    """(JAX engine, its float32 variables, the port engine loaded with them)."""
    spk = tuple([JTCN(C, 16, 3, dilation=1, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN"), JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    enc, masker = JEnc(**ENC), JSkiM(**SKIM)
    jwrap = JWrap(encoder=enc, masker=masker, speaker_net=spk, mask_constraint="ReLU")
    jeng = JEngine(encoder=enc, masker=masker, speaker_net=spk, mask_constraint="ReLU")
    v = _perturbed(jwrap.init(KEY, jnp.zeros((1, 320)), jnp.zeros((1, 800)),
                              method=JWrap.inference), rng, 0.05)
    model = SoTaskWrapModule(
        FreeEncDec(**ENC), SkiM(**SKIM),
        [TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
         AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)],
        mask_constraint="ReLU").eval()
    model.load_state_dict(from_jax(v), strict=True)
    return jeng, v, StreamingTSE.from_offline(model).eval()


@pytest.fixture
def interpret_skim_kernel(monkeypatch):
    """JAX's StreamingTSE.step calls the Pallas kernel without `interpret`,
    which the CPU backend refuses: run it in interpret mode, as JAX's own
    kernel tests do (the JAX package is not changed)."""
    orig = j_skim_kernel.fused_skim_frames

    @functools.wraps(orig)
    def interpreted(*a, **kw):
        return orig(*a, **{**kw, "interpret": True})

    monkeypatch.setattr(j_skim_kernel, "fused_skim_frames", interpreted)


def _tse_run(engine, audio, dvec, n_chunks, S, **kw):
    state = engine.init_state(audio.shape[0])
    outs = []
    with torch.no_grad():
        for k in range(n_chunks):
            y, state = engine.step(torch.from_numpy(audio[:, k * S:(k + 1) * S]), dvec,
                                   state, fused=True, **kw)
            outs.append(y.numpy())
    return outs, state


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_streaming_tse_int8_matches_jax(tse_pair, rng, interpret_skim_kernel, option):
    jeng, v, engine = tse_pair
    B, S, n = 8, 5 * HOP, 6
    audio = (rng.standard_normal((B, S * n)) * 0.3).astype(np.float32)
    enroll = (rng.standard_normal((B, 800)) * 0.3).astype(np.float32)
    jdvec = jeng.apply(v, jnp.asarray(enroll), method=JEngine.embed)
    jstate = jeng.apply(v, B, method=JEngine.init_state)
    step = jax.jit(lambda a, d, s: jeng.apply(v, a, d, s, fused=True, b_tile=B,
                                              method=JEngine.step, **{option: True}))
    want = []
    for k in range(n):
        y, jstate = step(jnp.asarray(audio[:, k * S:(k + 1) * S]), jdvec, jstate)
        want.append(y)
    with torch.no_grad():
        dvec = engine.embed(torch.from_numpy(enroll))
    got, state = _tse_run(engine, audio, dvec, n, S, **{option: True})
    carries = lambda st, key: [np.asarray(a) if not isinstance(a, torch.Tensor)
                               else a.numpy() for a in st["skim"][key]]
    g = _flat(got + carries(state, "seg_h") + carries(state, "seg_c"))
    w = _flat(want + carries(jstate, "seg_h") + carries(jstate, "seg_c"))
    assert np.isfinite(g).all()
    assert _snr_db(g, w) >= SNR_BAR


@pytest.mark.parametrize("option", ["int8_hh", "int8_full"])
def test_streaming_tse_int8_tracks_float(tse_pair, rng, option):
    """The int8 engine against the port's float fused engine, at JAX's bar
    (20 dB int8_hh, 15 dB int8_full)."""
    _, _, engine = tse_pair
    B, S, n = 8, 5 * HOP, 6
    audio = (rng.standard_normal((B, S * n)) * 0.3).astype(np.float32)
    with torch.no_grad():
        dvec = engine.embed(torch.from_numpy(
            (rng.standard_normal((B, 800)) * 0.3).astype(np.float32)))
    ref, _ = _tse_run(engine, audio, dvec, n, S)
    before = ops.LAUNCHES
    got, _ = _tse_run(engine, audio, dvec, n, S, **{option: True})
    assert ops.LAUNCHES == before                   # CPU tensors launch nothing
    assert _snr_db(_flat(got), _flat(ref)) >= JAX_BARS[option]


def test_streaming_tse_int8_needs_fused(tse_pair):
    _, _, engine = tse_pair
    with pytest.raises(ValueError, match="fused=True"):
        engine.step(torch.zeros(2, 80), torch.ones(2, E), engine.init_state(2),
                    int8_hh=True)


# -------------------------------------------------------------------- NS
N_FFT, NS_HOP = 128, 32
UNET = dict(input_type="RI", input_dim=N_FFT, norm_type="bN2d", dropout=0.0,
            channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2, transpose_delay=False,
            kernel_t=(2,) * 5, stride_t=(1,) * 5, dilation_t=(1,) * 5,
            kernel_f=(5, 3, 3, 3, 3), stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5,
            delay=(0,) * 5, rnn_hidden=16)
NS_ENC = dict(fft_length=N_FFT, win_length=N_FFT, hop_length=NS_HOP, trainable=True,
              output_format="Complex")
WRAP = dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
            mask_type="Complex")
NS_MODELS = {"dpcrn": (JDPCRN, DPCRN, {}), "dparn": (JDPARN, DPARN, {"nhead": 4})}
NS_CASES = [("dpcrn", "dp_kernel", "int8_hh"), ("dpcrn", "dp_kernel", "xscr_half"),
            ("dpcrn", "mk_kernel", "int8_hh"), ("dpcrn", "mk_kernel", "xscr_half"),
            ("dparn", "mk_kernel", "xscr_half")]


def _ns_pair(rng, name):
    jcls, pcls, extra = NS_MODELS[name]
    jwrap = JWrap(encoder=JEncDec(**NS_ENC), masker=jcls(**UNET, **extra), **WRAP)
    v = _perturbed(jwrap.init(KEY, jnp.zeros((1, 8 * NS_HOP)), method=JWrap.inference),
                   rng, 0.05)
    model = SoTaskWrapModule(ConvEncDec(**NS_ENC), pcls(**UNET, **extra), **WRAP).eval()
    model.load_state_dict(from_jax(v), strict=True)
    jeng = JStreamingNS(encoder=jwrap.encoder, masker=jwrap.masker,
                        mask_constraint="linear", drop_first_bin=True)
    return jeng, v, StreamingNS.from_offline(model)


def _ns_run(engine, audio, n, S, route, **kw):
    state = engine.init_state(audio.shape[0], **{route: True})
    outs = []
    with torch.no_grad():
        for k in range(n):
            y, state = engine.step(torch.from_numpy(audio[:, k * S:(k + 1) * S]), state,
                                   **{route: True}, **kw)
            outs.append(y.numpy())
    return outs, state


@pytest.mark.parametrize("name,route,option", NS_CASES)
def test_streaming_ns_option_matches_jax(rng, name, route, option):
    jeng, v, engine = _ns_pair(rng, name)
    B, S, n = 2, 2 * NS_HOP, 5
    audio = (0.3 * rng.standard_normal((B, S * n))).astype(np.float32)
    jstate = jeng.apply(v, B, **{route: True}, method=JStreamingNS.init_state)
    step = jax.jit(lambda a, s: jeng.apply(v, a, s, **{route: True, option: True},
                                           method=JStreamingNS.step))
    want = []
    for k in range(n):
        y, jstate = step(jnp.asarray(audio[:, k * S:(k + 1) * S]), jstate)
        want.append(y)
    got, state = _ns_run(engine, audio, n, S, route, **{option: True})
    keys = ("h1", "c1", "h2", "c2")
    g = _flat(got + [state["masker"][k].numpy() for k in keys])
    w = _flat(want + [np.asarray(jstate["masker"][k]) for k in keys])
    assert np.isfinite(g).all()
    assert _snr_db(g, w) >= SNR_BAR


@pytest.mark.parametrize("name,route,option", NS_CASES)
def test_streaming_ns_option_tracks_float(rng, name, route, option):
    """Each option against the port's same route without it, at JAX's bar
    (dual-path int8_hh 20 dB, center int8_hh 30, xscr_half 35)."""
    _, _, engine = _ns_pair(rng, name)
    B, S, n = 2, 2 * NS_HOP, 8
    audio = (0.3 * rng.standard_normal((B, S * n))).astype(np.float32)
    ref, _ = _ns_run(engine, audio, n, S, route)
    got, _ = _ns_run(engine, audio, n, S, route, **{option: True})
    bar = JAX_BARS["mk_int8_hh" if (route, option) == ("mk_kernel", "int8_hh") else option]
    assert _snr_db(_flat(got), _flat(ref)) >= bar

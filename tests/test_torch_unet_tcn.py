"""Port parity, the STFT-domain TSE slice (`tse_unet_tcn_v0`, `_v0_causal`,
`_v1`): `GatedTCN` (concat, FiLM, causal, BatchNorm in training,
`step_chunk`), `Unet(skip_conv=True)`, `UnetTcn` and `UnetFsmn` offline and
streamed by `stream_frames` at chunks of 5 and 1 frames (the lookahead's
skip FIFOs), the wrapper's SI-SNR + AAM-softmax loss and every gradient,
`StreamingNS` with a speaker net, `make_session_server` attaching by
enrollment, remat, the zoo's full-width counts / `from_jax` / a JAX
checkpoint, and the TSE CLI, against the JAX package in float64 (atol 1e-8,
rtol 1e-6) on inputs from numpy seeds, at small widths (a 128-point STFT,
3 Unet layers, 2 x 2 GatedTCN blocks of 16 channels).
"""
import functools
import importlib.util
import os
import random
import sys
import types

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu.nnet import unet as junet
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import GatedTCN as JGated
from puresound_tpu.nnet.encoder import ConvEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.lobe.trivial import Magnitude as JMag
from puresound_tpu.nnet.loss.aamsoftmax import AAMsoftmax as JAAM
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDR
from puresound_tpu.streaming.ns_engine import StreamingNS as JEngine
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet import unet
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import ConvTasNet, GatedTCN
from puresound_tpu_torch.nnet.encoder import ConvEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.lobe.trivial import Magnitude
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.parallel import TrainState, make_train_step
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.file_eval import (build_engine, engine_delay_samples,
                                                     engine_step_options, stream_signal)
from puresound_tpu_torch.streaming.ns_engine import StreamingNS
from puresound_tpu_torch.tasks import base
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo import tse as zoo

# one intra-op thread a process: the suite's workers share the cores
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
F64 = dict(dtype=torch.float64)
N_FFT, HOP, E, N_CLASS = 128, 32, 8, 5
FEAT = N_FFT                      # RI-concat features, the DC bin dropped
UNET = dict(input_type="RI", input_dim=FEAT, activation_type="PReLU", dropout=0.0,
            channels=(1, 4, 8, 8), transpose_t_size=2, transpose_delay=True,
            kernel_t=(2, 2, 2), kernel_f=(5, 5, 5), stride_t=(1, 1, 1),
            stride_f=(2, 2, 2), dilation_t=(1, 1, 1), dilation_f=(1, 1, 1),
            delay=(0, 0, 0))
TCN = dict(embed_dim=E, embed_norm=True, tcn_layer="gated", tcn_kernel=3, tcn_dim=16,
           tcn_dilated_basic=2, per_tcn_stack=2, repeat_tcn=2, tcn_with_embed=(1, 0))
VARIANTS = {"v0": dict(norm_type="gLN", tcn_norm="gLN", dconv_norm="gGN", causal=False),
            "v0_causal": dict(norm_type="bN2d", tcn_norm="bN1d", dconv_norm="bN1d",
                              causal=True),
            "v1": dict(norm_type="gLN", tcn_norm="gLN", dconv_norm="gGN", causal=False,
                       tcn_use_film=True)}
FSMN = dict(embed_dim=E, embed_norm=True, fsmn_l_context=2, fsmn_dim=12, num_fsmn=3,
            fsmn_with_embed=(1, 0, 1))
FSMN_VARIANTS = {"concat r1": dict(norm_type="gLN", fsmn_r_context=1, use_film=False),
                 "film": dict(norm_type="bN2d", fsmn_r_context=0, fsmn_norm="bN1d")}


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
    """`fn` jitted (eager JAX compiles every op on its own) on float64."""
    with jax.enable_x64(True):
        args = jax.tree_util.tree_map(jnp.asarray, args)
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _stats(tm, want: dict):
    """Every running statistic of `tm` against the {name: array} `want`."""
    names = [n for n in tm.state_dict() if "running" in n]
    assert names
    for name in names:
        _close(tm.state_dict()[name], want[name], name)


# ---------------------------------------------------------------- GatedTCN
GATED_CASES = {"plain": (0, False, False, False), "concat": (E, False, False, False),
               "film": (E, True, False, False), "causal concat": (E, False, True, False),
               "causal film train": (E, True, True, True)}


def _gated_pair(case):
    emb, film, causal, _ = GATED_CASES[case]
    nrm = "bN1d" if causal else "gLN"
    jm = JGated(6, 5, 3, dilation=2, emb_dim=emb, causal=causal, tcn_norm=nrm,
                use_film=film)
    args = (jnp.zeros((1, 6, 8)),) + ((jnp.zeros((1, emb)),) if emb else ())
    v = _random_variables(jm, len(case), *args)
    tm = GatedTCN(6, 5, 3, 2, emb_dim=emb, causal=causal, tcn_norm=nrm, use_film=film, **F64)
    tm.load_state_dict(fj.to_torch(fj.gated_tcn(v["params"], v.get("batch_stats"))),
                       strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("case", list(GATED_CASES))
def test_gated_tcn_matches_jax(case):
    """The output; in training the BatchNorm statistics, taken over the
    causal block's (k-1)*d padded frames as JAX's."""
    emb, _, causal, train = GATED_CASES[case]
    jm, v, tm = _gated_pair(case)
    rng = np.random.default_rng(10 + len(case))
    x, e = rng.standard_normal((2, 6, 17)), rng.standard_normal((2, E))
    args = (x,) + ((e,) if emb else ())
    out = _jax64(lambda *a: jm.apply(v, *a, train=train,
                                     mutable=["batch_stats"] if train else False), *args)
    tm.train(train)
    y = tm(*map(_t, args))
    _close(y, out[0] if train else out)
    if not train:
        return
    _stats(tm, fj.gated_tcn(v["params"], out[1]["batch_stats"], "bN1d"))
    # every gradient of sum(sin(y)), the FiLM convs' included

    def loss(p, *a):
        y, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *a, train=True,
                        mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y))
    grads = _jax64(jax.grad(loss), v["params"], *args)
    torch.sin(y).sum().backward()
    want = fj.gated_tcn(grads)
    assert {"cond_scale.weight", "cond_bias.weight"} <= set(want)
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], name)


@pytest.mark.parametrize("case", ["causal concat", "causal film train"])
def test_gated_tcn_step_chunk_matches_jax_and_offline(case):
    """Chunks of 1, 4 and 6 frames with the two contexts carried (`h` before
    the conditioning, `r` after it), each against JAX's step_chunk."""
    jm, v, tm = _gated_pair(case)
    rng = np.random.default_rng(20 + len(case))
    x, e = rng.standard_normal((2, 6, 11)), rng.standard_normal((2, E))
    with torch.no_grad():
        off = tm(_t(x), _t(e))
        ctx = tm.init_ctx(2, torch.float64)
    jctx, outs = jax.tree_util.tree_map(lambda t: t.numpy(), ctx), []
    for a, b in ((0, 1), (1, 5), (5, 11)):
        with torch.no_grad():
            y, ctx = tm.step_chunk(_t(x[..., a:b]), _t(e), ctx)
        jy, jctx = _jax64(lambda c, d, k: jm.apply(v, c, d, k, method=JGated.step_chunk),
                          x[..., a:b], e, jctx)
        _close(y, jy)
        for k in ("h", "r"):
            _close(ctx[k], jctx[k], k)
        outs.append(y)
    _close(torch.cat(outs, -1), off)
    with pytest.raises(ValueError, match="causal"):
        GatedTCN(6, 5, 3, 1).step_chunk(_t(x), None, ctx)


def test_conv_tasnet_builds_gated_blocks():
    m = ConvTasNet(16, 8, tcn_layer="gated", per_tcn_stack=2, repeat_tcn=1,
                   tcn_with_embed=(1, 0), tcn_norm="bN1d", causal=True)
    assert all(isinstance(b, GatedTCN) for s in m.tcn_list for b in s)
    assert m.tcn_list[0][0].emb_dim == 8 and m.tcn_list[0][1].emb_dim == 0
    with pytest.raises(NameError):
        ConvTasNet(16, 8, tcn_layer="other")


# ------------------------------------------------------------- Unet maskers
def test_unet_skip_conv_matches_jax():
    """skip_conv: each skip through a 1x1 conv and PReLU, added (not
    concatenated) before the up layer; no streaming."""
    kw = dict(UNET, norm_type="gLN", skip_conv=True)
    jm = junet.Unet(**kw)
    v = _random_variables(jm, 5, jnp.zeros((1, FEAT, 6)))
    x = np.random.default_rng(5).standard_normal((2, FEAT, 9))
    want = _jax64(lambda a: jm.apply(v, a), x)
    tm = unet.Unet(**kw, **F64)
    sd = fj.to_torch(fj.unet_updown(v["params"], v.get("batch_stats")))
    assert "skip_cnn.0.0.weight" in sd and "skip_cnn.2.1.weight" in sd
    tm.load_state_dict(sd, strict=True)
    _close(tm.eval()(_t(x)), want)
    assert not tm.causal_streamable()


@functools.lru_cache(maxsize=None)
def _masker_pair(kind, variant):
    """(JAX masker, its variables, the port's masker holding them)."""
    if kind == "tcn":
        kw = dict(UNET, **TCN, **VARIANTS[variant])
        jm, tm = junet.UnetTcn(**kw), unet.UnetTcn(**kw, **F64)
        conv = fj.unet_tcn
    else:
        kw = dict(UNET, **FSMN, **FSMN_VARIANTS[variant])
        jm, tm = junet.UnetFsmn(**kw), unet.UnetFsmn(**kw, **F64)
        conv = fj.unet_fsmn
    v = _random_variables(jm, len(variant), jnp.zeros((1, FEAT, 6)), jnp.zeros((1, E)))
    tm.load_state_dict(fj.to_torch(conv(v["params"], v.get("batch_stats"))), strict=True)
    return jm, v, tm.eval(), conv


@pytest.mark.parametrize("kind,variant,train", [
    ("tcn", "v0", False), ("tcn", "v0_causal", False), ("tcn", "v0_causal", True),
    ("tcn", "v1", False), ("fsmn", "concat r1", False), ("fsmn", "film", True)])
def test_unet_maskers_offline_match_jax(kind, variant, train):
    """UnetTcn (the bottleneck 8 x 8 = 64 wide) and UnetFsmn offline; in
    training the BatchNorm statistics (bN2d in the Unet, bN1d in the
    blocks)."""
    jm, v, tm, conv = _masker_pair(kind, variant)
    rng = np.random.default_rng(30 + len(variant))
    x, d = rng.standard_normal((2, FEAT, 13)), rng.standard_normal((2, E))
    out = _jax64(lambda a, b: jm.apply(v, a, b, train=train,
                                       mutable=["batch_stats"] if train else False), x, d)
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train(train)
    try:
        _close(tm(_t(x), _t(d)), out[0] if train else out)
        if train:
            _stats(tm, conv(v["params"], out[1]["batch_stats"]))
    finally:
        tm.load_state_dict(before)
        tm.eval()


@pytest.mark.parametrize("chunk", [5, 1])
@pytest.mark.parametrize("kind,variant", [("tcn", "v0_causal"), ("fsmn", "film")])
def test_unet_maskers_stream_frames_match_jax_and_offline(kind, variant, chunk):
    """stream_frames with the skip FIFOs carried: each chunk against JAX's
    stream_frames, the stream against offline delayed by D = 3 frames."""
    jm, v, tm, _ = _masker_pair(kind, variant)
    rng = np.random.default_rng(40 + chunk)
    T = 15
    x, d = rng.standard_normal((2, FEAT, T)), rng.standard_normal((2, E))
    D = tm.stream_delay_frames
    assert D == 3
    with torch.no_grad():
        off = tm(_t(x), _t(d))
        state = tm.init_stream_state(2, torch.float64)
    cls = type(jm)
    jstate = _jax64(lambda: jm.apply(v, 2, jnp.float64, method=cls.init_stream_state))
    step = jax.jit(functools.partial(jm.apply, method=cls.stream_frames))
    outs = []
    for a in range(0, T, chunk):
        with torch.no_grad():
            y, state = tm.stream_frames(_t(x[..., a:a + chunk]), state, _t(d))
        with jax.enable_x64(True):
            jy, jstate = step(v, jnp.asarray(x[..., a:a + chunk]), jstate, jnp.asarray(d))
        _close(y, jy)
        outs.append(y)
    _close(torch.cat(outs, -1)[..., D:], off[..., :T - D])


def test_maskers_that_cannot_stream_raise():
    kw = dict(UNET, **TCN)
    with pytest.raises(ValueError, match="causal UnetTcn"):
        unet.UnetTcn(**kw, **VARIANTS["v0"]).init_stream_state(1)
    with pytest.raises(ValueError, match="fsmn_r_context 0"):
        unet.UnetFsmn(**dict(UNET, **FSMN, **FSMN_VARIANTS["concat r1"])).check_streamable()
    with pytest.raises(ValueError, match="skip_conv"):
        unet.UnetTcn(**dict(kw, skip_conv=True), **VARIANTS["v0_causal"]).check_streamable()


# -------------------------------------------------- the wrapper, end to end
def _jax_wrap(variant, losses=True):
    spk = (JMag(drop_first=False), JGated(FEAT // 2, 16, 3, dilation=1, causal=False,
                                          tcn_norm="gLN"),
           JASP(FEAT // 2, 8), JConv(FEAT, E, 1, use_bias=False))
    kw = dict(loss_func_wav=JSDR.init_mode("sisnr"),
              loss_func_spk=JAAM(E, N_CLASS)) if losses else {}
    return JWrap(encoder=JEnc(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP,
                              trainable=True, output_format="Complex"),
                 masker=junet.UnetTcn(**UNET, **TCN, **VARIANTS[variant]), speaker_net=spk,
                 mask_constraint="linear", drop_first_bin=True, **kw)


def _port_wrap(variant, losses=True, dtype=torch.float64, device=None):
    fk = dict(dtype=dtype, device=device)
    spk = [Magnitude(drop_first=False), GatedTCN(FEAT // 2, 16, 3, 1, tcn_norm="gLN", **fk),
           AttentiveStatisticsPooling(FEAT // 2, 8, **fk), Conv1d(FEAT, E, 1, bias=False, **fk)]
    kw = dict(loss_func_wav=SDRLoss.init_mode("sisnr"),
              loss_func_spk=AAMsoftmax(E, N_CLASS, **fk)) if losses else {}
    return SoTaskWrapModule(
        ConvEncDec(fft_length=N_FFT, win_length=N_FFT, hop_length=HOP, trainable=True,
                   output_format="Complex", **fk),
        unet.UnetTcn(**UNET, **TCN, **VARIANTS[variant], **fk), spk,
        mask_constraint="linear", drop_first_bin=True, **kw)


def _batch(seed, n=3, L=20 * HOP, L_enroll=12 * HOP):
    rng = np.random.default_rng(seed)
    return {"noisy": 0.3 * rng.standard_normal((n, L)),
            "enroll": 0.3 * rng.standard_normal((n, L_enroll)),
            "ref_clean": 0.3 * rng.standard_normal((n, L)),
            "spk_class": rng.integers(0, N_CLASS, n)}


@functools.lru_cache(maxsize=None)
def _wrap_variables(variant):
    b = _batch(0)
    return _random_variables(_jax_wrap(variant), 50 + len(variant),
                             **{k: jnp.asarray(a) for k, a in b.items()}, train=False)


def _inference_variables(v):
    return {"params": {k: a for k, a in v["params"].items() if k != "loss_func_spk"},
            "batch_stats": v.get("batch_stats", {})}


def test_wrapper_loss_and_gradients_match_jax():
    """SI-SNR + alpha * AAM-softmax (the 1a config's losses) in training
    mode on the causal model: the loss, every gradient (the trainable
    STFT's, the speaker net's, AAM-softmax's too) and the BatchNorm
    statistics after the step (FiLM's gradients: the GatedTCN test)."""
    variant = "v0_causal"
    jwrap, v = _jax_wrap(variant), _wrap_variables(variant)
    b = _batch(1)

    def loss_fn(params, batch):
        loss, upd = jwrap.apply({"params": params, "batch_stats": v.get("batch_stats", {})},
                                **batch, train=True, mutable=["batch_stats"])
        return loss, upd.get("batch_stats", {})
    (want, stats), grads = _jax64(jax.value_and_grad(loss_fn, has_aux=True), v["params"], b)
    model = _port_wrap(variant)
    model.load_state_dict(fj.from_jax(v), strict=True)
    model.train()
    loss = model(**{k: torch.from_numpy(np.asarray(a)) if k == "spk_class" else _t(a)
                    for k, a in b.items()})
    loss.backward()
    _close(loss, want)
    want_g = fj.params_by_name(grads)
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    assert {"encoder.encoder.wsin", "loss_func_spk.weight"} <= set(got_g)
    for name, g in got_g.items():
        _close(g, want_g[name], name)
    if stats:
        _stats(model, fj.from_jax({"params": v["params"], "batch_stats": stats}))


def test_streaming_engine_with_speaker_net_matches_jax_and_offline():
    """StreamingNS with the speaker net: the d-vector against JAX's `embed`,
    each 4-frame chunk against JAX's engine, the stream against offline
    inference of the zero-primed input delayed by D * hop samples."""
    v = _inference_variables(_wrap_variables("v0_causal"))
    j = _jax_wrap("v0_causal", losses=False)
    jeng = JEngine(encoder=j.encoder, masker=j.masker, speaker_net=j.speaker_net,
                   mask_constraint="linear", drop_first_bin=True, f_type="real",
                   mask_type="real")
    model = _port_wrap("v0_causal", losses=False)
    model.load_state_dict(fj.from_jax(v), strict=True)
    model.eval()
    engine = build_engine(model)
    assert isinstance(engine, StreamingNS) and engine.speaker_net is not None
    rng = np.random.default_rng(60)
    B, S, n = 2, 4 * HOP, 6
    x, enroll = 0.3 * rng.standard_normal((B, n * S)), 0.3 * rng.standard_normal((B, 12 * HOP))
    with torch.no_grad():
        dvec = engine.embed(_t(enroll))
        state = engine.init_state(B, torch.float64)
    jdvec = _jax64(lambda a: jeng.apply(v, a, method=JEngine.embed), enroll)
    _close(dvec, jdvec)
    jstate = _jax64(lambda: jeng.apply(v, B, jnp.float64, method=JEngine.init_state))
    jstep = jax.jit(functools.partial(jeng.apply, method=JEngine.step))
    outs = []
    for k in range(n):
        chunk = x[:, k * S:(k + 1) * S]
        with torch.no_grad():
            y, state = engine.step(_t(chunk), state, dvec)
        with jax.enable_x64(True):
            jy, jstate = jstep(v, jnp.asarray(chunk), jstate, jnp.asarray(jdvec))
        _close(y, jy)
        outs.append(y)
    y = torch.cat(outs, -1)
    pad, Dh = N_FFT - HOP, model.masker.stream_delay_frames * HOP
    assert engine_delay_samples(engine) == pad + Dh
    with torch.no_grad():
        off = model.inference(torch.nn.functional.pad(_t(x), (pad, 0)), _t(enroll))
    _close(y[:, N_FFT + Dh:], off[:, N_FFT:y.shape[-1] - Dh])


def test_non_causal_models_refuse_to_stream_and_fused_is_refused():
    model = _port_wrap("v0", losses=False).eval()
    with pytest.raises(ValueError, match="causal UnetTcn"):
        build_engine(model)
    engine = build_engine(_port_wrap("v0_causal", losses=False).eval())
    for flag in ("fused", "attn_kernel"):
        with pytest.raises(ValueError, match="DPCRN / DPARN"):
            engine_step_options(engine, **{flag: True})


@pytest.fixture
def ring_hub():
    """The C++ ring hub SessionServer runs on (csrc/, built on demand)."""
    from puresound_tpu_torch.src import native

    return native.load()


def test_session_server_attaches_by_enrollment_like_stream_signal(ring_hub):
    """make_session_server over the small causal model (f32): each slot
    attached by its enrollment; served == the bare engine tick by tick, and
    a slot's stream, trimmed by the engine's delay, == `stream_signal`."""
    model = _port_wrap("v0_causal", losses=False, dtype=torch.float32).eval()
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=8.0, enroll_len=12 * HOP,
                                 lockstep=True)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    assert chunk == 4 * HOP and bundle.embed_dim == E and bundle.embed_fn is not None
    rng = np.random.default_rng(70)
    n = 6
    audio = (0.3 * rng.standard_normal((2, n * chunk))).astype(np.float32)
    enroll = (0.3 * rng.standard_normal((2, 12 * HOP))).astype(np.float32)
    sids = [server.attach(enroll=enroll[i]) for i in range(2)]
    got = np.zeros_like(audio)
    for k in range(n):
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, audio[i, k * chunk:(k + 1) * chunk])
        assert server.tick() == 2
        for i, sid in enumerate(sids):
            got[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
    with torch.no_grad():
        d = engine.embed(torch.from_numpy(enroll))
        st, want = engine.init_state(2), []
        for k in range(n):
            y, st = engine.step(torch.from_numpy(audio[:, k * chunk:(k + 1) * chunk]), st, d)
            want.append(y.numpy())
    np.testing.assert_allclose(got, np.concatenate(want, -1), atol=1e-6, rtol=1e-5)
    delay = engine_delay_samples(engine)
    streamed, rtf = stream_signal(build_engine(model), audio[0], 16000, chunk_ms=8.0,
                                  dvec=d[:1])
    assert rtf > 0 and streamed.shape == audio[0].shape
    np.testing.assert_allclose(streamed[:n * chunk - delay], got[0, delay:], atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", [True, "dots"])
def test_remat_is_bit_equal_to_plain(mode):
    """Two Adam steps of the small causal model with dropout 0.1 in the Unet
    (BatchNorm in the Unet and the blocks): remat gives the losses, the
    gradients, the statistics and the parameters of remat False bit for
    bit (the dropout seeds replayed, the statistics not updated again)."""
    plain, got = _remat_run(False), _remat_run(mode)
    for a, b in zip(plain, got):
        assert all(map(torch.equal, a, b))


@functools.lru_cache(maxsize=None)
def _remat_run(m):
    """(per step: the loss, the gradients, the buffers; the last
    parameters) of two Adam steps under remat `m`."""
    torch.manual_seed(0)
    model = _port_wrap("v0_causal")
    for d in model.masker.modules():
        if type(d).__name__ == "Dropout":
            d.p = 0.1
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    step = make_train_step(model, loss_kwargs=dict(alpha=10.0), grad_clip=5.0, remat=m)
    out = []
    for seed in (2, 3):
        b = {k: torch.from_numpy(np.asarray(a)) if k == "spk_class" else _t(a)
             for k, a in _batch(seed, n=2).items()}
        state, metrics = step(state, b)
        out.append([metrics["loss"].clone()] + [p.grad.clone() for p in model.parameters()]
                   + [t.clone() for t in model.buffers()])
    return out + [[p.detach().clone() for p in model.parameters()]]


# ------------------------------------------------------- the zoo, full width
@functools.lru_cache(maxsize=None)
def _zoo_shapes(name):
    """JAX's full-width variable shapes with the 1a config's AAM-softmax
    (251 classes), read with `jax.eval_shape`."""
    m = jzoo.init_model(name, sig_loss=JSDR.init_mode("sisnr"), cls_loss=JAAM(192, 251))
    args = dict(noisy=jnp.zeros((1, 1600)), enroll=jnp.zeros((1, 1600)),
                ref_clean=jnp.zeros((1, 1600)), spk_class=jnp.zeros((1,), jnp.int32))
    return jax.eval_shape(lambda: m.init(KEY, **args, train=False))


ZOO_PARAMS = {"tse_unet_tcn_v0": 13_324_533, "tse_unet_tcn_v0_causal": 13_324_533,
              "tse_unet_tcn_v1": 13_177_077}


@pytest.mark.parametrize("name", ["tse_unet_tcn_v0_causal", "tse_unet_tcn_v1"])
def test_zoo_models_match_jax_count_and_load_its_variables(name):
    """Built on the CPU at full width: the parameter count equal to JAX's
    (with the AAM-softmax weight 48,192 more), a random JAX tree loads
    strictly through `from_jax`, and every flax leaf lands in one port
    tensor, none twice."""
    shapes = _zoo_shapes(name)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == ZOO_PARAMS[name] + 192 * 251
    losses = zoo.init_loss({"LOSS": {"sig_loss": "sisnr", "cls_loss": "aamsoftmax",
                                     "embed_dim": 192, "n_class": 251, "margin": 0.2,
                                     "scale": 30}, "TRAIN": {}}, device="cpu")
    model = zoo.init_model(name, *losses, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert model.masker.bottleneck_dim() == 512
    # a tree whose leaves number their elements: each number once in the port
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    starts = np.cumsum([0] + [int(np.prod(leaf.shape)) for leaf in leaves])
    v = jax.tree_util.tree_unflatten(treedef, [
        np.arange(a, b, dtype=np.float64).reshape(leaf.shape)
        for a, b, leaf in zip(starts, starts[1:], leaves)])
    sd = fj.flat_from_jax(v)
    assert len(sd) == len(leaves)
    seen = np.bincount(np.concatenate([a.ravel() for a in sd.values()]).astype(np.int64),
                       minlength=starts[-1])
    assert seen.shape == (starts[-1],) and (seen == 1).all()
    model.load_state_dict(fj.to_torch(sd), strict=True)


def test_jax_checkpoint_reads_into_the_eval_model(tmp_path):
    """A JAX checkpoint of the causal model's training state (with the
    AAM-softmax weight and the BatchNorm statistics) read by
    `checkpoint_state` and `for_model` into the zoo model built without
    losses, bit for bit."""
    name = "tse_unet_tcn_v0_causal"
    rng = np.random.default_rng(90)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               _zoo_shapes(name))
    path = tmp_path / "epoch_0.ckpt"
    path.write_bytes(fser.to_bytes({"params": v["params"], "batch_stats": v["batch_stats"],
                                    "epoch": 0}))
    model = zoo.init_model(name, device="cpu")
    state = base.checkpoint_state(str(path))
    model.load_state_dict(fj.for_model(state, model), strict=True)
    want = fj.flat_from_jax(v)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def test_zoo_names_are_all_ported_and_build_on_the_card(monkeypatch):
    """JAX_ONLY is empty; tse_unet_tcn_v0 (v0_causal's layout with global
    norms: JAX counts the same) builds with that count; every name builds on
    the card by default, raising without one."""
    assert zoo.JAX_ONLY == () and set(zoo.UNET_TCN) <= set(zoo.PORTED)
    model = zoo.init_model("tse_unet_tcn_v0", device="cpu")
    assert sum(p.numel() for p in model.parameters()) == ZOO_PARAMS["tse_unet_tcn_v0"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in zoo.UNET_TCN:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            zoo.init_model(name)


# ----------------------------------------------------------------- the CLI
def _jax_tree(sd: dict, shapes):
    """The port's state_dict `sd` as a JAX variable tree of `shapes`: the
    inverse of `from_jax`, read off `flat_from_jax` of a tree whose leaves
    number their own elements."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    ids = [np.arange(a, a + n, dtype=np.float64).reshape(leaf.shape)
           for a, n, leaf in zip(starts, sizes, leaves)]
    out = np.zeros(starts[-1], np.float32)
    for name, idx in fj.flat_from_jax(jax.tree_util.tree_unflatten(treedef, ids)).items():
        out[idx.astype(np.int64).ravel()] = sd[name].detach().float().numpy().ravel()
    return jax.tree_util.tree_unflatten(
        treedef, [out[a:a + n].reshape(leaf.shape) for a, n, leaf in zip(starts, sizes, leaves)])


def _jax_recipe(monkeypatch, target):
    """JAX's TSE recipe module, its `model` zoo giving the small causal
    model (its inference jitted) and `get_model_variables` the tree
    `target` (the checkpoint overwrites its values)."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "egs", "tse", "main.py")
    spec = importlib.util.spec_from_file_location("jax_recipe_tse_unet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jmodel = _jax_wrap("v0_causal", losses=False)
    apply = jax.jit(functools.partial(jmodel.apply, method=JWrap.inference))
    jitted = types.SimpleNamespace(apply=lambda v, *a, method=None: apply(v, *a))
    monkeypatch.setitem(sys.modules, "model", types.SimpleNamespace(
        init_model=lambda name: jitted))
    monkeypatch.setattr(mod, "get_model_variables", lambda model, hparam: target)
    return mod


@pytest.fixture(scope="module")
def tse_set(tmp_path_factory):
    return chip_smoke.write_tse_manifest(str(tmp_path_factory.mktemp("unet_set")), 3, 5)


def test_cli_trains_scores_dev_and_streams(tmp_path, tse_set, monkeypatch, capsys):
    """The shipped 1a config with MODEL.type tse_unet_tcn_v0_causal (a small
    model of its layout patched in) through `--action train`, then `dev` on
    its checkpoint against JAX's recipe `dev` on the same trained weights
    (every printed number within 1e-4); `stream_eval` streams; a non-causal
    model refuses stream_eval with the engine's ValueError."""
    monkeypatch.setattr(cli, "init_model", lambda n, *losses, **kw: _port_wrap(
        "v0_causal", losses=bool(losses), dtype=torch.float32, device=kw.get("device")).eval())
    hp = load_hparam(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                  "egs/tse/conf/libri2mix_max_2spk_clean_16k_1a.yaml"))
    hp["MODEL"]["type"] = "tse_unet_tcn_v0_causal"
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
    args = ["--ckpt", "epoch_0.ckpt", "--backend", "cpu"]
    random.seed(7)   # the dev loaders draw their seeds from Python's RNG
    means = cli.main(cli.parse_args([str(cfg), "--action", "dev", *args]))
    got = [r for r in capsys.readouterr().out.splitlines() if r.startswith("mix_")]
    assert len(got) == 3 and np.isfinite(list(means.values())).all()
    # JAX's recipe on the trained weights, written as a JAX checkpoint
    shapes = jax.eval_shape(lambda: _jax_wrap("v0_causal", losses=False).init(
        KEY, jnp.zeros((1, 800)), jnp.zeros((1, 800)), method=JWrap.inference))
    tree = _jax_tree(task.model.state_dict(), shapes)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    (jdir / "epoch_0.ckpt").write_bytes(fser.to_bytes(tree))
    jhp = dict(hp, TRAIN=dict(hp["TRAIN"], model_save_dir=str(jdir)))
    random.seed(7)
    _jax_recipe(monkeypatch, tree).action_dev(jhp, "cpu", "epoch_0.ckpt", "simple")
    want = [r for r in capsys.readouterr().out.splitlines() if r.startswith("mix_")]
    numbers = lambda rows: [[float(v) for v in r.split(",")[1:]] for r in rows]
    assert [r.split(",")[0] for r in got] == [r.split(",")[0] for r in want]
    np.testing.assert_allclose(numbers(got), numbers(want), rtol=1e-4, atol=1e-4)
    rtfs = cli.main(cli.parse_args([str(cfg), "--action", "stream_eval", *args]))
    assert len(rtfs) == 3 and all(r > 0 for r in rtfs)
    monkeypatch.setattr(cli, "load_eval_model", lambda *a: _port_wrap(
        "v0", losses=False, dtype=torch.float32).eval())
    with pytest.raises(ValueError, match="causal UnetTcn"):
        cli.main(cli.parse_args([str(cfg), "--action", "stream_eval", *args]))

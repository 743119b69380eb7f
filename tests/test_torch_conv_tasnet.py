"""Port parity, the Conv-TasNet TSE slice (`td_tse_conv_tasnet_v0{,_causal}`):
the causal DSConv, the full `TCN` block (embedding concat, causal padding,
BatchNorm in training and eval), `ConvTasNet` offline and streamed, the
wrapper's SI-SNR + AAM-softmax gradients, `StreamingTSE` and
`make_session_server` with a ConvTasNet masker, the zoo's parameter
counts, `from_jax` and JAX checkpoints, against the JAX package in float64
(atol 1e-8, rtol 1e-6) on inputs from numpy seeds, at small widths (C=16,
Ch=32, 2 repeats of 3 blocks). JAX's variables are built once a module
(`jax.eval_shape` for the full-width trees: nothing full-width compiles).
"""
import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.conv_tasnet import ConvTasNet as JConvTasNet
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.cnn import DepthwiseSeparableConv1d as JDSConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.loss.aamsoftmax import AAMsoftmax as JAAM
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDR
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN, ConvTasNet
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d, DepthwiseSeparableConv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.loss.aamsoftmax import AAMsoftmax
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.streaming.deploy import make_session_server
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
C, CH, E, N_CLASS = 16, 32, 8, 5
WIN, HOP = 32, 16
MASKER = dict(input_dim=C, embed_dim=E, embed_norm=True, tcn_kernel=3, tcn_dim=CH,
              repeat_tcn=2, tcn_dilated_basic=2, per_tcn_stack=3,
              tcn_with_embed=(1, 0, 0), tcn_layer="normal")
NORMS = {False: dict(tcn_norm="gLN", dconv_norm="gGN", causal=False),
         True: dict(tcn_norm="bN1d", dconv_norm="bN1d", causal=True)}


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


@functools.lru_cache(maxsize=None)
def _jit(module, method=None, **kw):
    """`module.apply(variables, ...)` compiled once a module (eager JAX
    dispatches every small op on its own)."""
    return jax.jit(functools.partial(module.apply, method=method, **kw))


def _jax64(fn, *args):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(np.asarray, fn(*map(jnp.asarray, args)))


# ------------------------------------------------------------ causal DSConv
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_causal_dsconv_offline_and_chunked_match_jax(dilation):
    rng = np.random.default_rng(10 + dilation)
    x = rng.standard_normal((2, 6, 23))
    jm = JDSConv(6, 5, kernel=3, dilation=dilation, causal=True, norm_cls="bN1d")
    v = _random_variables(jm, dilation, jnp.zeros((1, 6, 8)))
    want = _jax64(lambda a: jm.apply(v, a), x)
    tm = DepthwiseSeparableConv1d(6, 5, norm_cls="bN1d", kernel=3, dilation=dilation,
                                  causal=True, **F64)
    tm.load_state_dict(fj.to_torch(fj.dsconv(v["params"], v["batch_stats"])), strict=True)
    tm.eval()
    _close(tm(_t(x)), want)
    assert tm.ctx_frames == 2 * dilation
    # chunks of 1, 5 and 17 frames carried through step_chunk equal offline,
    # and equal JAX's step_chunk chunk by chunk
    ctx = torch.zeros(2, 6, tm.ctx_frames, dtype=torch.float64)
    jctx, outs = np.zeros((2, 6, tm.ctx_frames)), []
    for a, b in ((0, 1), (1, 6), (6, 23)):
        y, ctx = tm.step_chunk(_t(x[..., a:b]), ctx)
        jy, jctx = _jax64(lambda c, k: jm.apply(v, c, k, method=JDSConv.step_chunk),
                          x[..., a:b], jctx)
        _close(y, jy)
        _close(ctx, jctx)
        outs.append(y)
    _close(torch.cat(outs, -1), want)


def test_causal_dsconv_refuses_global_norms():
    for norm in ("gLN", "gGN"):
        with pytest.raises(ValueError, match="global normalization"):
            DepthwiseSeparableConv1d(6, 5, norm_cls=norm, causal=True)
    with pytest.raises(ValueError, match="causal"):
        DepthwiseSeparableConv1d(6, 5).step_chunk(torch.zeros(1, 6, 3), torch.zeros(1, 6, 2))


# ------------------------------------------------------------------- TCN
TCN_CASES = {"embed": (8, False, False), "causal eval": (0, True, False),
             "causal train": (0, True, True), "causal embed train": (8, True, True),
             "causal gLN-in eval": (0, "gLN", False)}


@pytest.mark.parametrize("case", list(TCN_CASES))
def test_tcn_matches_jax(case):
    """Outputs, and in training the updated BatchNorm statistics."""
    emb, causal, train = TCN_CASES[case]
    rng = np.random.default_rng(len(case))
    # a global norm before the causal depthwise conv, as JAX allows it
    norms = dict(NORMS[True], tcn_norm="gLN") if causal == "gLN" else NORMS[causal]
    causal = bool(causal)
    jm = JTCN(6, 5, 3, dilation=2, emb_dim=emb, **norms)
    x = rng.standard_normal((2, 6, 19))
    e = rng.standard_normal((2, emb)) if emb else None
    args = (jnp.zeros((1, 6, 8)),) + ((jnp.zeros((1, emb)),) if emb else ())
    v = _random_variables(jm, 3, *args)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x)] + ([jnp.asarray(e)] if emb else [])
        if train:
            want, upd = jm.apply(v, *jargs, train=True, mutable=["batch_stats"])
        else:
            want, upd = jm.apply(v, *jargs), None
    tm = TCN(6, 5, 3, 2, norms["tcn_norm"], norms["dconv_norm"], emb_dim=emb,
             causal=causal, **F64)
    tm.load_state_dict(fj.to_torch(fj.tcn(v["params"], v.get("batch_stats"),
                                          norms["tcn_norm"], norms["dconv_norm"])),
                       strict=True)
    tm.train(train)
    _close(tm(_t(x), _t(e) if emb else None), want)
    assert tm.fused_params() is None        # embedded or causal: the stock path
    if train:
        stats = fj.tcn(v["params"], upd["batch_stats"], norms["tcn_norm"],
                       norms["dconv_norm"])
        for name, t in tm.state_dict().items():
            if "running" in name:
                _close(t, stats[name], name)


def test_tcn_fused_params_only_for_the_kernels_blocks():
    assert TCN(6, 5, 3, 1).fused_params() is not None
    assert TCN(6, 5, 3, 1, emb_dim=4).fused_params() is None
    assert TCN(6, 5, 3, 1, "bN1d", "bN1d", causal=True).fused_params() is None
    assert TCN(6, 5, 3, 1, "bN1d", "bN1d").fused_params() is None
    assert TCN(6, 5, 3, 1, dropout=0.1).fused_params() is None


# ------------------------------------------------------------- ConvTasNet
@functools.lru_cache(maxsize=None)
def _masker_pair(causal):
    """(JAX ConvTasNet, its variables, the port's ConvTasNet holding them)."""
    jm = JConvTasNet(**MASKER, **NORMS[causal])
    v = _random_variables(jm, 20 + causal, jnp.zeros((1, C, 8)), jnp.zeros((1, E)))
    tm = ConvTasNet(**MASKER, **NORMS[causal], **F64)
    tm.load_state_dict(fj.to_torch(fj.conv_tasnet(v["params"], v.get("batch_stats"))),
                       strict=True)
    return jm, v, tm.eval()


@pytest.mark.parametrize("causal,train", [(False, False), (True, False), (True, True)],
                         ids=["gLN", "causal eval", "causal train"])
def test_conv_tasnet_offline_matches_jax(causal, train):
    jm, v, tm = _masker_pair(causal)
    rng = np.random.default_rng(30)
    x, d = rng.standard_normal((2, C, 21)), rng.standard_normal((2, E))
    with jax.enable_x64(True):
        out = _jit(jm, train=train, mutable=("batch_stats",) if train else False)(
            v, jnp.asarray(x), jnp.asarray(d))
    want = out[0] if train else out
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    tm.train(train)
    try:
        _close(tm(_t(x), _t(d)), want)
        if train:
            stats = fj.conv_tasnet(v["params"], out[1]["batch_stats"])
            for name, t in tm.state_dict().items():
                if "running" in name:
                    _close(t, stats[name], name)
    finally:
        tm.load_state_dict(before)
        tm.eval()


@pytest.mark.parametrize("sizes", [(1, 1, 1, 4), (5, 7), (3, 9, 2)],
                         ids=["1-frame", "5+7", "3+9+2"])
def test_conv_tasnet_step_frames_match_jax_and_offline(sizes):
    jm, v, tm = _masker_pair(True)
    rng = np.random.default_rng(sum(sizes))
    T = sum(sizes)
    x, d = rng.standard_normal((2, C, T)), rng.standard_normal((2, E))
    with torch.no_grad():
        offline = tm(_t(x), _t(d))
        state = tm.init_state(2, torch.float64)
    with jax.enable_x64(True):
        jstate = jm.apply(v, 2, jnp.float64, method=JConvTasNet.init_state)
    step = _jit(jm, JConvTasNet.step_frames)
    outs, a = [], 0
    for k in sizes:
        frames = np.swapaxes(x[..., a:a + k], 1, 2)
        with torch.no_grad():
            y, state = tm.step_frames(_t(frames), _t(d), state)
        with jax.enable_x64(True):
            jy, jstate = step(v, jnp.asarray(frames), jnp.asarray(d), jstate)
        _close(y, jy)
        outs.append(y)
        a += k
    for got, want in zip(state["ctx"], jstate["ctx"]):
        _close(got, want)
    _close(torch.cat(outs, -1), offline)


def test_conv_tasnet_streaming_needs_causal_and_normal_blocks():
    """A non-causal ConvTasNet refuses to stream; gated blocks
    (`tcn_layer="gated"`, ported) build GatedTCNs, and a causal gated stack
    streams with both contexts a block."""
    with pytest.raises(ValueError, match="causal"):
        ConvTasNet(**MASKER, **NORMS[False]).init_state(1)
    gated = ConvTasNet(**{**MASKER, "tcn_layer": "gated"}, **NORMS[True])
    assert type(gated.tcn_list[0][0]).__name__ == "GatedTCN"
    assert set(gated.init_state(1)["ctx"][0]) == {"h", "r"}


# -------------------------------------------------- the wrapper, end to end
def _jax_wrap(causal, losses=True):
    spk = (JTCN(C, CH, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
           JASP(C, 8), JConv(2 * C, E, 1, use_bias=False))
    kw = dict(loss_func_wav=JSDR.init_mode("sisnr"),
              loss_func_spk=JAAM(E, N_CLASS)) if losses else {}
    return JWrap(encoder=JEnc(win_length=WIN, hop_length=HOP, laten_length=C),
                 masker=JConvTasNet(**MASKER, **NORMS[causal]), speaker_net=spk,
                 mask_constraint="ReLU", **kw)


def _port_wrap(causal, losses=True, dtype=torch.float64):
    fk = dict(dtype=dtype)
    spk = [TCN(C, CH, 3, 1, **fk), AttentiveStatisticsPooling(C, 8, **fk),
           Conv1d(2 * C, E, 1, bias=False, **fk)]
    kw = dict(loss_func_wav=SDRLoss.init_mode("sisnr"),
              loss_func_spk=AAMsoftmax(E, N_CLASS, **fk)) if losses else {}
    return SoTaskWrapModule(FreeEncDec(win_length=WIN, hop_length=HOP, laten_length=C, **fk),
                            ConvTasNet(**MASKER, **NORMS[causal], **fk), spk,
                            mask_constraint="ReLU", **kw)


def _batch(seed, n=3, L=640, L_enroll=480):
    rng = np.random.default_rng(seed)
    return {"noisy": 0.3 * rng.standard_normal((n, L)),
            "enroll": 0.3 * rng.standard_normal((n, L_enroll)),
            "ref_clean": 0.3 * rng.standard_normal((n, L)),
            "spk_class": rng.integers(0, N_CLASS, n)}


@functools.lru_cache(maxsize=None)
def _wrap_variables(causal):
    b = _batch(0)
    return _random_variables(_jax_wrap(causal), 40 + causal,
                             **{k: jnp.asarray(a) for k, a in b.items()}, train=False)


@pytest.mark.parametrize("causal", [False, True], ids=["v0", "v0_causal"])
def test_wrapper_loss_and_gradients_match_jax(causal):
    """SI-SNR + alpha * AAM-softmax in training mode: the loss, every
    gradient (the gLN blocks through `tcn_block_train`'s plain version) and
    the BatchNorm statistics after the step."""
    jwrap, v = _jax_wrap(causal), _wrap_variables(causal)
    b = _batch(1)
    with jax.enable_x64(True):
        def loss_fn(params):
            loss, upd = jwrap.apply({"params": params, "batch_stats": v["batch_stats"]},
                                    **{k: jnp.asarray(a) for k, a in b.items()},
                                    train=True, mutable=["batch_stats"])
            return loss, upd["batch_stats"]
        (want, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    model = _port_wrap(causal)
    model.load_state_dict(fj.from_jax(v), strict=True)
    model.train()
    loss = model(**{k: torch.from_numpy(np.asarray(a)) if k == "spk_class" else _t(a)
                    for k, a in b.items()})
    loss.backward()
    _close(loss, want)
    want_g = fj.params_by_name(jax.device_get(grads))
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g) and any(n.startswith("loss_func_spk") for n in got_g)
    for name, g in got_g.items():
        _close(g, want_g[name], name)
    want_s = fj.from_jax({"params": v["params"], "batch_stats": jax.device_get(stats)})
    for name, t in model.state_dict().items():
        if "running" in name:
            _close(t, want_s[name], name)


def test_streaming_engine_matches_jax_and_offline():
    """StreamingTSE over the causal ConvTasNet, chunk by chunk against
    JAX's engine (the unfused step), and the whole stream against the
    port's offline inference of the zero-primed input."""
    v = _wrap_variables(True)
    inf = {"params": {k: a for k, a in v["params"].items() if k != "loss_func_spk"},
           "batch_stats": v["batch_stats"]}
    j = _jax_wrap(True, losses=False)
    jeng = JEngine(encoder=j.encoder, masker=j.masker, speaker_net=j.speaker_net,
                   mask_constraint="ReLU")
    model = _port_wrap(True, losses=False)
    model.load_state_dict(fj.from_jax(inf), strict=True)
    model.eval()
    engine = StreamingTSE.from_offline(model)
    rng = np.random.default_rng(50)
    B, S = 2, 5 * HOP
    x, enroll = 0.3 * rng.standard_normal((B, 4 * S)), 0.3 * rng.standard_normal((B, 480))
    with torch.no_grad():
        dvec = engine.embed(_t(enroll))
        state = engine.init_state(B, torch.float64)
        with pytest.raises(AttributeError, match="ConvTasNet"):
            engine.step(_t(x[:, :S]), dvec, state, fused=True)
    with jax.enable_x64(True):
        jdvec = _jit(jeng, JEngine.embed)(inf, jnp.asarray(enroll))
        jstate = jeng.apply(inf, B, jnp.float64, method=JEngine.init_state)
    _close(dvec, jdvec)
    jstep = _jit(jeng, JEngine.step)
    outs = []
    for k in range(4):
        chunk = x[:, k * S:(k + 1) * S]
        with torch.no_grad():
            y, state = engine.step(_t(chunk), dvec, state)
        with jax.enable_x64(True):
            jy, jstate = jstep(inf, jnp.asarray(chunk), jdvec, jstate)
        _close(y, jy)
        outs.append(y)
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(_t(x), WIN, HOP), _t(enroll))
    _close(torch.cat(outs, -1), offline[:, :4 * S])


@pytest.fixture
def ring_hub():
    """The C++ ring hub SessionServer runs on (csrc/, built on demand)."""
    from puresound_tpu_torch.src import native

    return native.load()


def test_session_server_resolves_fused_by_the_masker(ring_hub):
    """fused=None serves a ConvTasNet masker on its unfused step (JAX's
    default is off), fused=True names the masker in a ValueError, and the
    non-causal model refuses to stream; served == the bare engine."""
    model = _port_wrap(True, losses=False, dtype=torch.float32).eval()
    with pytest.raises(ValueError, match="ConvTasNet"):
        make_session_server(model, None, n_slots=2, chunk_ms=5.0, fused=True,
                            enroll_len=480)
    with pytest.raises(ValueError, match="causal"):
        make_session_server(_port_wrap(False, losses=False, dtype=torch.float32).eval(),
                            None, n_slots=2, chunk_ms=5.0, enroll_len=480)
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=5.0, enroll_len=480,
                                 lockstep=True)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    assert chunk == 80 and bundle.embed_dim == E
    rng = np.random.default_rng(60)
    audio = (0.3 * rng.standard_normal((2, 3 * chunk))).astype(np.float32)
    enroll = (0.3 * rng.standard_normal((2, 480))).astype(np.float32)
    sids = [server.attach(enroll=enroll[i]) for i in range(2)]
    got = np.zeros_like(audio)
    for k in range(3):
        for i, sid in enumerate(sids):
            server.hub.push_input(sid, audio[i, k * chunk:(k + 1) * chunk])
        assert server.tick() == 2
        for i, sid in enumerate(sids):
            got[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
    with torch.no_grad():
        d = engine.embed(torch.from_numpy(enroll))
        st, want = engine.init_state(2), []
        for k in range(3):
            y, st = engine.step(torch.from_numpy(audio[:, k * chunk:(k + 1) * chunk]), d, st)
            want.append(y.numpy())
    np.testing.assert_allclose(got, np.concatenate(want, -1), atol=1e-6, rtol=1e-5)


# ------------------------------------------------------- the zoo, full width
@functools.lru_cache(maxsize=None)
def _zoo_shapes(name, with_loss):
    """JAX's full-width variable shapes, read with `jax.eval_shape`."""
    loss = {}
    if with_loss:
        loss = dict(sig_loss=JSDR.init_mode("sisnr"), cls_loss=JAAM(192, 251))
    m = jzoo.init_model(name, **loss)
    args = dict(noisy=jnp.zeros((1, 800)), enroll=jnp.zeros((1, 800)),
                ref_clean=jnp.zeros((1, 800)), spk_class=jnp.zeros((1,), jnp.int32))
    if not with_loss:
        return jax.eval_shape(lambda: m.init(KEY, args["noisy"], args["enroll"],
                                             method=JWrap.inference))
    return jax.eval_shape(lambda: m.init(KEY, **args, train=False))


@pytest.mark.parametrize("name", ["td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal"])
def test_zoo_models_match_jax_count_and_load_its_variables(name):
    """Built on the CPU, the parameter count equal to JAX's (10,108,119; with
    the 251-class AAM-softmax weight 10,156,311, the reference's count), and
    a random JAX tree loads strictly through `from_jax`."""
    shapes = _zoo_shapes(name, True)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == 10_156_311
    losses = zoo.init_loss({"LOSS": {"sig_loss": "sisnr", "cls_loss": "aamsoftmax",
                                     "embed_dim": 192, "n_class": 251, "margin": 0.2,
                                     "scale": 30}, "TRAIN": {}}, device="cpu")
    model = zoo.init_model(name, *losses, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert sum(p.numel() for n, p in model.named_parameters()
               if not n.startswith("loss_func_spk")) == 10_108_119
    rng = np.random.default_rng(70)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    sd = fj.from_jax(v)
    model.load_state_dict(sd, strict=True)
    name0 = "masker.tcn_list.2.7.dconv.0.depthwise.1." + (
        "running_var" if name.endswith("causal") else "weight")
    np.testing.assert_array_equal(model.state_dict()[name0].numpy(), sd[name0].numpy())


@pytest.mark.parametrize("name", ["td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal"])
def test_jax_checkpoint_reads_into_the_eval_model(name, tmp_path):
    """A JAX checkpoint (`flax.serialization.to_bytes` of a training state
    with the AAM-softmax weight) read by `checkpoint_state` and `for_model`
    into the zoo model built without losses, bit for bit."""
    shapes = _zoo_shapes(name, True)
    rng = np.random.default_rng(80)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    path = tmp_path / "epoch_0.ckpt"
    path.write_bytes(fser.to_bytes({"params": v["params"],
                                    "batch_stats": v.get("batch_stats", {}), "epoch": 0}))
    model = zoo.init_model(name, device="cpu")
    state = base.checkpoint_state(str(path))
    assert any(k.startswith("loss_func_spk") for k in state)
    model.load_state_dict(fj.for_model(state, model), strict=True)
    want = fj.flat_from_jax(v)
    for k, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k], err_msg=k)


def _leaf_values(tree) -> np.ndarray:
    return np.sort(np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(tree)]))


@pytest.mark.parametrize("name", ["td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal"])
def test_from_jax_maps_every_leaf_once(name):
    """`from_jax` is a bijection on the full-width tree: every flax leaf
    lands in one port tensor of its size, none twice, none left over."""
    shapes = _zoo_shapes(name, True)
    rng = np.random.default_rng(90)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape), shapes)
    sd = fj.flat_from_jax(v)
    np.testing.assert_array_equal(_leaf_values(sd), _leaf_values(v))
    assert len(sd) == len(jax.tree_util.tree_leaves(v))


@pytest.mark.parametrize("name", ["td_tse_conv_tasnet_v0", "td_tse_conv_tasnet_v0_causal",
                                  "tse_skim_v0_causal_vad"])
def test_zoo_models_build_on_the_card_by_default(name, monkeypatch):
    """No card: `init_model` raises and names the CPU option, as the
    flagship's does; with device='cpu' it builds in eval mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.init_model(name)
    model = zoo.init_model(name, device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"

"""The dual-path RNN masker and the embedding-free TSE model
`veve_dprnn_v0_causal` in the port, against the JAX package in float64
(atol 1e-8, rtol 1e-6) on inputs from numpy seeds, at small widths:

- `DPRNN` offline (causal, non-causal, overlapped, FiLM-conditioned),
  values and gradients;
- the embedding-free conditioning (`_get_hidden_states`, the enrollment
  features as the mixture's inter-LSTM initial states);
- streaming: `init_state`, `condition_stream_state`, `step_frames` against
  JAX's chunk by chunk and against the offline forward;
- a small model of the veve layout through the wrapper (task 4: inference,
  the SI-SNR loss and its gradients) and through `StreamingTSE` with
  `init_state(enroll_feats=)`; the full-width zoo model's parameter count,
  `from_jax` and a JAX checkpoint;
- the two ValueErrors: `stream_eval` of an embedding-free model, and a
  chunk that is not a whole number of segments; the CLI's train / dev.
"""
import functools

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.dprnn import DPRNN as JDPRNN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.loss.sdr import SDRLoss as JSDR
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu.zoo import tse as jzoo
from puresound_tpu_torch.egs.tse import main as cli
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.dprnn import DPRNN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.loss.sdr import SDRLoss
from puresound_tpu_torch.src.utils import dump_hparam, load_hparam
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.engine import StreamingTSE, offline_equivalent_input
from puresound_tpu_torch.streaming.file_eval import stream_signal
from puresound_tpu_torch.tasks import base
from puresound_tpu_torch.utils import from_jax as fj
from puresound_tpu_torch.zoo import tse as zoo

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
F64 = dict(dtype=torch.float64)
C, H, E, K = 16, 8, 6, 5
WIN, HOP = 32, 16
CONF = "egs/tse/conf/libri2mix_max_2spk_clean_16k_1a.yaml"
VEVE = dict(input_size=C, hidden_size=H, output_size=C, n_blocks=2, seg_size=K,
            causal=True, embed_dim=0, embed_norm=False, block_with_embed=(0, 0),
            embedding_free_tse=True)


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _random_variables(module, seed, *args, **kw):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(KEY, *args, **kw))
    return jax.tree_util.tree_map(lambda s: 0.3 * rng.standard_normal(s.shape), shapes)


# ------------------------------------------------------------- offline
CASES = {"causal": dict(causal=True), "non-causal": dict(causal=False),
         "overlap": dict(causal=True, seg_overlap=True),
         "film": dict(causal=False, embed_dim=E, embed_norm=True, block_with_embed=(1, 0))}


@pytest.mark.parametrize("case", list(CASES))
def test_dprnn_matches_jax_values_and_gradients(case):
    """Forward, and the VJP for the input, the d-vector and every parameter."""
    cfg = dict(input_size=C, hidden_size=H, output_size=C, n_blocks=2, seg_size=K,
               **CASES[case])
    film = bool(cfg.get("embed_dim"))
    rng = np.random.default_rng(len(case))
    x, d = rng.standard_normal((2, C, 23)), rng.standard_normal((2, E))
    ct = rng.standard_normal((2, C, 23))
    jm = JDPRNN(**cfg)
    args = (jnp.zeros((2, C, 23)),) + ((jnp.zeros((2, E)),) if film else ())
    v = _random_variables(jm, 1, *args)
    with jax.enable_x64(True):
        @jax.jit
        def fwd_vjp(p, a, b, t):
            y, vjp = jax.vjp(lambda p, a, b: jm.apply({"params": p}, a, b if film else None),
                             p, a, b)
            return y, vjp(t)
        want, (gp, gx, gd) = fwd_vjp(v["params"], jnp.asarray(x), jnp.asarray(d),
                                     jnp.asarray(ct))
    tm = DPRNN(**cfg, **F64)
    tm.load_state_dict(fj.to_torch(fj.dprnn(v["params"])), strict=True)
    xt, dt = _t(x).requires_grad_(), _t(d).requires_grad_()
    got = tm(xt, dt if film else None)
    _close(got, want)
    got.backward(_t(ct))
    _close(xt.grad, gx)
    if film:
        _close(dt.grad, gd)
    want_g = fj.dprnn(jax.device_get(gp))
    for n, p in tm.named_parameters():
        _close(p.grad, want_g[n], n)


@functools.lru_cache(maxsize=None)
def _veve_variables():
    return _random_variables(JDPRNN(**VEVE), 2, jnp.zeros((2, C, 23)), jnp.zeros((2, C, 17)))


def test_embedding_free_conditioning_matches_jax():
    """The enrollment features' inter-LSTM finals (K positions a stream) and
    the conditioned forward, with the enrollment's gradient; no enrollment
    raises."""
    jm, v = JDPRNN(**VEVE), _veve_variables()
    rng = np.random.default_rng(3)
    x, e, ct = (rng.standard_normal((2, C, 23)), rng.standard_normal((2, C, 17)),
                rng.standard_normal((2, C, 23)))
    with jax.enable_x64(True):
        hid = jax.jit(lambda a: jm.apply(v, a, method=JDPRNN._get_hidden_states))(
            jnp.asarray(e))

        @jax.jit
        def fwd_vjp(a, b, t):
            y, vjp = jax.vjp(lambda a, b: jm.apply(v, a, b), a, b)
            return y, vjp(t)
        want, (gx, ge) = fwd_vjp(jnp.asarray(x), jnp.asarray(e), jnp.asarray(ct))
    tm = DPRNN(**VEVE, **F64)
    tm.load_state_dict(fj.to_torch(fj.dprnn(v["params"])), strict=True)
    got_hid = tm._get_hidden_states(_t(e))
    assert len(got_hid) == 2 and got_hid[0][0].shape == (1, 2 * K, H)
    for (h, c), (jh, jc) in zip(got_hid, hid):
        _close(h, jh)
        _close(c, jc)
    xt, et = _t(x).requires_grad_(), _t(e).requires_grad_()
    got = tm(xt, et)
    _close(got, want)
    got.backward(_t(ct))
    _close(xt.grad, gx)
    _close(et.grad, ge)
    with pytest.raises(ValueError, match="enrollment features"):
        tm(xt)


@pytest.mark.parametrize("conditioned", [False, True], ids=["plain", "veve"])
def test_streaming_matches_jax_and_offline(conditioned):
    """Chunks of 1, 2 and 3 segments through step_frames equal JAX's chunk by
    chunk and the offline forward on the segment-aligned input; the veve
    state conditioned by condition_stream_state; a ragged chunk raises."""
    jm, v = JDPRNN(**VEVE), _veve_variables()
    tm = DPRNN(**VEVE, **F64)
    tm.load_state_dict(fj.to_torch(fj.dprnn(v["params"])), strict=True)
    rng = np.random.default_rng(4)
    x, e = rng.standard_normal((2, C, 6 * K)), rng.standard_normal((2, C, 17))
    state = tm.init_state(2, torch.float64)
    assert state["h"][0].shape == (1, 2 * K, H)
    with jax.enable_x64(True):
        jstate = jm.apply(v, 2, jnp.float64, method=JDPRNN.init_state)
        if conditioned:
            jstate = jax.jit(lambda s, a: jm.apply(v, s, a,
                                                   method=JDPRNN.condition_stream_state))(
                jstate, jnp.asarray(e))
        jstep = jax.jit(lambda a, s: jm.apply(v, a, None, s, method=JDPRNN.step_frames))
    if conditioned:
        state = tm.condition_stream_state(state, _t(e))
    outs, t0 = [], 0
    for n in (1, 2, 3):
        chunk = x[:, :, t0:t0 + n * K].transpose(0, 2, 1)
        y, state = tm.step_frames(_t(chunk), None, state)
        with jax.enable_x64(True):
            jy, jstate = jstep(jnp.asarray(chunk), jstate)
        _close(y, jy)
        outs.append(y)
        t0 += n * K
    if conditioned:
        offline = tm(_t(x), _t(e))
    else:
        plain = DPRNN(**dict(VEVE, embedding_free_tse=False), **F64)
        plain.load_state_dict(tm.state_dict())
        offline = plain(_t(x))
    _close(torch.cat(outs, -1), offline.detach())
    with pytest.raises(ValueError, match="whole number of segments"):
        tm.step_frames(_t(x[:, :, :K + 2].transpose(0, 2, 1)), None, state)
    assert tm.chunk_frames_ok(2 * K) and not tm.chunk_frames_ok(K + 1)
    with pytest.raises(ValueError, match="causal DPRNN"):
        DPRNN(**dict(VEVE, causal=False)).init_state(1)


# ------------------------------------------------------------- veve, wrapped
def _jax_model(losses=True):
    kw = dict(loss_func_wav=JSDR.init_mode("sisnr")) if losses else {}
    return JWrap(encoder=JEnc(win_length=WIN, hop_length=HOP, laten_length=C,
                              output_active=True),
                 masker=JDPRNN(**VEVE), speaker_net=None, mask_constraint="ReLU",
                 embedding_free_tse=True, **kw)


def _port_model(losses=True, dtype=torch.float64, seed=0):
    fk = dict(dtype=dtype, generator=torch.Generator().manual_seed(seed))
    return SoTaskWrapModule(FreeEncDec(win_length=WIN, hop_length=HOP, laten_length=C,
                                       output_active=True, **fk),
                            DPRNN(**VEVE, **fk), None,
                            loss_func_wav=SDRLoss.init_mode("sisnr") if losses else None,
                            embedding_free_tse=True, mask_constraint="ReLU")


def _batch(seed, n=2, L=640, L_enroll=560):
    rng = np.random.default_rng(seed)
    return {"noisy": 0.3 * rng.standard_normal((n, L)),
            "enroll": 0.3 * rng.standard_normal((n, L_enroll)),
            "ref_clean": 0.3 * rng.standard_normal((n, L))}


@functools.lru_cache(maxsize=None)
def _wrap_variables():
    b = _batch(0)
    return _random_variables(_jax_model(), 5, **{k: jnp.asarray(a) for k, a in b.items()},
                             train=False)


def test_veve_wrapper_matches_jax():
    """Task 4: the training loss through `_forward` (the enrollment encoded by
    the mixture encoder, no speaker net) with every gradient, and inference."""
    jwrap, v = _jax_model(), _wrap_variables()
    b = _batch(1)
    with jax.enable_x64(True):
        loss_fn = lambda p: jwrap.apply({"params": p}, **{k: jnp.asarray(a)
                                                          for k, a in b.items()}, train=True)
        want, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
        want_inf = jax.jit(functools.partial(_jax_model(False).apply, method=JWrap.inference))(
            v, jnp.asarray(b["noisy"]), jnp.asarray(b["enroll"]))
    model = _port_model()
    assert model.task == 4
    model.load_state_dict(fj.from_jax(v), strict=True)
    loss = model.train()(**{k: _t(a) for k, a in b.items()})
    loss.backward()
    _close(loss, want)
    want_g = fj.params_by_name(jax.device_get(grads))
    assert set(want_g) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        _close(p.grad, want_g[n], n)
    with torch.no_grad():
        _close(model.eval().inference(_t(b["noisy"]), _t(b["enroll"])), np.asarray(want_inf))


def test_veve_engine_streams_conditioned_like_jax_and_offline(ring_hub):
    """StreamingTSE.embed returns the enrollment features, init_state
    (enroll_feats=) conditions the DPRNN; chunks of one segment equal JAX's
    engine and the offline inference with the enrollment; serving refuses
    the model and a ragged chunk names the lengths that work."""
    v = _wrap_variables()
    j = _jax_model(False)
    jeng = JEngine(encoder=j.encoder, masker=j.masker, speaker_net=None,
                   mask_constraint="ReLU")
    model = _port_model(False)
    model.load_state_dict(fj.from_jax(v), strict=True)
    model.eval()
    engine = StreamingTSE.from_offline(model)
    rng = np.random.default_rng(6)
    S = K * HOP
    x, enroll = 0.3 * rng.standard_normal((2, 5 * S)), 0.3 * rng.standard_normal((2, 560))
    with torch.no_grad():
        feats = engine.embed(_t(enroll))
        state = engine.init_state(2, torch.float64, enroll_feats=feats)
    with jax.enable_x64(True):
        jfeats = jeng.apply(v, jnp.asarray(enroll), method=JEngine.embed)
        jstate = jeng.apply(v, 2, jnp.float64, jfeats, method=JEngine.init_state)
        jstep = jax.jit(functools.partial(jeng.apply, method=JEngine.step))
    _close(feats, jfeats)
    outs = []
    for k in range(5):
        chunk = x[:, k * S:(k + 1) * S]
        with torch.no_grad():
            y, state = engine.step(_t(chunk), None, state)
        with jax.enable_x64(True):
            jy, jstate = jstep(v, jnp.asarray(chunk), None, jstate)
        _close(y, jy)
        outs.append(y)
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(_t(x), WIN, HOP), _t(enroll))
    _close(torch.cat(outs, -1), offline[:, :5 * S])
    with pytest.raises(ValueError, match="embedding-free"):
        make_session_server(model.float(), None, n_slots=2, chunk_ms=10.0)
    with pytest.raises(ValueError, match=r"whole number of segments.*\(ms\): 5, 10, 15"):
        stream_signal(engine.float(), np.zeros(800, np.float32), 16000, chunk_ms=4.0)


@pytest.fixture
def ring_hub():
    from puresound_tpu_torch.src import native

    return native.load()


# --------------------------------------------------------- the zoo model
@functools.lru_cache(maxsize=None)
def _zoo_shapes():
    m = jzoo.init_model("veve_dprnn_v0_causal", sig_loss=JSDR.init_mode("sisnr"))
    args = dict(noisy=jnp.zeros((1, 800)), enroll=jnp.zeros((1, 800)),
                ref_clean=jnp.zeros((1, 800)))
    return jax.eval_shape(lambda: m.init(KEY, **args, train=False))


def test_zoo_model_matches_jax_count_and_reads_its_checkpoint(tmp_path):
    """723,585 parameters as JAX counts; a random JAX tree loads strictly
    with every leaf mapped once; a JAX checkpoint reads through `for_model`
    bit for bit."""
    shapes = _zoo_shapes()
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    model = zoo.init_model("veve_dprnn_v0_causal", device="cpu")
    assert n_jax == 723_585 == sum(p.numel() for p in model.parameters())
    assert model.task == 4 and model.speaker_net is None
    rng = np.random.default_rng(7)
    v = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                               shapes)
    sd = fj.from_jax(v)
    assert len(sd) == len(jax.tree_util.tree_leaves(v))
    model.load_state_dict(sd, strict=True)
    path = tmp_path / "epoch_0.ckpt"
    path.write_bytes(fser.to_bytes({"params": v["params"], "batch_stats": {}, "epoch": 0}))
    fresh = zoo.init_model("veve_dprnn_v0_causal", device="cpu")
    fresh.load_state_dict(fj.for_model(base.checkpoint_state(str(path)), fresh), strict=True)
    for k, t in fresh.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), err_msg=k)


# ------------------------------------------------------------- the CLI
def test_cli_trains_veve_and_refuses_its_stream_eval(tmp_path, monkeypatch, capsys):
    """`--action train` (task 4 on `_forward`, the config's AAM-softmax left
    unused as in JAX), `dev` on its checkpoint, and `stream_eval` raising a
    ValueError that says why."""
    data = chip_smoke.write_tse_manifest(str(tmp_path / "set"), 3, 6)
    monkeypatch.setattr(cli, "init_model", lambda n, *losses, **kw: _port_model(
        bool(losses), dtype=torch.float32))
    hp = load_hparam(CONF)
    hp["MODEL"]["type"] = "veve_dprnn_v0_causal"
    hp["DATASET"].update(train=data, dev=data, eval=data, max_length=0.25)
    hp["TRAIN"].update(model_save_dir=str(tmp_path / "m"), log_dir=str(tmp_path / "l"),
                       num_epochs=1, num_workers=0, batch_size=3, seed=1,
                       use_tensorboard=False)
    cfg = tmp_path / "c.yaml"
    dump_hparam(hp, str(cfg))
    task = cli.main(cli.parse_args([str(cfg), "--action", "train", "--backend", "cpu"]))
    assert task.model.task == 4
    tree = torch.load(tmp_path / "m" / "epoch_0.ckpt", weights_only=True)
    assert all(torch.isfinite(t).all() for t in tree["params"].values())
    capsys.readouterr()
    means = cli.main(cli.parse_args([str(cfg), "--action", "dev", "--ckpt", "epoch_0.ckpt",
                                     "--backend", "cpu"]))
    assert np.isfinite(list(means.values())).all()
    with pytest.raises(ValueError, match="embedding-free.*init_state"):
        cli.main(cli.parse_args([str(cfg), "--action", "stream_eval", "--ckpt",
                                 "epoch_0.ckpt", "--backend", "cpu"]))

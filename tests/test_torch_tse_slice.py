"""Port parity, the serving slice as a whole: a small tse_skim-style model
(FreeEncDec + 2-block TCN speaker net + FiLM SkiM) through offline
inference and the streaming engine against the JAX package in float64
(atol 1e-8, rtol 1e-6), the port's own streamed == offline contract, the
SessionServer built by make_session_server, and the flagship's size."""
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu.streaming.engine import StreamingTSE as JEngine
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.encoder import FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.ops import skim_stream_kernel as ops
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.engine import (StreamingTSE,
                                                  offline_equivalent_input)
from puresound_tpu_torch.utils.from_jax import from_jax
from puresound_tpu_torch.zoo.tse import init_model

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
ATOL, RTOL = 1e-8, 1e-6
WIN, HOP, C, E = 32, 16, 24, 8
ENC = dict(win_length=WIN, hop_length=HOP, laten_length=C, output_active=True)
SKIM = dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2,
            seg_size=10, seg_overlap=False, causal=True, embed_dim=E,
            embed_norm=True, embed_fusion="FiLM", block_with_embed=(1, 1))


def _jax_parts():
    spk = tuple([JTCN(C, 16, 3, dilation=d, causal=False, tcn_norm="gLN",
                      dconv_norm="gGN") for d in (1, 2)]
                + [JASP(C, 16), JConv(2 * C, E, 1, use_bias=False)])
    return JEnc(**ENC), JSkiM(**SKIM), spk


def _port_model(dtype=torch.float64):
    fk = dict(dtype=dtype)
    spk = ([TCN(C, 16, 3, dilation=d, tcn_norm="gLN", dconv_norm="gGN", **fk)
            for d in (1, 2)]
           + [AttentiveStatisticsPooling(C, 16, **fk),
              Conv1d(2 * C, E, 1, bias=False, **fk)])
    return SoTaskWrapModule(FreeEncDec(**ENC, **fk), SkiM(**SKIM, **fk), spk,
                            mask_constraint="ReLU").eval()


@pytest.fixture
def pair(rng):
    """(JAX wrapper, JAX engine, f64 variables, port wrapper with them)."""
    enc, masker, spk = _jax_parts()
    jwrap = JWrap(encoder=enc, masker=masker, speaker_net=spk,
                  mask_constraint="ReLU")
    jeng = JEngine(encoder=enc, masker=masker, speaker_net=spk,
                   mask_constraint="ReLU")
    v = jwrap.init(KEY, jnp.zeros((1, 320)), jnp.zeros((1, 800)),
                   method=JWrap.inference)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        + 0.05 * rng.standard_normal(np.shape(a)), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    model = _port_model()
    model.load_state_dict(from_jax(v), strict=True)
    return jwrap, jeng, v, model


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_offline_inference_matches_jax(pair, rng):
    jwrap, _, v, model = pair
    x = rng.standard_normal((2, 16 * 25)) * 0.3
    enroll = rng.standard_normal((2, 800)) * 0.3
    with jax.enable_x64(True):
        want = np.asarray(jwrap.apply(v, jnp.asarray(x), jnp.asarray(enroll),
                                      method=JWrap.inference))
    with torch.no_grad():
        got = model.inference(torch.from_numpy(x), torch.from_numpy(enroll))
    _close(got.numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_streaming_step_matches_jax_chunk_by_chunk(pair, rng, fused):
    """5 chunks of 5 frames (seg_size 10): two segment boundaries."""
    _, jeng, v, model = pair
    engine = StreamingTSE.from_offline(model)
    B, S = 2, 5 * HOP
    x = rng.standard_normal((B, 5 * S)) * 0.3
    enroll = rng.standard_normal((B, 800)) * 0.3
    with torch.no_grad():
        dvec = engine.embed(torch.from_numpy(enroll))
        state = engine.init_state(B, torch.float64)
    with jax.enable_x64(True):
        jdvec = jeng.apply(v, jnp.asarray(enroll), method=JEngine.embed)
        _close(dvec.numpy(), jdvec)
        jstate = jeng.apply(v, B, jnp.float64, method=JEngine.init_state)
        for k in range(5):
            chunk = x[:, k * S:(k + 1) * S]
            want, jstate = jeng.apply(v, jnp.asarray(chunk), jdvec, jstate,
                                      method=JEngine.step)
            with torch.no_grad():
                got, state = engine.step(torch.from_numpy(chunk), dvec, state,
                                         fused=fused)
            _close(got.numpy(), want)
    for key in ("enc_tail", "dec_tail"):
        _close(state[key].numpy(), jstate[key])


def test_port_streamed_equals_port_offline(pair, rng):
    """Counterpart of tests/test_streaming.py:125 (fused route)."""
    _, _, _, model = pair
    engine = StreamingTSE.from_offline(model)
    L = HOP * 40
    x = torch.from_numpy(rng.standard_normal((2, L)) * 0.3)
    enroll = torch.from_numpy(rng.standard_normal((2, 800)) * 0.3)
    with torch.no_grad():
        offline = model.inference(offline_equivalent_input(x, WIN, HOP), enroll)
        dvec = engine.embed(enroll)
        state = engine.init_state(2, torch.float64)
        outs = []
        for i in range(0, L, 5 * HOP):
            y, state = engine.step(x[:, i:i + 5 * HOP], dvec, state, fused=True)
            outs.append(y)
    streamed = torch.cat(outs, -1)
    _close(streamed.numpy(), offline[:, :streamed.shape[-1]].numpy())


@pytest.fixture
def ring_hub():
    """The C++ ring hub SessionServer runs on (csrc/, built on demand)."""
    from puresound_tpu_torch.src import native

    return native.load()


def _small_model_f32(seed=0):
    model = _port_model(torch.float32)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return model


def test_session_server_churn_matches_bare_engine(rng, ring_hub):
    """3 slots, whole-segment chunks, sessions attach and detach mid-serving:
    each session's output equals a fresh bare engine fed the same audio
    (counterparts of tests/test_deploy.py:58 and tests/test_server.py:165)."""
    model = _small_model_f32()
    bundle = make_session_server(model, None, n_slots=3, chunk_ms=10.0,
                                 enroll_len=400, lockstep=True)
    assert bundle.chunk_samples == 160 and bundle.embed_dim == E
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    mk = lambda n: rng.standard_normal(n).astype(np.float32) * 0.3

    def solo(audio, enroll):
        with torch.no_grad():
            d = engine.embed(torch.from_numpy(enroll)[None])
            st = engine.init_state(1)
            outs = []
            for k in range(len(audio) // chunk):
                y, st = engine.step(torch.from_numpy(
                    audio[None, k * chunk:(k + 1) * chunk]), d, st, fused=True)
                outs.append(y[0].numpy())
        return np.concatenate(outs)

    sessions, finished = {}, []

    def join(n_chunks):
        audio, enroll = mk(n_chunks * chunk), mk(400)
        sid = server.attach(enroll=enroll)
        sessions[sid] = [audio, enroll, 0, []]

    def feed_and_tick():
        for sid, s in sessions.items():
            server.hub.push_input(sid, s[0][s[2] * chunk:(s[2] + 1) * chunk])
            s[2] += 1
        assert server.tick() == len(sessions)
        for sid in list(sessions):
            s = sessions[sid]
            got = server.hub.pop_output(sid, chunk)
            assert len(got) == chunk
            s[3].append(got)
            if s[2] * chunk >= len(s[0]):
                finished.append((s[0], s[1], np.concatenate(s[3])))
                del sessions[sid]
                server.detach(sid)

    join(4)
    feed_and_tick()
    join(3)                       # joins one tick in
    feed_and_tick()
    join(2)
    for _ in range(4):            # the first two retire, a slot is reused
        feed_and_tick()
        if len(sessions) < 3:
            join(2)
    while sessions:
        feed_and_tick()
    assert len(finished) >= 4
    for audio, enroll, got in finished:
        np.testing.assert_allclose(got, solo(audio, enroll), atol=1e-5)
    assert server.stats.snapshot()["underrun_slot_ticks"] == 0


def test_half_serving_runs_finite(rng, ring_hub):
    """bf16 weights, state and kernel dots (to_half): finite output, and the
    caller's float32 model is left as it was."""
    model = _small_model_f32()
    bundle = make_session_server(model, None, n_slots=2, chunk_ms=10.0,
                                 half=True, enroll_len=400)
    assert next(model.parameters()).dtype == torch.float32
    assert bundle.engine.masker.output_fc[1].weight.dtype == torch.bfloat16
    server = bundle.server
    sids = [server.attach(enroll=rng.standard_normal(400).astype(np.float32))
            for _ in range(2)]
    for _ in range(3):
        for sid in sids:
            server.hub.push_input(sid, rng.standard_normal(160).astype(np.float32))
        assert server.tick() == 2
        for sid in sids:
            out = server.hub.pop_output(sid, 160)
            assert len(out) == 160 and np.isfinite(out).all()
    assert ops.LAUNCHES == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("option", [dict(fused=True)])
def test_unported_serving_options_raise(option, rng, ring_hub):
    """Mesh serving is ported (tests/test_torch_mesh.py): with the fused
    kernel it raises JAX's ValueError; the stock step serves over the mesh."""
    from puresound_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    model = _port_model(torch.float32)
    with pytest.raises(ValueError, match="mesh serving supports the stock step only"):
        make_session_server(model, None, n_slots=2, mesh=mesh, enroll_len=400, **option)
    server = make_session_server(model, None, n_slots=2, mesh=mesh, enroll_len=400,
                                 chunk_ms=10.0).server
    sids = [server.attach(enroll=rng.standard_normal(400).astype(np.float32))
            for _ in range(2)]
    for sid in sids:
        server.hub.push_input(sid, rng.standard_normal(160).astype(np.float32))
    assert server.tick() == 2
    for sid in sids:
        assert np.isfinite(server.hub.pop_output(sid, 160)).all()


def test_streaming_server_and_slot_axes(rng, ring_hub):
    """The fixed-slot base loop (zeros for an underrun slot, its output
    withheld) and the slot axes read off the engine's state layout."""
    from puresound_tpu_torch.streaming.server import (StreamingServer,
                                                      infer_slot_axes)

    server = StreamingServer(lambda batch: torch.from_numpy(2 * batch),
                             n_streams=2, chunk_samples=8)
    x = rng.standard_normal(8).astype(np.float32)
    server.hub.push_input(0, x)
    assert server.tick() == 1
    np.testing.assert_array_equal(server.hub.pop_output(0, 8), 2 * x)
    assert server.hub.output_available(1) == 0
    server.start()                  # the serving loop on its own thread
    server.hub.push_input(1, x)
    deadline = time.monotonic() + 30
    while server.hub.output_available(1) < 8 and time.monotonic() < deadline:
        time.sleep(0.01)
    thread = server._thread
    server.stop()
    assert not thread.is_alive() and server.failure is None
    np.testing.assert_array_equal(server.hub.pop_output(1, 8), 2 * x)

    engine = StreamingTSE.from_offline(_port_model(torch.float32))
    axes = infer_slot_axes(engine.init_state)
    assert axes["enc_tail"] == axes["dec_tail"] == 0
    assert axes["skim"]["seg_h"] == [1, 1]
    assert axes["skim"]["mem_c"] == [(1, 1)]
    assert axes["skim"]["frame_count"] == -1


def test_flagship_parameter_count():
    model = init_model("tse_skim_v0_causal", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 6_375_440
    assert sum(b.numel() for b in model.buffers()) == 256
    # tse_unet_tcn_v0 is ported: JAX's count (jax.eval_shape of init,
    # tests/test_torch_unet_tcn.py), 13,372,725 with the 1a config's
    # 251-class AAM-softmax, the reference's count
    unet_tcn = init_model("tse_unet_tcn_v0", device="cpu")
    assert sum(p.numel() for p in unet_tcn.parameters()) == 13_324_533


def test_init_model_defaults_to_the_card():
    """Without a device the entry point builds on the CUDA card, and raises
    where torch sees none; the CPU only when a caller asks for it."""
    if torch.cuda.is_available():
        model = init_model("tse_skim_v0_causal")
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_model("tse_skim_v0_causal")


def test_port_imports_no_jax():
    code = ("import puresound_tpu_torch, puresound_tpu_torch.streaming.deploy, "
            "puresound_tpu_torch.zoo.tse, puresound_tpu_torch.parallel.mesh, "
            "puresound_tpu_torch.nnet.loss.sdr, "
            "puresound_tpu_torch.ops.lstm_train_kernel, "
            "puresound_tpu_torch.ops.tcn_train_kernel, puresound_tpu_torch.src.audio, "
            "puresound_tpu_torch.src.utils, puresound_tpu_torch.tasks.tse, "
            "puresound_tpu_torch.egs.tse.main, puresound_tpu_torch.zoo.ns, "
            "puresound_tpu_torch.streaming.ns_engine, "
            "puresound_tpu_torch.streaming.file_eval, "
            "puresound_tpu_torch.nnet.dpcrn, puresound_tpu_torch.nnet.unet, "
            "puresound_tpu_torch.nnet.dual_path_streaming, "
            "puresound_tpu_torch.ops.lstm_scan_kernel, "
            "puresound_tpu_torch.ops.dual_path_kernel, "
            "puresound_tpu_torch.nnet.dparn, puresound_tpu_torch.nnet.lobe.attention, "
            "puresound_tpu_torch.ops.dparn_attention_kernel, "
            "puresound_tpu_torch.ops.masker_kernel, puresound_tpu_torch.ops.quant, "
            "puresound_tpu_torch.dsp.stft, puresound_tpu_torch.egs.ns.main, "
            "puresound_tpu_torch.egs.tse.local.binarize, puresound_tpu_torch.src.metrics, "
            "puresound_tpu_torch.src.pesq_native, puresound_tpu_torch.src.flac, "
            "puresound_tpu_torch.tasks.batch_eval, puresound_tpu_torch.tasks.base, "
            "puresound_tpu_torch.utils.flax_ckpt, puresound_tpu_torch.utils.from_jax, sys; "
            "assert not {'jax', 'flax', 'msgpack', 'puresound_tpu'} & set(sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("fused", [True, None])
def test_fused_server_refuses_a_chunk_that_does_not_divide_the_segment(fused):
    """The flagship (seg_size 150, hop 16 at 16 kHz) on the fused SkiM step:
    16 ms chunks (16 frames) raise at build time, naming the lengths that
    work; 15 ms builds. The unfused step keeps only the attach warning."""
    from puresound_tpu_torch.zoo import tse as zoo

    model = zoo.init_model("tse_skim_v0_causal", device="cpu")
    with pytest.raises(ValueError, match=r"16 frames.*seg_size 150.*\b15\b"):
        make_session_server(model, None, n_slots=2, chunk_ms=16.0, fused=fused)
    with pytest.warns(UserWarning, match="whole SkiM segments"):
        bundle = make_session_server(model, None, n_slots=2, chunk_ms=15.0, fused=fused)
    assert bundle.server is not None
    with pytest.warns(UserWarning, match="whole SkiM segments"):
        make_session_server(model, None, n_slots=2, chunk_ms=16.0, fused=False)

"""SessionServer's transports, as make_session_server builds them:

- `pipelined=True` gives every session bit for bit the output of the
  unpipelined server, one tick later, over attach, a paused session, an idle
  tick that drains the in-flight output, a detach with its output in flight
  and a re-attach of the same slot (the in-flight output never reaches the
  new occupant), and `flush()`; with and without `pcm16`;
- `pcm16=True` against the JAX server built the same way on the same model
  and audio: within one int16 step (1 / pcm16_scale) plus 1e-6, since the
  two float computations differ by ~1e-7 and truncation can then land one
  step apart;
- the host side of pcm16 as JAX's: clip(x * scale, +-32767) truncated toward
  zero on the way in, int16 * (1 / scale) on the way out;
- the server's step_fn passes keyword options on to the engine's step, so
  that binding int8_hh / int8_full / xscr_half serves that route.

The pinned-buffer copy behind a CUDA event runs only on the card
(chip_smoke.py phase 4f holds the pipelined server bit-equal there)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from puresound_tpu.nnet.base_nn import SoTaskWrapModule as JWrap
from puresound_tpu.nnet.conv_tasnet import TCN as JTCN
from puresound_tpu.nnet.dpcrn import DPCRN as JDPCRN
from puresound_tpu.nnet.encoder import ConvEncDec as JEncDec
from puresound_tpu.nnet.encoder import FreeEncDec as JEnc
from puresound_tpu.nnet.lobe.cnn import Conv1d as JConv
from puresound_tpu.nnet.lobe.pooling import AttentiveStatisticsPooling as JASP
from puresound_tpu.nnet.skim import SkiM as JSkiM
from puresound_tpu_torch.nnet.base_nn import SoTaskWrapModule
from puresound_tpu_torch.nnet.conv_tasnet import TCN
from puresound_tpu_torch.nnet.dpcrn import DPCRN
from puresound_tpu_torch.nnet.encoder import ConvEncDec, FreeEncDec
from puresound_tpu_torch.nnet.lobe.cnn import Conv1d
from puresound_tpu_torch.nnet.lobe.pooling import AttentiveStatisticsPooling
from puresound_tpu_torch.nnet.skim import SkiM
from puresound_tpu_torch.streaming.deploy import make_session_server
from puresound_tpu_torch.streaming.file_eval import engine_step_options
from puresound_tpu_torch.streaming.server import SessionServer
from puresound_tpu_torch.utils.from_jax import from_jax

# one intra-op thread a process: the suite's workers share the cores, and
# torch's thread pool on busy cores slows its small ops several times over
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
SCALE = 8192.0
C, E = 24, 8
TSE = dict(enc=dict(win_length=32, hop_length=16, laten_length=C, output_active=True),
           skim=dict(input_size=C, hidden_size=16, output_size=C, n_blocks=2, seg_size=10,
                     seg_overlap=False, causal=True, embed_dim=E, embed_norm=True,
                     embed_fusion="FiLM", block_with_embed=(1, 1)))
NS = dict(enc=dict(fft_length=128, win_length=128, hop_length=32, trainable=True,
                   output_format="Complex"),
          unet=dict(input_type="RI", input_dim=128, norm_type="bN2d", dropout=0.0,
                    channels=(1, 8, 8, 16, 16, 32), transpose_t_size=2,
                    transpose_delay=False, kernel_t=(2,) * 5, stride_t=(1,) * 5,
                    dilation_t=(1,) * 5, kernel_f=(5, 3, 3, 3, 3),
                    stride_f=(2, 2, 1, 1, 1), dilation_f=(1,) * 5, delay=(0,) * 5,
                    rnn_hidden=16),
          wrap=dict(drop_first_bin=True, mask_constraint="linear", f_type="Complex",
                    mask_type="Complex"))


@pytest.fixture
def ring_hub():
    """The C++ ring hub SessionServer runs on (csrc/, built on demand)."""
    from puresound_tpu_torch.src import native

    return native.load()


def _models(kind, rng):
    """(JAX wrapper, its float32 variables, the port wrapper with them)."""
    if kind == "tse":
        spk = (JTCN(C, 16, 3, dilation=1, causal=False, tcn_norm="gLN", dconv_norm="gGN"),
               JASP(C, 16), JConv(2 * C, E, 1, use_bias=False))
        jm = JWrap(encoder=JEnc(**TSE["enc"]), masker=JSkiM(**TSE["skim"]),
                   speaker_net=spk, mask_constraint="ReLU")
        v = jm.init(KEY, jnp.zeros((1, 320)), jnp.zeros((1, 800)), method=JWrap.inference)
        pm = SoTaskWrapModule(
            FreeEncDec(**TSE["enc"]), SkiM(**TSE["skim"]),
            [TCN(C, 16, 3, dilation=1, tcn_norm="gLN", dconv_norm="gGN"),
             AttentiveStatisticsPooling(C, 16), Conv1d(2 * C, E, 1, bias=False)],
            mask_constraint="ReLU")
    else:
        jm = JWrap(encoder=JEncDec(**NS["enc"]), masker=JDPCRN(**NS["unet"]), **NS["wrap"])
        v = jm.init(KEY, jnp.zeros((1, 256)), method=JWrap.inference)
        pm = SoTaskWrapModule(ConvEncDec(**NS["enc"]), DPCRN(**NS["unet"]), **NS["wrap"])
    v = jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float64) + 0.05 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jax.device_get(v))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    pm.load_state_dict(from_jax(v), strict=True)
    return jm, v, pm.eval()


def _server(pm, kind, **kw):
    route = dict(fused=True, enroll_len=400) if kind == "tse" else dict(dp_kernel=True)
    return make_session_server(pm, None, n_slots=3, chunk_ms=10.0, **route, **kw)


def _attach(server, kind, seed):
    if kind == "tse":
        return server.attach(dvec=np.random.default_rng(seed).standard_normal(E))
    return server.attach()


def _drive(bundle, kind, rng):
    """The same session script on one server: a, b attached; b pauses a tick;
    an idle tick; b detaches with its last output in flight and c takes its
    slot at once; flush. Returns {session: its popped output}."""
    server, chunk = bundle.server, bundle.chunk_samples
    audio = {k: (0.3 * rng.standard_normal(8 * chunk)).astype(np.float32) for k in "abc"}
    fed = dict.fromkeys("abc", 0)
    sids, got = {}, {k: [] for k in "abc"}

    def pop_all():
        for name, sid in sids.items():
            n = server.hub.output_available(sid)
            if n:
                got[name].append(server.hub.pop_output(sid, n))

    def tick(*names):
        for name in names:
            i = fed[name]
            server.hub.push_input(sids[name], audio[name][i * chunk:(i + 1) * chunk])
            fed[name] += 1
        served = server.tick()
        pop_all()
        return served

    sids["a"] = _attach(server, kind, 1)
    sids["b"] = _attach(server, kind, 2)
    tick("a", "b")
    tick("a", "b")
    tick("a")                                   # b pauses
    tick()                                      # idle: drains a pipelined output
    tick("a", "b")
    server.detach(sids.pop("b"))                # its last output may be in flight
    sids["c"] = _attach(server, kind, 3)        # the same slot, a new generation
    assert sids["c"] not in (sids["a"],)
    tick("a", "c")
    tick("a", "c")
    server.flush()
    pop_all()
    return {k: np.concatenate(v) if v else np.zeros(0, np.float32) for k, v in got.items()}


@pytest.mark.parametrize("pcm16", [False, True])
@pytest.mark.parametrize("kind", ["tse", "ns"])
def test_pipelined_server_bit_equal_to_unpipelined(rng, ring_hub, kind, pcm16):
    _, _, pm = _models(kind, rng)
    plain = _drive(_server(pm, kind, pcm16=pcm16), kind, np.random.default_rng(7))
    piped = _drive(_server(pm, kind, pcm16=pcm16, pipelined=True), kind,
                   np.random.default_rng(7))
    chunk = _server(pm, kind).chunk_samples
    assert len(plain["a"]) == 6 * chunk and len(plain["c"]) == 2 * chunk
    np.testing.assert_array_equal(piped["a"], plain["a"])
    np.testing.assert_array_equal(piped["c"], plain["c"])
    # b's last chunk was in flight at its detach and went to nobody: not to c
    assert len(piped["b"]) == len(plain["b"]) - chunk
    np.testing.assert_array_equal(piped["b"], plain["b"][:len(piped["b"])])


@pytest.mark.parametrize("kind", ["tse", "ns"])
def test_pcm16_server_matches_jax_server(rng, ring_hub, kind):
    from puresound_tpu.streaming.deploy import make_session_server as j_make

    jm, v, pm = _models(kind, rng)
    common = dict(n_slots=2, chunk_ms=10.0, lockstep=True, pcm16=True, pcm16_scale=SCALE)
    if kind == "tse":
        common["enroll_len"] = 400
    jb = j_make(jm, v, **common)
    pb = make_session_server(pm, None, fused=False, **common)
    assert jb.chunk_samples == pb.chunk_samples
    chunk = pb.chunk_samples
    audio = (0.3 * rng.standard_normal((2, 5 * chunk))).astype(np.float32)
    audio[0, :20] = 5.0                                     # clipped at +-32767
    outs = []
    for bundle in (jb, pb):
        server = bundle.server
        if kind == "tse":
            enroll = (0.3 * np.random.default_rng(3).standard_normal((2, 400))
                      ).astype(np.float32)
            sids = [server.attach(enroll=e) for e in enroll]
        else:
            sids = [server.attach() for _ in range(2)]
        got = np.zeros_like(audio)
        for k in range(5):
            for i, sid in enumerate(sids):
                server.hub.push_input(sid, audio[i, k * chunk:(k + 1) * chunk])
            assert server.tick() == 2
            for i, sid in enumerate(sids):
                got[i, k * chunk:(k + 1) * chunk] = server.hub.pop_output(sid, chunk)
        outs.append(got)
    want, got = outs
    assert np.abs(want).max() > 100 / SCALE                 # not a silent run
    np.testing.assert_allclose(got, want, atol=1.0 / SCALE + 1e-6, rtol=0)


def test_pcm16_host_conversion_is_jax_s(ring_hub):
    """An echoing step: what crosses is clip(x * scale, +-32767) truncated
    toward zero (numpy's astype, as JAX's server), and it comes back as
    int16 * (1 / scale)."""
    seen = []

    def step_fn(batch, state):
        seen.append(batch)
        return torch.from_numpy(batch.copy()), state

    server = SessionServer(step_fn, {}, 1, 8, None, {}, pcm16=True, pcm16_scale=SCALE)
    server.attach()
    x = np.array([0.49 / SCALE, -0.99 / SCALE, 1.5 / SCALE, -2.7 / SCALE, 4.5, -4.5,
                  0.1, -0.3], np.float32)
    server.hub.push_input(0, x)
    assert server.tick() == 1
    want = np.clip(x * SCALE, -32767.0, 32767.0).astype(np.int16)
    assert seen[0].dtype == np.int16
    np.testing.assert_array_equal(seen[0][0], want)
    np.testing.assert_array_equal(want[:6], [0, 0, 1, -2, 32767, -32767])
    np.testing.assert_array_equal(server.hub.pop_output(0, 8),
                                  want.astype(np.float32) * (1.0 / SCALE))


@pytest.mark.parametrize("kind,option", [("tse", "int8_hh"), ("tse", "int8_full"),
                                         ("ns", "int8_hh"), ("ns", "xscr_half")])
def test_step_fn_passes_engine_options(rng, ring_hub, kind, option):
    """make_session_server's step_fn bound to an option with
    functools.partial serves the engine's step with that option: slot 0's
    output equals the engine's own step on the same [n_slots, chunk] batch
    bit for bit, and differs from the float route's."""
    _, _, pm = _models(kind, rng)
    bundle = _server(pm, kind, lockstep=True)
    server, engine, chunk = bundle.server, bundle.engine, bundle.chunk_samples
    server.step_fn = functools.partial(server.step_fn, **{option: True})
    sid = _attach(server, kind, 1)
    audio = (0.3 * rng.standard_normal(2 * chunk)).astype(np.float32)
    got = []
    for k in range(2):
        server.hub.push_input(sid, audio[k * chunk:(k + 1) * chunk])
        assert server.tick() == 1
        got.append(server.hub.pop_output(sid, chunk))
    got = np.concatenate(got)

    if kind == "tse":
        step_kw, init_kw = dict(fused=True, dot_dtype=torch.float32), {}
        dvec = torch.zeros(3, E)
        dvec[0] = torch.from_numpy(np.random.default_rng(1).standard_normal(E).astype(
            np.float32))
        args = (dvec,)
    else:
        step_kw, init_kw = engine_step_options(engine, dp_kernel=True)
        args = ()
    outs = {}
    for label, opts in (("option", {option: True}), ("float", {})):
        state = engine.init_state(3, torch.float32, **init_kw)
        ys = []
        with torch.no_grad():
            for k in range(2):
                x = torch.zeros(3, chunk)
                x[0] = torch.from_numpy(audio[k * chunk:(k + 1) * chunk])
                y, state = engine.step(x, *args, state, **step_kw, **opts)
                ys.append(y[0].float().numpy())
        outs[label] = np.concatenate(ys)
    np.testing.assert_array_equal(got, outs["option"])
    assert not np.array_equal(got, outs["float"])

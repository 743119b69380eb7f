"""The port's TSE demos (`puresound_tpu_torch/egs/tse/demo/`) on the CPU:

- `DemoSpeakerNet` / `DemoTseNet` against JAX's `egs/tse/demo/utils.py`
  (imported by its path, unchanged) on a small engine in float64, atol
  1e-8 / rtol 1e-6, chunk by chunk; `overlap_add` equal to JAX's;
- `demo_app.main --device cpu` on temporary wavs (real-time cadence off,
  a small engine in place of the flagship): its output equals
  `StreamingTSE` stepped over the same chunks, and the written wav is that
  output as int16; `load_or_init` reads a port checkpoint and a JAX one;
- `live_demo` with 2 simulated mics, cadence off, through the C++ ring hub
  and `StreamingServer`: every sink equals the engine stepped on the same
  [2, chunk] batches, bit for bit;
- `mic_demo.check_environment` reports what JAX's reports (here at least
  `sounddevice`), and its main falls back with exit code 2.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from puresound_tpu_torch.egs.tse.demo import demo_app, live_demo, mic_demo
from puresound_tpu_torch.egs.tse.demo.utils import DemoSpeakerNet, DemoTseNet, overlap_add
from puresound_tpu_torch.streaming.engine import StreamingTSE
from puresound_tpu_torch.utils.from_jax import from_jax
from test_torch_tse_slice import HOP, _jax_parts, _port_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-8, 1e-6
SR = 16000


def _jax_demo(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_demo_{name}", os.path.join(ROOT, "egs", "tse", "demo", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def engines(rng):
    """(JAX engine, its f64 variables, the port's engine on them)."""
    from puresound_tpu.streaming.engine import StreamingTSE as JEngine

    enc, masker, spk = _jax_parts()
    jeng = JEngine(encoder=enc, masker=masker, speaker_net=spk, mask_constraint="ReLU")
    v = jeng.init(jax.random.PRNGKey(0), jnp.zeros((1, 160)), jnp.zeros((1, 800)),
                  method=JEngine.init_all)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64)
                               + 0.05 * rng.standard_normal(np.shape(a)), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v.get("batch_stats", {}))
    model = _port_model()
    model.load_state_dict(from_jax(v), strict=True)
    return jeng, v, StreamingTSE.from_offline(model).eval()


def test_demo_nets_match_jax(engines, rng):
    jeng, v, engine = engines
    jutils = _jax_demo("utils")
    enroll = rng.standard_normal(800) * 0.3
    x = rng.standard_normal(6 * 5 * HOP) * 0.3
    with jax.enable_x64(True):
        jd = jutils.DemoSpeakerNet(jeng, v).get_speaker_embedding(enroll)
        jtse = jutils.DemoTseNet(jeng, v)
        # its state in float64, as the port's DemoTseNet takes the engine's
        jtse.state = jeng.apply(v, 1, jnp.float64, method=type(jeng).init_state)
        want = [np.asarray(jtse.streaming_inference_chunk(c, jd))
                for c in x.reshape(6, -1)]
    d = DemoSpeakerNet(engine).get_speaker_embedding(enroll)
    np.testing.assert_allclose(d, jd, atol=ATOL, rtol=RTOL)
    tse = DemoTseNet(engine)
    got = [tse.streaming_inference_chunk(c, d) for c in x.reshape(6, -1)]
    for g, w in zip(got, want):
        assert g.shape == (1, 5 * HOP)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    tse.reset()
    np.testing.assert_array_equal(tse.streaming_inference_chunk(x[:5 * HOP], d), got[0])
    frames = [rng.standard_normal(8) for _ in range(5)]
    np.testing.assert_array_equal(overlap_add(frames, 3), jutils.overlap_add(frames, 3))


def _write(path, sig):
    wavfile.write(path, SR, np.clip(sig * 32768, -32768, 32767).astype(np.int16))
    return path


def _small_engine(device=None, generator=None):
    return StreamingTSE.from_offline(_port_model(torch.float32)).to(device).eval()


def test_demo_app_main_streams_the_file(tmp_path, rng, monkeypatch, capsys):
    monkeypatch.setattr(demo_app, "build_flagship_engine", _small_engine)
    enroll = _write(str(tmp_path / "e.wav"), 0.3 * rng.standard_normal(SR // 2))
    noisy = _write(str(tmp_path / "n.wav"), 0.3 * rng.standard_normal(SR // 2))
    out = str(tmp_path / "o.wav")
    res = demo_app.main(demo_app.parse_args(
        ["--enroll", enroll, "--input", noisy, "--output", out, "--device", "cpu",
         "--no-realtime"]))
    text = capsys.readouterr().out
    assert "random weights" in text and "real-time factor" in text
    chunk = res["chunk"]
    assert chunk == 320 and len(res["latency_ms"]) == SR // 2 // chunk
    engine = _small_engine()
    x = torch.from_numpy(demo_app.read_mono(noisy)[0])
    with torch.no_grad():
        dvec = engine.embed(torch.from_numpy(demo_app.read_mono(enroll, target_lvl=-28)))
        st, outs = engine.init_state(1), []
        for i in range(len(x) // chunk):
            y, st = engine.step(x[None, i * chunk:(i + 1) * chunk], dvec, st)
            outs.append(y[0])
    want = torch.cat(outs).numpy()
    np.testing.assert_array_equal(res["enhanced"], want)
    sr, written = wavfile.read(out)
    assert sr == SR
    np.testing.assert_array_equal(
        written, np.clip(want * 32768, -32768, 32767).astype(np.int16))


def test_load_or_init_reads_port_and_jax_checkpoints(engines, tmp_path):
    """A port checkpoint and one JAX's `save_ckpt` writes (read without
    flax) load into the engine load_or_init builds."""
    from test_torch_eval_ckpt import _jax_save

    _, v, engine = engines
    build = lambda device=None, generator=None: StreamingTSE.from_offline(
        _port_model()).to(device).eval()
    ppath = str(tmp_path / "port.ckpt")
    torch.save({"params": dict(engine.state_dict()), "batch_stats": {}}, ppath)
    jpath = tmp_path / "jax.ckpt"
    _jax_save(jpath, v)
    for path in (ppath, str(jpath)):
        got = demo_app.load_or_init(build, path, "cpu")
        for k, t in engine.state_dict().items():
            np.testing.assert_array_equal(got.state_dict()[k].numpy(), t.numpy(), err_msg=k)


def test_live_demo_sinks_equal_the_engine(tmp_path, rng, monkeypatch):
    monkeypatch.setattr(live_demo, "build_flagship_engine", _small_engine)
    enroll = _write(str(tmp_path / "e.wav"), 0.3 * rng.standard_normal(SR // 4))
    noisy = _write(str(tmp_path / "n.wav"), 0.3 * rng.standard_normal(SR // 2))
    res = live_demo.run(live_demo.parse_args(
        ["--enroll", enroll, "--input", noisy, "--n-mics", "2", "--seconds", "0.5",
         "--device", "cpu", "--no-realtime", "--out-dir", str(tmp_path / "out")]))
    assert res["ok"] and res["ticks"] == len(res["wav"]) // res["chunk"] + (
        len(res["wav"]) % res["chunk"] > 0)
    engine, chunk, wav = res["engine"], res["chunk"], res["wav"]
    n = len(wav) // chunk
    with torch.no_grad():
        st, outs = engine.init_state(2), []
        for i in range(n):
            x = torch.from_numpy(np.repeat(wav[None, i * chunk:(i + 1) * chunk], 2, 0))
            y, st = engine.step(x, res["dvec"], st)
            outs.append(y)
    want = torch.cat(outs, 1).numpy()
    for i, audio in enumerate(res["sinks"]):
        np.testing.assert_array_equal(audio[:n * chunk], want[i])
    assert sorted(os.listdir(tmp_path / "out")) == ["enhanced_0.wav", "enhanced_1.wav"]
    assert all(p["complete"] for p in res["per_stream"])


def test_mic_demo_reports_what_jax_reports(capsys):
    jmic = _jax_demo("mic_demo")
    for ui in (True, False):
        assert mic_demo.check_environment(need_ui=ui) == jmic.check_environment(need_ui=ui)
    ok, missing = mic_demo.check_environment()
    if ok:
        pytest.skip("this host has a microphone, a UI and a display")
    assert mic_demo.main(["--device", "cpu"]) == 2
    text = capsys.readouterr().out
    assert "missing" in text and "demo_app" in text and "live_demo" in text
    try:
        import sounddevice  # noqa: F401
    except Exception:
        assert "the `sounddevice` package" in missing
